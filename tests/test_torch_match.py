"""The port's q-gram screen (``ops/match.py``) against the JAX package's:
name tables, the CSR view the kernel reads, and the plain screen over
ragged rows against the reference's ``match_screen`` on padded ones —
truncated and gram-less names, short titles, empty rows and rows shorter
than q, non-ASCII text, and a threshold sweep where the float32 bounds
land on whole numbers.  Every comparison is exact.  Then the kernel's
layout of the names (sorted by gram count, a warp's names interleaved)
and a model of the kernel's walk over it (rows a block in one row-sliced
bitmap, SWAR counters), held to the plain screen.  Last, the kernel
wrapper's checks."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import myers_probe
from advanced_scrapper_tpu.core.tokenizer import encode_batch
from advanced_scrapper_tpu.ops import match as ref
from advanced_scrapper_tpu_torch.core.hashing import gram_hashes_np
from advanced_scrapper_tpu_torch.ops import match, match_cuda, sass


def name_set(rng: np.random.RandomState) -> tuple[list[bytes], np.ndarray]:
    """Names of 0-40 random letters, ALL-CAPS symbols, names over 98 bytes
    (truncated at 96 grams), 2-byte names (no gram), repeated grams and a
    non-ASCII name; every third name exact, the rest fuzzy."""
    names = [bytes(rng.randint(97, 123, size=rng.randint(0, 41), dtype=np.uint8))
             for _ in range(60)]
    names += [b"AAPL", b"IBM", b"x" * 120, bytes(rng.randint(97, 123, 150, dtype=np.uint8)),
              b"ab", b"", b"aaaaaa", "Société Générale".encode(), b"Tim Cook",
              b"International Business Machines Corporation"]
    fuzzy = np.array([i % 3 != 1 for i in range(len(names))])
    return names, fuzzy


def rows_set(rng: np.random.RandomState, names: list[bytes], n: int = 90):
    """``(rows, text_len, title_len)``: combined ``title\\ntext`` rows of
    0-2,000 bytes with names planted whole and cut, titles of 0-30 bytes
    (shorter than many names), a few non-ASCII texts."""
    rows, tl, ttl = [], [], []
    for i in range(n):
        title = bytes(rng.randint(97, 123, size=rng.randint(0, 31), dtype=np.uint8))
        if i % 6 == 0:
            title = names[rng.randint(len(names))][: rng.randint(0, 20)]
        body_len = int(rng.choice([0, 1, 2, 3, 40, 300, 2000]))
        body = bytearray(rng.randint(97, 123, size=body_len, dtype=np.uint8))
        if body_len >= 40 and i % 2:
            nm = names[rng.randint(len(names))]
            nm = nm if i % 4 == 1 else nm[1:]
            body[5 : 5 + len(nm)] = nm
        if i % 11 == 3:
            body += "naïve café".encode()
        raw = title + b"\n" + bytes(body)
        if i % 17 == 0:
            raw, title, body = raw[: i % 3], b"", b""  # rows shorter than q
        rows.append(raw)
        tl.append(max(len(raw) - len(title) - 1, 0))
        ttl.append(len(title))
    return rows, np.array(tl, np.int32), np.array(ttl, np.int32)


def ragged(rows: list[bytes]):
    """``(text, row_off, row_len)`` tensors of ``rows`` joined."""
    lens = np.array([len(r) for r in rows], np.int64)
    off = np.zeros(len(rows), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    text = torch.from_numpy(np.frombuffer(b"".join(rows) or b"\0", np.uint8).copy())
    return text[: int(lens.sum())], torch.from_numpy(off), torch.from_numpy(lens.astype(np.int32))


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(7)
    names, fuzzy = name_set(rng)
    rows, tl, ttl = rows_set(rng, names)
    return names, fuzzy, rows, tl, ttl


def test_prepare_names_equals_reference(case):
    names, fuzzy, *_ = case
    want = ref.prepare_names(names, fuzzy=fuzzy)
    got = match.prepare_names(names, fuzzy=fuzzy)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert (got["kept"] < got["total"]).sum() == 2  # the two truncated names
    assert (got["kept"] == 0).sum() >= 2            # the empty and 2-byte names
    assert (match.NBITS, match.DEFAULT_Q, match.MAX_GRAMS) == (ref.NBITS, ref.DEFAULT_Q,
                                                              ref.MAX_GRAMS)
    assert (match.FLAG_REFINE_OK, match.MASK_SCREEN_KEEP, match.MASK_TEXT_PRUNED) == (
        ref.FLAG_REFINE_OK, ref.MASK_SCREEN_KEEP, ref.MASK_TEXT_PRUNED)


def test_names_csr_round_trips(case):
    names, fuzzy, *_ = case
    tables = match.prepare_names(names, fuzzy=fuzzy)
    off, grams = match.names_csr(tables)
    assert off.dtype == np.int32 and grams.dtype == np.int16
    assert off[0] == 0 and off[-1] == grams.size == tables["kept"].sum()
    back = np.full_like(tables["grams"], -1)
    for i in range(len(names)):
        back[i, : off[i + 1] - off[i]] = grams[off[i] : off[i + 1]]
    assert np.array_equal(back, tables["grams"])
    t = match.screen_tensors(tables, "cpu")
    assert {k: t[k].dtype for k in match_cuda.TABLES} == match_cuda.TABLES
    assert (t["gram_off"].dtype, t["grams"].dtype) == (torch.int32, torch.int16)
    assert set(t) == {*match_cuda.TABLES, "gram_off", "grams"}
    assert match_cuda.check_tables(t, torch.device("cpu")) == len(names)


@pytest.mark.parametrize("threshold", [95.0, 90.0, 80.0, 97.5, 50.0, 9.0, 33.3, 75.0, 100.0])
def test_screen_plain_equals_reference(case, threshold):
    """The ragged plain screen equals the reference's jnp screen on padded
    rows at each threshold — 9, 33.3, 75 and 100 among those where the
    reference's float32 ``frac`` differs from IEEE division order."""
    names, fuzzy, rows, tl, ttl = case
    tables = match.prepare_names(names, fuzzy=fuzzy)
    tok, dl = encode_batch(rows, block_len=4096)
    want = ref.match_screen(tok, tl, ttl, dl, ref.prepare_names(names, fuzzy=fuzzy),
                            threshold=threshold)
    text, off, ln = ragged(rows)
    got = match.screen_plain(text, off, ln, torch.from_numpy(tl), torch.from_numpy(ttl),
                             match.screen_tensors(tables, "cpu"), threshold)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    mask = match.match_screen(text, off, ln, torch.from_numpy(tl), torch.from_numpy(ttl),
                              match.screen_tensors(tables, "cpu"), threshold=threshold)
    assert mask.dtype == torch.uint8 and np.array_equal(mask.numpy(), want.astype(np.uint8))


def test_screen_frac_against_float32_arithmetic():
    """``frac`` is ``2·fma(−t, 0.01f, 1)``: at t = 95 one ulp above IEEE
    division order, and exactly 0 at t = 100."""
    assert match.screen_frac(95.0) == np.float32(0.1000000387430191)
    assert match.screen_frac(100.0) == np.float32(4.470348358154297e-08)
    assert match.screen_frac(0.0) == np.float32(2.0)
    assert match.screen_frac(97.5).dtype == np.float32


def test_screen_plain_rows_without_grams():
    """Rows shorter than q and empty rows have no gram: only names with no
    kept gram can survive, by their length bounds."""
    names, fuzzy = [b"ab", b"abc", b"AB"], np.array([True, True, False])
    tables = match.screen_tensors(match.prepare_names(names, fuzzy=fuzzy), "cpu")
    text, off, ln = ragged([b"", b"a", b"ab", b"abc"])
    tl = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    got = match.screen_plain(text, off, ln, tl, torch.zeros(4, dtype=torch.int32), tables, 95.0)
    tok, dl = encode_batch([b"", b"a", b"ab", b"abc"], block_len=1024)
    want = ref.match_screen(tok, tl.numpy(), np.zeros(4, np.int32), dl,
                            ref.prepare_names(names, fuzzy=fuzzy))
    assert np.array_equal(got.numpy(), want)


def edge_names(rng: np.random.RandomState) -> tuple[list[bytes], np.ndarray]:
    """:func:`name_set` with names of exactly 0, 1 and 96 kept grams and
    repeated grams beside it (96 of one gram, a gram twice)."""
    names, fuzzy = name_set(rng)
    extra = [b"abc", b"XYZ", bytes(rng.randint(97, 123, 98, dtype=np.uint8)), b"z" * 98,
             b"abcabc", b"Q", b"ABCDEF" * 20]
    return names + extra, np.r_[fuzzy, [True, False, True, True, True, False, False]]


def layout_of(tables: dict, tile_cols: int) -> dict:
    off, grams = match.names_csr(tables)
    return match.screen_layout(off, grams, tile_cols)


@pytest.mark.parametrize("tile_cols", [match.SCREEN_TILE_COLS, 32, 17, 1])
def test_screen_layout_round_trips(tile_cols):
    """Every column once; sorted by gram count (most first) within its
    tile; each name's grams read back in order from the interleaved
    table, the padding slots holding PAD_GRAM."""
    names, fuzzy = edge_names(np.random.RandomState(3))
    tables = match.prepare_names(names, fuzzy=fuzzy)
    off, grams = match.names_csr(tables)
    lay = match.screen_layout(off, grams, tile_cols)
    kept = np.diff(off)
    slot_col, group_off, tile_groups = lay["slot_col"], lay["group_off"], lay["tile_groups"]
    il = lay["grams_il"].view(np.uint16)
    assert sorted(slot_col[slot_col >= 0]) == list(range(len(names)))
    assert len(tile_groups) == -(-len(names) // tile_cols) + 1
    for t in range(len(tile_groups) - 1):
        cols = slot_col[tile_groups[t] * match.GROUP:tile_groups[t + 1] * match.GROUP]
        live = cols[cols >= 0]
        assert set(live) == set(range(t * tile_cols, min((t + 1) * tile_cols, len(names))))
        assert (np.diff(kept[live]) <= 0).all()
        assert (cols[len(live):] == -1).all() and len(cols) - len(live) < match.GROUP
    back = {}
    for g in range(len(group_off) - 1):
        steps = il[group_off[g] * 32:group_off[g + 1] * 32].reshape(-1, 32)
        cols = slot_col[g * 32:(g + 1) * 32]
        assert len(steps) == max(kept[c] if c >= 0 else 0 for c in cols)
        for lane, c in enumerate(cols):
            n = kept[c] if c >= 0 else 0
            assert (steps[n:, lane] == match.PAD_GRAM).all()
            if c >= 0:
                back[c] = steps[:n, lane]
    for c in range(len(names)):
        assert np.array_equal(back[c], grams[off[c]:off[c + 1]].view(np.uint16))


def screen_model(rows, text_len, title_len, tables, lay, tile_cols, frac, R, base=5):
    """The kernel's walk (``csrc/match.cu``) in numpy: ``R`` rows a block
    in one bitmap whose entry ``b`` has bit ``r`` for row ``r`` of the
    block (entry PAD_GRAM never set), built chunk by chunk over each row's
    16-byte-aligned chunks of a text at address ``base`` (every window
    once, the bytes past a chunk read only inside the row); each group of 32 names' grams probed
    step by step into nibble counters (``n_k += (v >> k) & 0x11111111``,
    row ``4i + k`` in nibble ``i``), folded every 15 steps into byte
    counters (even nibbles ``lo``, odd ``hi``); the bounds as one
    requirement per (row, name) from the counters unpacked, or, where every
    part of the block's rows is at least the name's ``m`` bytes, as one
    requirement compared with the byte counters in SWAR; the keep masks of
    a tile staged by column and written in the index's column order.
    Returns the mask and how many (block, name) pairs took each path."""
    n_names = len(tables["kept"])
    kept, total, m = (np.asarray(tables[k], np.int64) for k in ("kept", "total", "name_len"))
    paths = {"swar": 0, "rows": 0}
    starts = np.r_[0, np.cumsum([len(r) for r in rows])]
    out = np.zeros((len(rows), n_names), np.uint8)
    il = lay["grams_il"].view(np.uint16)
    nib, lo_mask = np.uint32(0x11111111), np.uint32(0x0F0F0F0F)
    f32 = np.float32(frac)

    def short(D):
        return (D - 2) - 3 * int(np.floor(np.float32(D) * f32))

    for b0 in range(0, len(rows), R):
        block = rows[b0:b0 + R]
        bitmap = np.zeros(match.NBITS + 16, np.uint32)
        for r, raw in enumerate(block):
            hashes = gram_hashes_np(raw, 3) % match.NBITS
            nw = max(len(raw) - 2, 0)
            lead = (base + starts[b0 + r]) % 16
            seen = []
            for q in range((lead + nw + 15) // 16 if nw else 0):
                rel = 16 * q - lead
                assert rel + 14 >= nw or rel + 16 < len(raw)  # the bytes past the chunk
                for j in range(16):
                    if 0 <= rel + j < nw:
                        seen.append(rel + j)
                        bitmap[hashes[rel + j]] |= np.uint32(1 << r)
            assert seen == list(range(nw))
        tl = np.r_[text_len[b0:b0 + R], np.zeros(R - len(block), np.int64)]
        ttl = np.r_[title_len[b0:b0 + R], np.zeros(R - len(block), np.int64)]
        min_part = int(np.minimum(tl, ttl)[:len(block)].min())
        for t in range(len(lay["tile_groups"]) - 1):
            keep = {}
            for g in range(lay["tile_groups"][t], lay["tile_groups"][t + 1]):
                cols = lay["slot_col"][g * 32:(g + 1) * 32]
                j0, j1 = lay["group_off"][g], lay["group_off"][g + 1]
                lo = np.zeros((4, 32), np.uint32)
                hi = np.zeros((4, 32), np.uint32)
                for a in range(0, j1 - j0, 15):
                    n = np.zeros((4, 32), np.uint32)
                    for j in range(j0 + a, min(j0 + a + 15, j1)):
                        v = bitmap[il[j * 32:(j + 1) * 32]]
                        for k in range(4):
                            n[k] += (v >> np.uint32(k)) & nib
                    assert (((n[:, :, None] >> np.arange(0, 32, 4, dtype=np.uint32)) & 15)
                            <= 15).all()
                    lo += n & lo_mask
                    hi += (n >> np.uint32(4)) & lo_mask
                for lane, c in enumerate(cols):
                    if c < 0:
                        continue
                    if tables["fuzzy"][c]:
                        lng = kept[c] - 3 * int(np.floor(np.float32(m[c]) * f32))
                        mul, add = (0 if kept[c] < total[c] else 1), 0
                    else:
                        lng, mul, add = kept[c], 0, 1 << 20
                    mask = 0
                    if m[c] <= min_part:  # one requirement: SWAR compares
                        need = np.uint32(min(max(lng, 0), 128) * 0x01010101)
                        top = np.uint32(0x80808080)
                        for k in range(4):
                            mask |= int(((lo[k, lane] | top) - need) & top) >> (7 - k)
                            mask |= int(((hi[k, lane] | top) - need) & top) >> (3 - k)
                        mask &= (1 << R) - 1
                        paths["swar"] += 1
                    else:
                        for r in range(R):
                            bt = lng if tl[r] >= m[c] else short(int(tl[r])) * mul + add
                            btt = lng if ttl[r] >= m[c] else short(int(ttl[r])) * mul + add
                            cnt = int(((hi if (r >> 2) & 1 else lo)[r & 3, lane]
                                       >> (8 * (r >> 3))) & 0xFF)
                            mask |= int(cnt >= min(bt, btt)) << r
                        paths["rows"] += 1
                    keep[c] = mask
            for c, mask in keep.items():
                for r in range(len(block)):
                    out[b0 + r, c] = (mask >> r) & 1
    return out, paths


def long_rows(rng: np.random.RandomState, names: list[bytes], n: int = 90):
    """Rows whose titles (24-60 bytes) and texts (100-2,000 bytes) are
    longer than most names, names planted whole and with an edit: most
    (block, name) pairs take the kernel's SWAR bounds."""
    rows, tl, ttl = [], [], []
    for i in range(n):
        title = bytes(rng.randint(97, 123, size=rng.randint(24, 61), dtype=np.uint8))
        body = bytearray(rng.randint(97, 123, size=int(rng.choice([100, 700, 2000])),
                                     dtype=np.uint8))
        for _ in range(rng.randint(0, 4)):
            nm = names[rng.randint(len(names))][: len(body) - 1]
            nm = nm if i % 3 else nm[:-1] + b"q"
            at = rng.randint(0, len(body) - len(nm))
            body[at:at + len(nm)] = nm
        rows.append(title + b"\n" + bytes(body))
        tl.append(len(body))
        ttl.append(len(title))
    return rows, np.array(tl, np.int32), np.array(ttl, np.int32)


@pytest.mark.parametrize("R,tile_cols,threshold,long", [
    (32, match.SCREEN_TILE_COLS, 95.0, False), (32, 33, 80.0, False), (16, 20, 90.0, False),
    (8, 64, 97.5, False), (32, 17, 50.0, False), (8, match.SCREEN_TILE_COLS, 9.0, False),
    (32, match.SCREEN_TILE_COLS, 95.0, True), (16, 40, 90.0, True), (8, 17, 50.0, True)])
def test_kernel_walk_equals_the_plain_screen(R, tile_cols, threshold, long):
    """The model of the kernel's walk gives ``screen_plain``'s mask at
    ``R`` rows a block (90 rows: the last block short), over several
    tiles, on names with 0, 1 and 96 kept grams and repeats; on rows with
    short parts (the bounds a row at a time) and long ones (mostly SWAR)."""
    rng = np.random.RandomState(11)
    names, fuzzy = edge_names(rng)
    rows, tl, ttl = (long_rows if long else rows_set)(rng, names)
    tables = match.prepare_names(names, fuzzy=fuzzy)
    lay = layout_of(tables, tile_cols)
    text, off, ln = ragged(rows)
    want = match.screen_plain(text, off, ln, torch.from_numpy(tl), torch.from_numpy(ttl),
                              match.screen_tensors(tables, "cpu"), threshold)
    got, paths = screen_model(rows, tl, ttl, tables, lay, tile_cols,
                              match.screen_frac(threshold), R)
    assert np.array_equal(got, want.numpy().astype(np.uint8))
    assert 0 < want.sum() < want.numel()
    assert paths["rows"] > 0 and (paths["swar"] > paths["rows"]) == long, paths


@pytest.mark.parametrize("n_names", [0, 1, 31, 33])
def test_kernel_walk_on_few_names(n_names):
    """N = 0, 1 and N beside a multiple of 32."""
    rng = np.random.RandomState(12)
    names, fuzzy = edge_names(rng)
    names, fuzzy = names[-n_names:] if n_names else [], fuzzy[-n_names:] if n_names else fuzzy[:0]
    rows, tl, ttl = rows_set(rng, edge_names(rng)[0], n=40)
    tables = match.prepare_names(names, fuzzy=fuzzy)
    lay = layout_of(tables, match.SCREEN_TILE_COLS)
    assert lay["slot_col"].size == -(-n_names // 32) * 32
    text, off, ln = ragged(rows)
    want = match.screen_plain(text, off, ln, torch.from_numpy(tl), torch.from_numpy(ttl),
                              match.screen_tensors(tables, "cpu"), 95.0)
    got, _paths = screen_model(rows, tl, ttl, tables, lay, match.SCREEN_TILE_COLS,
                               match.screen_frac(95.0), 32)
    assert np.array_equal(got, want.numpy().astype(np.uint8))


def test_screen_layout_refuses_more_grams_than_the_kernel_counts():
    tables = match.prepare_names([bytes(range(65, 91)) * 12], max_grams=300)
    with pytest.raises(ValueError, match="counts up to"):
        layout_of(tables, match.SCREEN_TILE_COLS)


def test_checks_and_the_kernel_wrapper_refuse_bad_input(case):
    names, fuzzy, rows, tl, ttl = case
    tables = match.screen_tensors(match.prepare_names(names, fuzzy=fuzzy), "cpu")
    text, off, ln = ragged(rows)
    tl_t, ttl_t = torch.from_numpy(tl), torch.from_numpy(ttl)
    with pytest.raises(TypeError):
        match.screen_plain(text.to(torch.int32), off, ln, tl_t, ttl_t, tables, 95.0)
    with pytest.raises(TypeError):
        match.screen_plain(text, off.to(torch.int32), ln, tl_t, ttl_t, tables, 95.0)
    with pytest.raises(TypeError):
        match.screen_plain(text, off, ln.to(torch.int64), tl_t, ttl_t, tables, 95.0)
    with pytest.raises(TypeError):
        match_cuda.check_tables({**tables, "grams_il": tables["grams_il"].to(torch.int32)},
                                torch.device("cpu"))
    with pytest.raises(ValueError, match="layout"):
        match_cuda.check_tables({**tables, "group_off": tables["group_off"][:-1]},
                                torch.device("cpu"))
    with pytest.raises(ValueError, match="layout"):
        match_cuda.check_tables({**tables, "slot_col": tables["slot_col"][:-32]},
                                torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        match_cuda.match_screen(text, off, ln, tl_t, ttl_t, tables, match.screen_frac(95.0))
    assert match_cuda.match_screen.launches == 0


def test_a_cuda_device_without_a_card_raises(case):
    from advanced_scrapper_tpu_torch import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises((RuntimeError, AssertionError)):
        match.screen_tensors(match.prepare_names([b"abc"]), "cuda")


PROBE_SASS = """
        Function : _ZN12_GLOBAL__N_113screen_kernelEPKhPKlPKiS5_S5_xS5_S5_PKtS5_iS5_S5_S5_S1_ifPh
.L_x_4:
        /*0100*/                   LDG.E.U16.CONSTANT R2, desc[UR4][R8.64] ;
        /*0110*/                   LDS R3, [R2.X4] ;
        /*0120*/                   LOP3.LUT R4, R3, 0x11111111, RZ, 0xc0, !PT ;
        /*0130*/                   SHF.R.U32.HI R5, RZ, 0x1, R3 ;
        /*0140*/                   LOP3.LUT R5, R5, 0x11111111, RZ, 0xc0, !PT ;
        /*0150*/                   IADD3 R10, R10, R4, RZ ;
        /*0160*/                   IADD3 R11, R11, R5, RZ ;
        /*0170*/                   ISETP.GE.AND P0, PT, R6, R7, PT ;
        /*0180*/              @!P0 BRA `(.L_x_4) ;
.L_x_5:
        /*0190*/                   LDS.128 R12, [R9] ;
        /*01a0*/                   BRA 0x190 ;
"""


def test_sass_reads_the_screen_probe_loop():
    """The SASS reader finds the screen's probe loop (a bitmap load from
    shared memory and a gram load from global memory a probe) and counts
    its instructions per probe, by opcode and by pipe."""
    got = sass.step_loop(sass.parse_sass(PROBE_SASS), step="LDS", global_loads=True)
    assert got["steps_in_loop"] == 1 and got["per_step"] == 9
    assert got["by_pipe_per_step"] == {"alu": 5.0, "mio": 2.0, "other": 2.0}
    with pytest.raises(RuntimeError, match="no step loop"):
        sass.step_loop(sass.parse_sass(PROBE_SASS))


WRITE_SASS = """
.L_x_9:
        /*0200*/                   SHF.R.U32.HI R5, RZ, R4, R3 ;
        /*0210*/                   LOP3.LUT R5, R5, 0x1, RZ, 0xc0, !PT ;
        /*0220*/                   STG.E.U8 desc[UR10][R8.64], R5 ;
        /*0230*/                   IMAD.WIDE R8, R7, 0x1, R8 ;
        /*0240*/                   VIADD R4, R4, 0x1 ;
        /*0250*/                   ISETP.GE.AND P1, PT, R4, R6, PT ;
        /*0260*/              @!P1 BRA `(.L_x_9) ;
"""


def test_screen_loops_count_probes_and_writes():
    """The screen's SASS reader finds both per-item loops, the probe loop
    and the mask's write-out loop, and gives their ALU and FMA instructions
    (the arithmetic, without loads, stores, compares and branches) per
    (row, gram) and per written pair."""
    got = sass.screen_loops(sass.parse_sass(PROBE_SASS + WRITE_SASS), rows=32)
    assert got["per_step"] == 9 and got["per_row_gram"] == 9 / 32
    assert got["work_per_row_gram"] == 5 / 32
    assert got["write_per_pair"] == 7 and got["write_work_per_pair"] == 3
    assert got["write_by_opcode_per_pair"]["STG"] == 1
    with pytest.raises(RuntimeError, match="no step loop"):
        sass.screen_loops(sass.parse_sass(PROBE_SASS), rows=32)


def test_profiler_time_is_per_recorded_launch():
    """A kernel's profiler time is its device time over the launches the
    profiler recorded, not over the launches made: a window that kept 3 of
    5 launches of a 0.2 ms kernel still reads 0.2 ms."""
    import chip_smoke

    seen = {"(anonymous namespace)::screen_kernel(...)": (0.6, 3), "bound_kernel": (540.0, 4),
            "Memcpy DtoH": (0.1, 10)}
    assert chip_smoke.per_launch_ms(seen, "screen_kernel") == pytest.approx((0.2, 3))
    assert chip_smoke.per_launch_ms(seen, "bound_kernel") == pytest.approx((135.0, 4))
    assert chip_smoke.per_launch_ms(seen, "settle_kernel") == (0.0, 0)


def test_probe_variants_cover_the_screen_widths():
    """The tuning probe's screen variants apply to ``match.cu`` and set
    8, 16 and 32 rows a block and 256, 512 and 1,024 threads."""
    src = (myers_probe._build.CSRC_DIR / "match.cu").read_text()
    entries, threads = set(), set()
    for edits in myers_probe.SCREEN_VARIANTS.values():
        out = myers_probe.patched(src, edits)
        assert (out == src) == (not edits)
        entries |= set(re.findall(r"using Entry = (uint\d+_t);", out))
        threads |= set(re.findall(r"constexpr int kThreads = (\d+);", out))
    assert entries == {"uint8_t", "uint16_t", "uint32_t"}
    assert threads == {"256", "512", "1024"}


def test_probe_phase_cuts_apply_once():
    """Each phase cut of the probe finds its loop in ``match.cu`` once."""
    src = (myers_probe._build.CSRC_DIR / "match.cu").read_text()
    for edits in myers_probe.SCREEN_PHASE_CUTS.values():
        assert myers_probe.patched(src, edits) != src
