"""The port's Myers bound (``ops/editdist.py``) against the JAX package's:
pattern masks, the plain shared-text distance at blocks 512, 31, 32 and 7
with lengths on tile edges, empty text and patterns of 1 and 32 bytes, and
the fused bound (bit 1 of the mask) together with the plain screen (bit 0)
against the reference's fused screen step, ``make_screen_step``, with
``ok = False`` patterns and texts of exactly ``m`` and ``m + 1`` bytes.
Every comparison is exact.  Then the kernel wrapper's checks, a model of
the kernel's chain walk, the SASS reader and the tuning probe's
variants; for the per-pair kernel ``myers_pairs``, the plain distance at
the edges of its geometry, its step loop in SASS, and the step time and
chain floor its timing row reports."""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.core.tokenizer import encode_batch
from advanced_scrapper_tpu.ops import editdist as ref
from advanced_scrapper_tpu.ops import match as ref_match
from advanced_scrapper_tpu.ops.pack import pack_tile_planes
import chip_smoke
import myers_probe
from advanced_scrapper_tpu_torch.ops import editdist, editdist_cuda, match, sass
from test_torch_match import ragged


def patterns(rng: np.random.RandomState) -> list[bytes]:
    return [bytes(rng.randint(97, 123, size=rng.randint(1, 33), dtype=np.uint8))
            for _ in range(10)] + [b"a", bytes(rng.randint(97, 123, 32, dtype=np.uint8))]


def u32(masks: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(masks.view(np.int32).copy()).view(torch.uint32)


def test_pattern_masks_equal_reference():
    rng = np.random.RandomState(1)
    pats = patterns(rng) + [b"", b"y" * 33, "é".encode()]
    for a, b in zip(editdist.build_pattern_masks(pats), ref.build_pattern_masks(pats)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    d, m = rng.randint(0, 33, 50), rng.randint(1, 33, 50)
    assert np.array_equal(editdist.partial_ratio_bound(d, m), ref.partial_ratio_bound(d, m))
    assert editdist.MAX_PATTERN == ref.MAX_PATTERN


@pytest.mark.parametrize("block", [512, 31, 32, 7])
def test_semiglobal_dist_shared_plain_equals_reference(block):
    rng = np.random.RandomState(block)
    pats = patterns(rng)
    masks, lens, _ok = ref.build_pattern_masks(pats)
    L = 1100
    text = rng.randint(97, 123, size=(9, L)).astype(np.uint8)
    text[3, 100:110] = np.frombuffer(pats[0][:10].ljust(10, b"a"), np.uint8)
    # empty, one byte, on and around tile edges, the full width
    tlens = np.array([0, 1, 31, block, block + 1, block + 31, block + 32, 1099, 1100], np.int32)
    want = np.asarray(ref.semiglobal_dist_shared(
        jnp.asarray(masks), jnp.asarray(lens), jnp.asarray(text), jnp.asarray(tlens),
        block=block))
    got = editdist.semiglobal_dist_shared_plain(
        u32(masks), torch.from_numpy(lens), torch.from_numpy(text), torch.from_numpy(tlens),
        block=block)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (want[0] == lens).all()  # empty text gives m


def fused_case(rng: np.random.RandomState):
    """Names (exact and fuzzy; refine patterns among them, plus an empty
    and a 40-byte one with ``ok`` False), and ``title\\ntext`` rows with
    names planted exact and with an edit, texts of exactly ``m`` and
    ``m + 1`` bytes for a short pattern, non-ASCII texts (flag off) and
    non-ASCII titles (bytes over 127 inside flagged rows)."""
    pats = patterns(rng)
    names = pats + [b"AAPL", b"IBM", b"x" * 100, b"", b"y" * 40, b"Tim Cook"]
    fuzzy = np.array([not n.isupper() for n in names])
    ref_pats = pats + [b"", b"y" * 40]
    cols = np.array(list(range(len(pats))) + [len(names) - 3, len(names) - 2], np.int64)
    rows, tl, ttl, fl = [], [], [], []
    for i in range(48):
        title = bytes(rng.randint(97, 123, size=rng.randint(0, 20), dtype=np.uint8))
        body = bytearray(rng.randint(97, 123, size=int(rng.choice([0, 5, 80, 700])),
                                     dtype=np.uint8))
        if len(body) >= 80 and i % 2:
            nm = bytearray(names[rng.randint(len(names))])
            if i % 4 == 3 and nm:
                nm[0] = 122
            body[10 : 10 + len(nm)] = nm
        if i == 0:
            body = bytearray(pats[10])           # text of exactly m (m = 1)
        if i == 1:
            body = bytearray(pats[10] + b"b")    # m + 1
        if i % 9 == 4:
            body += "é".encode()
        if i % 7 == 5:
            title = "Zürich".encode() + title
        rows.append(title + b"\n" + bytes(body))
        tl.append(len(body))
        ttl.append(len(title))
        fl.append(match.FLAG_REFINE_OK if body and bytes(body).isascii() else 0)
    return (names, fuzzy, ref_pats, cols, rows, np.array(tl, np.int32),
            np.array(ttl, np.int32), np.array(fl, np.int32))


@pytest.mark.parametrize("threshold", [95.0, 90.0, 80.0, 97.5, 50.0])
def test_fused_bound_and_screen_equal_reference_step(threshold):
    rng = np.random.RandomState(int(threshold * 2))
    names, fuzzy, pats, cols, rows, tl, ttl, fl = fused_case(rng)
    masks, lens, ok = ref.build_pattern_masks(pats)
    tables = ref_match.prepare_names(names, fuzzy=fuzzy)
    step = ref_match.make_screen_step(tables, (masks, lens, ok, cols))
    width = 1024
    tok, dl = encode_batch(rows, block_len=width)
    own = np.arange(len(rows), dtype=np.int32)
    want, _own = step(pack_tile_planes(tok, dl, tl, ttl, fl, own), threshold,
                      rows=len(rows), width=width)
    want = np.asarray(want)

    text, off, ln = ragged(rows)
    tl_t, ttl_t, fl_t = (torch.from_numpy(x) for x in (tl, ttl, fl))
    got = match.match_screen(text, off, ln, tl_t, ttl_t,
                             match.screen_tensors(match.prepare_names(names, fuzzy=fuzzy), "cpu"),
                             threshold=threshold)
    dist = torch.empty((len(rows), len(pats)), dtype=torch.int32)
    editdist.myers_bound_plain(text, off, ln, tl_t, fl_t, u32(masks), torch.from_numpy(lens),
                               torch.from_numpy(ok), torch.from_numpy(cols), threshold, got,
                               dist=dist)
    assert np.array_equal(got.numpy(), want)
    assert (want & 2).any() and (want & 1).any()
    # the dispatcher, on a fresh screen mask, gives the same bits
    again = match.match_screen(text, off, ln, tl_t, ttl_t,
                               match.screen_tensors(match.prepare_names(names, fuzzy=fuzzy),
                                                    "cpu"), threshold=threshold)
    editdist.myers_bound(text, off, ln, tl_t, fl_t, u32(masks), torch.from_numpy(lens),
                         torch.from_numpy(ok), torch.from_numpy(cols), threshold, again)
    assert torch.equal(again, got)
    d_ref = np.asarray(ref.semiglobal_dist_shared(
        jnp.asarray(masks), jnp.asarray(lens), jnp.asarray(tok), jnp.asarray(dl)))
    assert np.array_equal(dist.numpy(), d_ref)


def test_wrapper_and_checks_refuse_bad_input():
    rng = np.random.RandomState(3)
    names, fuzzy, pats, cols, rows, tl, ttl, fl = fused_case(rng)
    masks, lens, ok = editdist.build_pattern_masks(pats)
    text, off, ln = ragged(rows)
    tl_t, fl_t = torch.from_numpy(tl), torch.from_numpy(fl)
    mask = torch.zeros((len(rows), len(names)), dtype=torch.uint8)
    args = [u32(masks), torch.from_numpy(lens), torch.from_numpy(ok), torch.from_numpy(cols)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        editdist_cuda.myers_bound(text, off, ln, tl_t, fl_t, *args, 95.0, mask)
    assert editdist_cuda.myers_bound.launches == 0
    bad_cols = args[:3] + [torch.zeros(len(pats), dtype=torch.int64)]
    with pytest.raises(ValueError, match="distinct"):
        editdist.myers_bound_plain(text, off, ln, tl_t, fl_t, *bad_cols, 95.0, mask)
    with pytest.raises(TypeError):
        editdist.myers_bound_plain(text, off, ln, tl_t, fl_t, args[0].view(torch.int32)
                                   .to(torch.int64), *args[1:], 95.0, mask)
    long_lens = args[:1] + [torch.full((len(pats),), 33, dtype=torch.int32)] + args[2:]
    with pytest.raises(ValueError, match="pattern lengths"):
        editdist.myers_bound_plain(text, off, ln, tl_t, fl_t, *long_lens, 95.0, mask)


# -- the CUDA kernel's chain walk, modelled on the CPU --------------------------


def chain_walk(text, off, lens, text_len, flags, masks, plens, ok, *, chains, block, grid,
               every_pair):
    """A Python model of ``csrc/editdist.cu``'s walk for one pattern group:
    ``grid`` blocks take rows ``bx, bx + grid, ...``; each of a thread's
    ``chains`` chains takes the block's next needed row (gated mode: flag
    bit 0 set and text longer than the least ok pattern; rows of no bytes
    are finished at once), runs its tiles in order, live ``min(len -
    start, block + 31)`` bytes from ``start = 0, block, ...``, state reset
    per tile and best kept over the row, in rounds that step every live
    chain to the nearest end of a tile; each pattern sits in the top ``m``
    bits of its lane and the high-bit tests are the sign bits, as in the
    kernel.  Returns ``(dist int64[R, K]``,
    -1 for rows never finished, ``tiles`` as ``(row, start, live)`` in
    staging order, ``finished`` rows in order)."""
    R, K = len(lens), len(plens)
    m = np.maximum(plens.astype(np.int64), 1)
    mask32 = np.int64(0xFFFFFFFF)
    masks = ((masks.astype(np.int64) & mask32) << (32 - m)[:, None]) & mask32
    live_max = block + 31
    min_plen = int(plens[ok].min()) if ok.any() else np.iinfo(np.int32).max
    dist = np.full((R, K), -1, np.int64)
    tiles, finished = [], []

    def finish(r, best):
        assert dist[r, 0] == -1, f"row {r} finished twice"
        dist[r] = best
        finished.append(r)

    for bx in range(grid):
        nxt = [bx]

        def take():
            while nxt[0] < R:
                r = nxt[0]
                nxt[0] += grid
                if not every_pair and (not flags[r] & 1 or text_len[r] <= min_plen):
                    continue
                if lens[r] > 0:
                    return r
                finish(r, m.copy())
            return -1

        row = [take() for _ in range(chains)]
        start = [0] * chains
        rem = [min(int(lens[r]), live_max) if r >= 0 else 0 for r in row]
        pos = [0] * chains
        pv = [np.full(K, mask32) for _ in range(chains)]
        mv = [np.zeros(K, np.int64) for _ in range(chains)]
        score = [m.copy() for _ in range(chains)]
        best = [m.copy() for _ in range(chains)]
        tiles += [(r, 0, n) for r, n in zip(row, rem) if r >= 0]
        while True:
            active = [i for i in range(chains) if row[i] >= 0]
            if not active:
                break
            steps = min(rem[i] for i in active)
            for j in range(steps):
                for i in active:
                    c = int(text[off[row[i]] + start[i] + pos[i] + j])
                    eq = masks[:, c]
                    xv = eq | mv[i]
                    xh = ((((eq & pv[i]) + pv[i]) & mask32) ^ pv[i]) | eq
                    ph = mv[i] | (~(xh | pv[i]) & mask32)
                    mh = pv[i] & xh
                    score[i] = score[i] + (ph >> 31) - (mh >> 31)
                    ph = (ph << 1) & mask32
                    mh = (mh << 1) & mask32
                    pv[i] = mh | (~(xv | ph) & mask32)
                    mv[i] = ph & xv
                    best[i] = np.minimum(best[i], score[i])
            for i in active:
                pos[i] += steps
                rem[i] -= steps
                if rem[i] > 0:
                    continue
                start[i] += block
                if start[i] >= lens[row[i]]:
                    finish(row[i], best[i])
                    best[i] = m.copy()
                    start[i] = 0
                    row[i] = take()
                    if row[i] < 0:
                        continue
                rem[i] = min(int(lens[row[i]]) - start[i], live_max)
                pos[i] = 0
                pv[i] = np.full(K, mask32)
                mv[i] = np.zeros(K, np.int64)
                score[i] = m.copy()
                tiles.append((row[i], start[i], rem[i]))
    return dist, tiles, finished


def walk_case(rng: np.random.RandomState, chains: int, block: int):
    """Rows of ``(n - 1) * block + tail`` bytes for n of 1, chains - 1,
    chains, chains + 1 and 2 * chains + 1 and every tail class (1, 3, 4, 31,
    32, block, block + 30, block + 31: a tail over ``block`` adds a tile),
    rows of no bytes, some rows' flag bit 0 clear between rows that are
    gated in, and texts no longer than the shortest pattern."""
    live = block + 31
    tails = sorted({1, 3, 4, 31, 32, block, live - 1, live})
    lens = [0]
    for n_tiles in sorted({1, max(chains - 1, 1), chains, chains + 1, 2 * chains + 1}):
        lens += [(n_tiles - 1) * block + tail for tail in tails]
    lens += [0, 0]
    order = rng.permutation(len(lens))
    lens = np.array(lens, np.int64)[order]
    rows = [bytes(rng.randint(97, 101, size=n, dtype=np.uint8)) for n in lens]
    text, off, ln = ragged(rows)
    flags = np.where(rng.rand(len(rows)) < 0.7, match.FLAG_REFINE_OK, 0).astype(np.int32)
    text_len = lens.astype(np.int32)
    text_len[rng.rand(len(rows)) < 0.1] = 2  # no longer than the shortest pattern
    pats = [b"ab", b"abcabcd", bytes(rng.randint(97, 101, 32, dtype=np.uint8)), b"dd"]
    masks, plens, ok = editdist.build_pattern_masks(pats)
    ok[3] = False
    return text.numpy(), off.numpy(), lens, text_len, flags, masks, plens, ok


@pytest.mark.parametrize("every_pair", [False, True])
def test_chain_walk_covers_the_plain_tiles(every_pair):
    """The model of the kernel's walk (4 chains, tiles of 7 bytes to keep
    it small) stages exactly the live tiles the plain version scans (for
    the rows it needs), finishes every needed row once, and its distances
    equal ``semiglobal_dist_shared_plain``.  The kernel itself is held to
    the plain version on the card (``chip_smoke.check_myers_edges``)."""
    chains, block = 4, 7
    rng = np.random.RandomState(chains * 10 + block)
    text, off, lens, text_len, flags, masks, plens, ok = walk_case(rng, chains, block)
    dist, tiles, finished = chain_walk(text, off, lens, text_len, flags, masks, plens, ok,
                                       chains=chains, block=block, grid=3,
                                       every_pair=every_pair)
    need = np.ones(len(lens), bool) if every_pair else (
        (flags & 1).astype(bool) & (text_len > plens[ok].min()))
    assert sorted(finished) == list(np.flatnonzero(need))
    want_tiles = sorted((r, s, min(int(lens[r]) - s, block + 31))
                        for r in np.flatnonzero(need) for s in range(0, int(lens[r]), block))
    assert sorted(tiles) == want_tiles
    width = int(lens.max())
    padded = np.zeros((len(lens), width), np.uint8)
    for r in range(len(lens)):
        padded[r, :lens[r]] = text[off[r]:off[r] + lens[r]]
    want = editdist.semiglobal_dist_shared_plain(
        u32(masks), torch.from_numpy(plens), torch.from_numpy(padded),
        torch.from_numpy(lens.astype(np.int32)), block=block).numpy()
    assert np.array_equal(dist[need], want[need])
    assert (dist[~need] == -1).all()


SASS = """
        Function : _ZN12_GLOBAL__N_112bound_kernelENS_4ArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
.L_x_1:
        /*0010*/                   LDS.U8 R2, [R3] ;
        /*0020*/                   IMAD R4, R2, R5, R6 ;
        /*0030*/                   LDS R7, [R4] ;
        /*0040*/                   LOP3.LUT R8, R7, R9, RZ, 0xfc, !PT ;
        /*0050*/                   LDS.U8 R2, [R3+0x1] ;
        /*0060*/                   IMAD R4, R2, R5, R6 ;
        /*0070*/                   LDS R7, [R4] ;
        /*0080*/                   VIMNMX R8, R7, R9, PT ;
        /*0090*/               @P0 BRA `(.L_x_1) ;
        /*00a0*/                   NOP ;
        /*00b0*/              @!P1 BRA `(.L_x_1) ;
.L_x_2:
        /*00c0*/                   LDS.U8 R2, [R3] ;
        /*00d0*/                   LDS.U8 R2, [R3+0x1] ;
        /*00e0*/                   LDS.U8 R2, [R3+0x2] ;
        /*00f0*/                   LDG.E R7, desc[UR4][R4.64] ;
        /*0100*/                   BRA 0xc0 ;
        /*0110*/                   EXIT ;
"""


def test_sass_step_loop_counts():
    """The SASS reader finds the branch-free innermost step loop (not the
    loop around it, not the one with a global load) and counts its
    instructions per byte load, by opcode and by pipe."""
    instrs = sass.parse_sass(SASS)
    assert [op for _a, op, _r in instrs][:2] == ["LDC", "LDS.U8"]
    assert instrs[9][2] == "0x10" and instrs[16][2].strip() == "0xc0"
    got = sass.step_loop(instrs)
    assert got["steps_in_loop"] == 2 and got["instructions_in_loop"] == 9
    assert got["per_step"] == 4.5
    assert got["by_opcode_per_step"] == {"BRA": 0.5, "IMAD": 1.0, "LDS": 2.0, "LOP3": 0.5,
                                         "VIMNMX": 0.5}
    assert got["by_pipe_per_step"] == {"alu": 1.0, "fma": 1.0, "mio": 2.0, "other": 0.5}
    with pytest.raises(RuntimeError, match="no step loop"):
        sass.step_loop(instrs[:1])


def test_probe_variants_cover_the_chain_counts():
    """The tuning probe's variants apply to the kernel's source and set 2,
    5 and 8 chains a thread; an edit whose text is gone raises."""
    src = (myers_probe._build.CSRC_DIR / "editdist.cu").read_text()
    chains = set()
    for edits in myers_probe.VARIANTS.values():
        out = myers_probe.patched(src, edits)
        assert (out == src) == (not edits)
        chains |= set(re.findall(r"constexpr int kChains = (\d+);", out))
    assert chains == {"2", "4", "5", "8"}
    with pytest.raises(ValueError, match="not once"):
        myers_probe.patched(src, [("kChains = 3;", "kChains = 2;")])
    # myers_pairs: masks 4, 8 and 16 steps ahead, 2 and 4 warps a block,
    # windows of 32 and 64 steps, a window unrolled whole or a loop of passes
    seen = {"ahead": set(), "warps": set(), "window": set(), "unrolled": set()}
    for edits in myers_probe.PAIRS_VARIANTS.values():
        out = myers_probe.patched(src, edits)
        assert (out == src) == (not edits)
        seen["ahead"] |= set(re.findall(r"constexpr int kAhead = (\d+);", out))
        seen["warps"] |= set(re.findall(r"constexpr int kPairWarps = (\d+);", out))
        seen["window"] |= set(re.findall(r"constexpr int kWindow = (\d+);", out))
        seen["unrolled"].add(myers_probe.UNROLL_PASS in out)
    assert seen == {"ahead": {"4", "8", "16"}, "warps": {"2", "4"}, "window": {"32", "64"},
                    "unrolled": {False, True}}


def test_sass_reads_one_function_of_several():
    """A library of two kernels: addresses restart in each function, so
    the reader takes the named one alone."""
    other = SASS.replace("bound_kernel", "pairs_kernel").replace("LDS.U8", "LDG.E.U8")
    both = sass.parse_sass(SASS + other)
    assert len(both) == 2 * len(sass.parse_sass(SASS))
    assert sass.parse_sass(SASS + other, "bound_kernel") == sass.parse_sass(SASS)
    assert sass.step_loop(sass.parse_sass(other + SASS, "bound_kernel"))["steps_in_loop"] == 2


def test_sass_reads_the_pairs_step_loop():
    """``myers_pairs``' step loop is the one that holds the next window's
    global loads (here the three-step loop), or, in a variant that keeps a
    window a loop of passes without them, that loop (the two-step one)."""
    instrs = sass.parse_sass(SASS)
    assert sass.pairs_loop(instrs)["steps_in_loop"] == 3
    assert sass.pairs_loop(instrs[:12])["steps_in_loop"] == 2
    with pytest.raises(RuntimeError, match="no step loop"):
        sass.pairs_loop(instrs[:1])


# -- one pattern per pair: semiglobal_dist, prune_mask_tables ------------------

T = editdist.BLOCK


def joined(texts: list[bytes]) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(text, row_off, tlens)`` of texts joined in one buffer."""
    lens = np.array([len(t) for t in texts], np.int64)
    off = np.zeros(len(texts), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    return (torch.frombuffer(bytearray(b"".join(texts) or b"\0"), dtype=torch.uint8)
            [:int(lens.sum())], torch.from_numpy(off), torch.from_numpy(lens.astype(np.int32)))


def padded(texts: list[bytes]) -> np.ndarray:
    out = np.zeros((len(texts), max(1, max(map(len, texts)))), np.uint8)
    for i, t in enumerate(texts):
        out[i, :len(t)] = np.frombuffer(t, np.uint8)
    return out


def pair_case(rng: np.random.RandomState):
    """Patterns over a small alphabet (distances spread from 0 to m), an
    empty and a 40-byte one, and texts of 0, 1, T−1, T, T+1, 2T+1 and
    3T+31 bytes and around a tile's 543 live bytes, with a pattern planted
    across a tile edge."""
    pats = [bytes(rng.randint(97, 101, size=rng.randint(1, 33), dtype=np.uint8))
            for _ in range(14)] + [b"a", b"abcd" * 8, b"", b"y" * 40]
    texts = [bytes(rng.randint(97, 101, size=n, dtype=np.uint8))
             for n in (0, 1, T - 1, T, T + 1, 2 * T + 1, 3 * T + 31, 40, 543, 544)]
    texts[5] = texts[5][:T - 3] + pats[1] + texts[5][T - 3 + len(pats[1]):]
    return pats, texts


def test_semiglobal_dist_plain_equals_reference():
    rng = np.random.RandomState(21)
    pats, texts = pair_case(rng)
    masks, lens, _ok = ref.build_pattern_masks(pats)
    pt = np.repeat(np.arange(len(texts)), len(pats)).astype(np.int32)
    pp = np.tile(np.arange(len(pats)), len(texts)).astype(np.int32)
    tl = np.array([len(t) for t in texts], np.int32)
    want = np.asarray(ref.semiglobal_dist(
        jnp.asarray(masks[pp]), jnp.asarray(lens[pp]), jnp.asarray(padded(texts)[pt]),
        jnp.asarray(tl[pt])))
    text, off, tlens = joined(texts)
    args = (u32(masks), torch.from_numpy(lens), text, off, tlens, torch.from_numpy(pt),
            torch.from_numpy(pp))
    got = editdist.semiglobal_dist_plain(*args)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(editdist.semiglobal_dist_plain(*args, pairs_per_batch=7).numpy(), want)
    assert np.array_equal(editdist.semiglobal_dist(*args).numpy(), want)
    assert (want[pt == 0] == np.maximum(lens, 1)).all()  # empty text gives max(m, 1)
    assert (want == 0).any() and (want > 2).any()


def test_semiglobal_dist_gives_minus_one_out_of_range():
    rng = np.random.RandomState(2)
    pats, texts = pair_case(rng)
    masks, lens, _ok = ref.build_pattern_masks(pats)
    lens = lens.copy()
    lens[-1] = 40  # a pattern longer than 32 bytes
    text, off, tlens = joined(texts)
    off[3] = text.numel() - 2  # a text past the buffer's end
    K, n = len(pats), len(texts)
    pt = torch.tensor([-1, n, 0, 0, 3, 1, 1], dtype=torch.int32)
    pp = torch.tensor([0, 0, -1, K, 0, K - 1, 0], dtype=torch.int32)
    got = editdist.semiglobal_dist_plain(u32(masks), torch.from_numpy(lens), text, off, tlens,
                                         pt, pp)
    assert got.tolist()[:6] == [-1] * 6 and int(got[6]) >= 0
    with pytest.raises(TypeError, match="pair_pat"):
        editdist.semiglobal_dist_plain(u32(masks), torch.from_numpy(lens), text, off, tlens,
                                       pt, pp.to(torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        editdist_cuda.myers_pairs(u32(masks), torch.from_numpy(lens), text, off, tlens, pt, pp)


@pytest.mark.parametrize("threshold", [80.0, 90.0, 95.0])
def test_prune_mask_tables_equals_reference(threshold):
    """Every pair's verdict, with patterns that are not ok (empty, 40
    bytes) and texts exactly as long as the pattern, which are never
    pruned."""
    rng = np.random.RandomState(int(threshold))
    pats, texts = pair_case(rng)
    texts += [pats[0], pats[0] + b"a"]
    tables = ref.build_pattern_masks(pats)
    pt = rng.randint(0, len(texts), 400).astype(np.int32)
    pp = rng.randint(0, len(pats), 400).astype(np.int32)
    pt[:2], pp[:2] = [len(texts) - 2, len(texts) - 1], 0
    tok, tl = padded(texts)[pt], np.array([len(t) for t in texts], np.int32)[pt]
    want = ref.prune_mask_tables(tables, tok, tl, pp, threshold)
    got = editdist.prune_mask_tables(editdist.build_pattern_masks(pats), tok, tl, pp, threshold,
                                     device="cpu")
    assert got.dtype == bool and np.array_equal(got, want)
    assert not got[0] and got.any() and not got.all()
    assert np.array_equal(editdist.prune_mask(pats, tok, tl, pp, threshold, device="cpu"), want)


@pytest.mark.parametrize("m,d,t", [(10, 9, 55.0), (20, 18, 55.0), (25, 21, 58.0),
                                   (25, 22, 56.0), (30, 27, 55.0)])
def test_prune_compare_is_float64_where_float32_differs(m, d, t):
    """At these points the reference's float64 ``bound <= t`` keeps the
    pair and the fused step's float32 compare would prune it: the per-pair
    prune follows the reference."""
    pattern = bytes(range(33, 33 + m))
    text = b"#" * (m + 3) + pattern[:m - d]  # the best substring: m - d bytes
    tables = ref.build_pattern_masks([pattern])
    tok, tl = padded([text]), np.array([len(text)], np.int32)
    want = ref.prune_mask_tables(tables, tok, tl, np.zeros(1, np.int32), t)
    got = editdist.prune_mask_tables(tables, tok, tl, np.zeros(1, np.int32), t, device="cpu")
    assert not want[0] and not got[0]
    text_t, off, tlens = joined([text])
    dist = editdist.semiglobal_dist(u32(tables[0]), torch.from_numpy(tables[1]), text_t, off,
                                    tlens, torch.zeros(1, dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32))
    assert int(dist[0]) == d
    assert bool(editdist.bound_pruned(dist[None, :], torch.tensor([m], dtype=torch.int32), t))


# -- myers_pairs: its geometry's edges, its chain floor --------------------------


def test_pair_edge_lengths():
    """The text lengths at the edges of ``myers_pairs``' geometry that
    ``chip_smoke.check_myers_pairs_vs_plain`` feeds the kernel, from the
    source's 4 warps a block: a second warp, a second and a third round."""
    assert chip_smoke.pairs_constant("kPairWarps") == 4
    assert chip_smoke.pair_edge_lengths() == [
        16383, 16384, 16385, 65535, 65536, 65537, 131071, 131072, 131073]
    assert chip_smoke.pair_edge_lengths(block=7)[:3] == [223, 224, 225]


@pytest.mark.parametrize("window, steps", [(64, 512), (32, 512), (1, 542), (100, 500)])
def test_lone_step_on_fixed_numbers(window, steps):
    """A lone chain's step is the slope between the 543-byte and the 1-byte
    lone launch over the steps the first runs past the second: whole
    windows of ``window`` steps (9 and 1 of 64, 17 and 1 of 32, 6 and 1 of
    100), or the live bytes where there are no windows."""
    assert chip_smoke.lone_step_ms(0.0131, 0.0029, window) == pytest.approx(0.0102 / steps)


def test_chain_floor_on_fixed_numbers():
    """A launch whose longest live tile is n steps has the floor launch
    floor + n steps of a lone chain; the row gives the mean over launches.
    With a step of 19.98 ns and a launch floor of 0.00102 ms, a launch of
    543-step tiles has the floor 0.0118691 ms, below the lone 543-byte
    launch itself, which also stages the masks and runs whole windows."""
    step = 19.98e-6
    assert chip_smoke.chain_floor_ms([543], step, 0.00102) == pytest.approx(0.01186914)
    assert chip_smoke.chain_floor_ms([543, 100, 1], step, 0.001) == pytest.approx(
        0.001 + step * 644 / 3)
    assert chip_smoke.chain_floor_ms([0, 0], step, 0.002) == pytest.approx(0.002)


@pytest.mark.parametrize("n", [*chip_smoke.pair_edge_lengths(), 200_000])
def test_semiglobal_dist_plain_equals_reference_at_the_kernel_edges(n):
    """Texts one byte short of, at and one past the tile counts where
    ``myers_pairs`` takes a second warp, a second round or a third
    (``chip_smoke.pair_edge_lengths``), and one of 200,000 bytes: the plain
    distance (the kernel's reference on the card) equals the JAX package's
    ``semiglobal_dist``, patterns of 1, 7 and 32 bytes, one planted exact
    across the last tile edge and one with an edit across the edge before,
    exactly."""
    rng = np.random.RandomState(n % 1000)
    pats = [b"a", bytes(rng.randint(97, 101, 7, dtype=np.uint8)),
            bytes(rng.randint(97, 101, 32, dtype=np.uint8))]
    text = bytearray(rng.randint(97, 101, size=n, dtype=np.uint8))
    last = (n - 1) // T * T
    at = min(last - 3, n - 7)
    text[at:at + 7] = pats[1]                                   # across the last edge
    text[last - T - 5:last - T + 27] = pats[2][:20] + b"z" + pats[2][21:]
    assert len(text) == n
    masks, lens, _ok = ref.build_pattern_masks(pats)
    pp = np.arange(len(pats), dtype=np.int32)
    want = np.asarray(ref.semiglobal_dist(
        jnp.asarray(masks[pp]), jnp.asarray(lens[pp]),
        jnp.asarray(np.frombuffer(bytes(text), np.uint8)[None].repeat(len(pats), 0)),
        jnp.asarray(np.full(len(pats), n, np.int32))))
    text_t, off, tlens = joined([bytes(text)])
    got = editdist.semiglobal_dist_plain(u32(masks), torch.from_numpy(lens), text_t, off, tlens,
                                         torch.zeros(len(pats), dtype=torch.int32),
                                         torch.from_numpy(pp))
    assert np.array_equal(got.numpy(), want)
    assert want[1] == 0 and want[2] <= 1
