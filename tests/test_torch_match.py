"""The port's q-gram screen (``ops/match.py``) against the JAX package's:
name tables, the CSR view the kernel reads, and the plain screen over
ragged rows against the reference's ``match_screen`` on padded ones —
truncated and gram-less names, short titles, empty rows and rows shorter
than q, non-ASCII text, and a threshold sweep where the float32 bounds
land on whole numbers.  Every comparison is exact.  Last, the kernel
wrapper's checks."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.core.tokenizer import encode_batch
from advanced_scrapper_tpu.ops import match as ref
from advanced_scrapper_tpu_torch.ops import match, match_cuda


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
    assert {k: v.dtype for k, v in t.items()} == match_cuda.TABLES
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
        match_cuda.check_tables({**tables, "grams": tables["grams"].to(torch.int32)},
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
