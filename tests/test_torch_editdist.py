"""The port's Myers bound (``ops/editdist.py``) against the JAX package's:
pattern masks, the plain shared-text distance at blocks 512, 31, 32 and 7
with lengths on tile edges, empty text and patterns of 1 and 32 bytes, and
the fused bound (bit 1 of the mask) together with the plain screen (bit 0)
against the reference's fused screen step, ``make_screen_step``, with
``ok = False`` patterns and texts of exactly ``m`` and ``m + 1`` bytes.
Every comparison is exact.  Last, the kernel wrapper's checks."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.core.tokenizer import encode_batch
from advanced_scrapper_tpu.ops import editdist as ref
from advanced_scrapper_tpu.ops import match as ref_match
from advanced_scrapper_tpu.ops.pack import pack_tile_planes
from advanced_scrapper_tpu_torch.ops import editdist, editdist_cuda, match
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
