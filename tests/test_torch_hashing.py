"""Host-side copies in the PyTorch port against the JAX package: hash
parameters, width buckets, the blockwise encoder and the parameter
conversion; and the port's own segmenter and chunker.  Every comparison is
exact."""

from __future__ import annotations

import numpy as np
import pytest

from advanced_scrapper_tpu.core import hashing as ref_hashing
from advanced_scrapper_tpu.core import tokenizer as ref_tok
from advanced_scrapper_tpu.cpu import hostbatch as ref_hb
from advanced_scrapper_tpu_torch.convert import params_from_reference
from advanced_scrapper_tpu_torch.core import hashing, tokenizer
from advanced_scrapper_tpu_torch.cpu import hostbatch

PARAM_FIELDS = ("a32", "b32", "band_salt", "a61", "b61")


def adversarial_corpus(rng: np.random.RandomState, n: int) -> list[bytes]:
    """``tests/test_encode_parity.py``'s mix: empty docs, sub-shingle docs,
    power-of-two lengths (bucket edges), long blockwise docs, planted
    duplicates."""
    docs: list[bytes] = []
    specials = [0, 1, 4, 63, 64, 65, 128, 4096, 4097]
    for i in range(n):
        if i < len(specials):
            ln = specials[i]
        elif i >= 8 and rng.rand() < 0.25:
            docs.append(docs[rng.randint(0, i)])
            continue
        else:
            ln = int(rng.randint(5, 9000))
        docs.append(rng.randint(32, 127, size=ln, dtype=np.uint8).tobytes())
    return docs


@pytest.mark.parametrize(
    "num_perm,num_bands,seed", [(128, 16, 1), (128, 32, 7), (64, 8, 123)]
)
def test_make_params_matches_reference(num_perm, num_bands, seed):
    got = hashing.make_params(num_perm, num_bands, 5, seed)
    want = ref_hashing.make_params(num_perm, num_bands, 5, seed)
    for name in PARAM_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.rows_per_band == want.rows_per_band


def test_fmix32_and_gram_hashes_match_reference():
    rng = np.random.RandomState(0)
    h = rng.randint(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    h[:3] = [0, 1, 0xFFFFFFFF]
    assert np.array_equal(hashing.fmix32_np(h), ref_hashing.fmix32_np(h))
    for raw in (b"", b"abcd", b"abcde", rng.bytes(300)):
        for q in (3, 5):
            assert np.array_equal(
                hashing.gram_hashes_np(raw, q), ref_hashing.gram_hashes_np(raw, q)
            )


def test_buckets_match_reference():
    rng = np.random.RandomState(0)
    lens = np.r_[0, 1, 63, 64, 65, 4095, 4096, 4097, rng.randint(0, 1 << 22, 5000)]
    for mx in (None, 4096, 1000):
        assert np.array_equal(
            tokenizer.bucket_widths(lens, max_bucket=mx),
            ref_tok.bucket_widths(lens, max_bucket=mx),
        )
    for n in (0, 1, 64, 65, 5000):
        assert tokenizer.bucket_len(n) == ref_tok.bucket_len(n)
    for bs in (64, 1000, 16384):
        assert tokenizer.tile_rows_options(bs, 64) == ref_tok.tile_rows_options(bs, 64)
    for bl, ov in ((64, 4), (4096, 4), (1000, 0)):
        assert np.array_equal(
            hostbatch.block_counts(lens, bl, ov), ref_hb.block_counts(lens, bl, ov)
        )


@pytest.mark.parametrize("block_len", [None, 64, 7, 4096])
def test_encode_batch_matches_reference(block_len):
    """Padded rows of a bucketed width, or cut to ``block_len``."""
    docs = adversarial_corpus(np.random.RandomState(5), 40) + ["", "é" * 40, b"raw bytes"]
    got = tokenizer.encode_batch(docs, block_len)
    want = ref_tok.encode_batch(docs, block_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in zip(tokenizer.encode_batch([], block_len), ref_tok.encode_batch([], block_len)):
        assert g.shape == w.shape


@pytest.mark.parametrize("width,overlap", [(64, 4), (256, 4), (1024, 0), (4096, 4)])
def test_encode_blocks_matches_reference(width, overlap):
    docs = adversarial_corpus(np.random.RandomState(3), 64)
    got = tokenizer.encode_blocks(docs, width, overlap=overlap)
    want = ref_tok.encode_blocks(docs, width, overlap=overlap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("width,overlap", [(64, 4), (256, 4), (1024, 0), (4096, 4)])
def test_encode_blocks_ranges_matches_reference(width, overlap):
    """The vectorised range encoder against the reference's block encoder
    over the same ranges, with and without the caller's blob padding."""
    docs = adversarial_corpus(np.random.RandomState(3), 64)
    lens = np.fromiter(map(len, docs), np.int64, count=len(docs))
    offsets = np.zeros((len(docs) + 1,), np.int64)
    np.cumsum(lens, out=offsets[1:])
    blob = b"".join(docs)
    sel = np.arange(0, len(docs), 3)
    sel = np.r_[sel, len(docs) - 1]  # the last range ends at the blob's end
    want = ref_tok.encode_blocks([docs[i] for i in sel], width, overlap=overlap)
    counts = hostbatch.block_counts(lens[sel], width, overlap)
    for pad in (b"", bytes(width)):
        got = hostbatch.encode_blocks_ranges(
            blob + pad, offsets[sel], lens[sel], counts, width, overlap
        )
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_encode_blocks_ranges_rejects_bad_ranges():
    with pytest.raises(ValueError):
        hostbatch.encode_blocks_ranges(b"abc", [0], [4], [1], 64, 4)
    with pytest.raises(ValueError):
        hostbatch.encode_blocks_ranges(b"abc", [0], [3], [1], 4, 4)


def test_params_from_reference_round_trip():
    ref = ref_hashing.make_params(128, 16, 5, 1)
    got = params_from_reference(
        ref.num_perm, ref.num_bands, ref.shingle_k, ref.seed,
        *(getattr(ref, f) for f in PARAM_FIELDS),
    )
    port = hashing.make_params(128, 16, 5, 1)
    for name in PARAM_FIELDS:
        assert np.array_equal(getattr(got, name), getattr(port, name)), name
    assert (got.num_perm, got.num_bands, got.shingle_k, got.seed) == (128, 16, 5, 1)
    with pytest.raises(ValueError):  # a32 of the wrong dtype
        params_from_reference(
            128, 16, 5, 1, ref.a32.astype(np.int64), ref.b32, ref.band_salt,
            ref.a61, ref.b61,
        )


@pytest.mark.parametrize("k,S", [(5, 8), (5, 64), (5, 1000), (1, 3), (9, 1)])
def test_segment_ranges_cover_every_shingle_once(k, S):
    """Every shingle position of every article lies in exactly one segment
    of its owner; consecutive segments of an article overlap by k-1
    bytes; articles below k bytes get none."""
    rng = np.random.RandomState(k * 100 + S)
    lens = np.r_[0, 1, k - 1, k, k + 1, S, S + k - 1, S + k, 3 * S + k - 1,
                 rng.randint(0, 3000, size=60)].astype(np.int64)
    gaps = rng.randint(0, 7, size=len(lens))  # articles need not abut
    off = np.cumsum(np.r_[0, (lens + gaps)[:-1]]).astype(np.int64)
    owner = rng.permutation(len(lens)) + 10
    start, shingles, seg_owner = hostbatch.segment_ranges(off, lens, owner, k, S)
    assert start.dtype == np.int64 and shingles.dtype == seg_owner.dtype == np.int32
    assert (shingles >= 1).all() and (shingles <= S).all()
    n_valid = np.maximum(lens - k + 1, 0)
    for d in range(len(lens)):
        mine = np.flatnonzero(seg_owner == owner[d])
        if n_valid[d] == 0:
            assert mine.size == 0
            continue
        covered = np.concatenate([np.arange(start[g], start[g] + shingles[g]) for g in mine])
        assert np.array_equal(covered, off[d] + np.arange(n_valid[d]))  # once, in order
        ends = start[mine] + shingles[mine] + (k - 1)  # last byte read, exclusive
        assert ends[-1] == off[d] + lens[d]
        assert np.array_equal(ends[:-1] - start[mine][1:], np.full(mine.size - 1, k - 1))


def test_segment_ranges_empty_and_bad_args():
    got = hostbatch.segment_ranges(np.zeros(0), np.zeros(0), np.zeros(0), 5, 64)
    assert all(x.size == 0 for x in got)
    with pytest.raises(ValueError):
        hostbatch.segment_ranges([0], [10], [0], 5, 0)


@pytest.mark.parametrize("budget", [1, 100, 4096, 1 << 20])
def test_chunk_ranges_are_greedy_runs_of_whole_articles(budget):
    rng = np.random.RandomState(budget % 97)
    lens = np.r_[0, rng.randint(0, 9000, size=200), 0, 0, 50000].astype(np.int64)
    chunks = hostbatch.chunk_ranges(lens, budget)
    assert chunks[0][0] == 0 and chunks[-1][1] == len(lens)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    for lo, hi in chunks:
        size = int(lens[lo:hi].sum())
        assert hi > lo and (size <= budget or hi == lo + 1)
        if hi < len(lens):  # greedy: the next article would not have fit
            assert size + lens[hi] > budget
    assert hostbatch.chunk_ranges(np.zeros(0, np.int64), budget) == []
