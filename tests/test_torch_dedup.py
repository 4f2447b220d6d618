"""The port's ``NearDupEngine`` on the CPU (plain versions of the kernel)
against the JAX package's engine on the estimator-only path
(``rerank=False``, ``exact_verify_band=0``), with the chunked segment
path at its defaults and at budgets small enough to force many chunks, and
the configurations the slice does not implement."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.cpu.hostbatch import chunk_ranges
from advanced_scrapper_tpu_torch.pipeline import dedup
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from test_torch_hashing import adversarial_corpus

BASE = dict(rerank=False, exact_verify_band=0.0)


@pytest.fixture(scope="module")
def corpus():
    return adversarial_corpus(np.random.RandomState(11), 96)


def test_config_copy_has_the_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    port = {f.name: f.default for f in dataclasses.fields(DedupConfig)}
    assert port == ref


@pytest.mark.parametrize(
    "overrides",
    [dict(block_len=1024), dict(block_len=4096), dict(block_len=1024, fine_margin=0.05),
     dict(block_len=256, batch_size=64, cand_subbands=0)],
    ids=["1024", "4096", "1024-fine-margin", "256-coarse-only"],
)
def test_engine_matches_reference(corpus, overrides):
    kw = {**BASE, **overrides}
    ref = RefEngine(RefConfig(**kw))
    eng = NearDupEngine(DedupConfig(**kw), device="cpu")
    want_sigs = ref.signatures(corpus)
    got_sigs = eng.signatures(corpus)
    assert got_sigs.dtype == np.uint32 and np.array_equal(got_sigs, want_sigs)
    want = np.asarray(ref.dedup_reps_async(corpus))
    got = eng.dedup_reps_async(corpus)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    reps = eng.dedup_reps(corpus)
    assert np.array_equal(reps, ref.dedup_reps(corpus))
    assert (reps != np.arange(len(corpus))).sum() > 10  # the planted dups merged
    assert np.array_equal(eng.keep(corpus), reps == np.arange(len(corpus)))
    assert eng.last_chunks > 0 and eng.last_h2d_bytes > 0


@pytest.mark.parametrize(
    "chunk_bytes,segment_shingles,join_bytes",
    [(4096, 1024, 4 << 20), (1000, 8, 4 << 20), (64 << 20, 2048, 3000)],
    ids=["4k-chunks", "1k-chunks-8-shingle-segments", "one-chunk-joined-in-pieces"],
)
def test_engine_small_chunks_match_reference(
    corpus, monkeypatch, chunk_bytes, segment_shingles, join_bytes
):
    """Articles longer than a chunk, many chunks, many segments per
    article, a chunk joined in many pieces: still bit-equal to the JAX
    engine, one fold per chunk that holds a shingle."""
    monkeypatch.setattr(dedup, "CHUNK_BYTES", chunk_bytes)
    monkeypatch.setattr(dedup, "SEGMENT_SHINGLES", segment_shingles)
    monkeypatch.setattr(dedup, "JOIN_BYTES", join_bytes)
    ref = RefEngine(RefConfig(**BASE))
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    assert np.array_equal(eng.signatures(corpus), ref.signatures(corpus))
    lens = np.fromiter(map(len, corpus), np.int64, count=len(corpus))
    chunks = [(lo, hi) for lo, hi in chunk_ranges(lens, chunk_bytes)
              if (lens[lo:hi] >= eng.params.shingle_k).any()]
    assert eng.last_chunks == len(chunks)
    text_bytes = sum(int(lens[lo:hi].sum()) for lo, hi in chunks)
    assert text_bytes < eng.last_h2d_bytes < text_bytes + 16 * int(lens.sum())
    got = eng.dedup_reps_async(corpus)
    assert np.array_equal(got.numpy(), np.asarray(ref.dedup_reps_async(corpus)))
    assert np.array_equal(eng.dedup_reps(corpus), ref.dedup_reps(corpus))
    if chunk_bytes == 4096:
        assert eng.last_chunks > 20 and (lens > chunk_bytes).any()


def test_empty_corpus():
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    assert eng.signatures([]).shape == (0, 128)
    assert eng.dedup_reps([]).shape == (0,)
    assert np.array_equal(eng.dedup_reps_async([]).numpy(), np.arange(64))


@pytest.mark.parametrize(
    "overrides",
    [dict(rerank=True), dict(backend="oph"), dict(packed_h2d=False), dict(prewarm=1)],
)
def test_unported_configs_raise(overrides):
    with pytest.raises(NotImplementedError, match="slice"):
        NearDupEngine(DedupConfig(**{**BASE, **overrides}), device="cpu")


def test_unported_methods_raise(corpus):
    eng = NearDupEngine(DedupConfig(rerank=False), device="cpu")
    with pytest.raises(NotImplementedError, match="exact verify"):
        eng.dedup_reps(corpus)
    for call in (
        lambda: eng.dedup_reps_sharded(corpus, None),
        lambda: eng.prewarm_sharded(None),
        lambda: eng.dedup_against_index(corpus, None),
        lambda: eng.open_stream_index("x"),
        lambda: eng.signatures_and_keys(corpus),
        lambda: eng.prewarm(),
    ):
        with pytest.raises(NotImplementedError, match="slice"):
            call()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NearDupEngine(DedupConfig(**BASE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NearDupEngine(DedupConfig(**BASE), device="cuda")
