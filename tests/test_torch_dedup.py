"""The port's ``NearDupEngine`` on the CPU (plain versions of the kernels)
against the JAX package's engine: the estimator-only path
(``rerank=False``, ``exact_verify_band=0``), with the chunked segment
path at its defaults and at budgets small enough to force many chunks; the
default configuration (the rerank tier, exact verify at 0.72) and the
certified exact-verify path; and what the port does not implement yet."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.cpu.oracle import build_certification_corpus
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.cpu.hostbatch import chunk_ranges
from advanced_scrapper_tpu_torch.pipeline import dedup
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from advanced_scrapper_tpu_torch.pipeline.clock import StageClock
from test_rerank_dispatch import _dup_corpus
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
    [dict(backend="oph", rerank=True, prewarm=4096), dict(backend="oph"),
     dict(backend="oph", packed_h2d=False), dict(backend="oph", prewarm=1)],
)
def test_unported_configs_raise(corpus, overrides):
    """Once a pin of the raise of ``backend="oph"``; the OPH backend is
    ported, so on the same configurations (either transport, with or
    without prewarm, with the rerank tier) the engine now equals the JAX
    package's: signatures, the estimator-only and the certified
    representatives.  Prewarm is one warm ``oph_fold_segments`` and one
    ``oph_densify`` launch (plus the tier's)."""
    kw = {**BASE, **overrides}
    ref = RefEngine(RefConfig(**kw))
    eng = NearDupEngine(DedupConfig(**kw), device="cpu")
    if kw.get("prewarm"):
        assert eng.prewarm_launches == (3 if kw["rerank"] else 2)
    assert np.array_equal(eng.signatures(corpus), ref.signatures(corpus))
    got = eng.dedup_reps_async(corpus)
    assert np.array_equal(got.numpy(), np.asarray(ref.dedup_reps_async(corpus)))
    reps = eng.dedup_reps(corpus)
    assert np.array_equal(reps, ref.dedup_reps(corpus))
    assert (reps != np.arange(len(corpus))).sum() > 10  # the planted dups merged


def test_unported_methods_raise(corpus, tmp_path):
    """The sharded methods once raised naming their slice; they are ported
    now: on a CPU mesh ``dedup_reps_sharded`` equals the one-device
    estimator-only representatives, ``prewarm_sharded`` makes one fold a
    shard, and ``dedup_against_index(mesh=...)`` attributes as the
    one-device call.  The fleet's ``reshard_to`` is ported too: without a
    spill directory (the migration WAL's home) it refuses as the
    reference's does."""
    from advanced_scrapper_tpu_torch.core.mesh import build_mesh
    from advanced_scrapper_tpu_torch.index import PersistentIndex
    from advanced_scrapper_tpu_torch.index.fleet import ShardedIndexClient

    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    mesh = build_mesh(4, 2, devices=["cpu"] * 8)
    want = eng.dedup_reps_async(corpus)[: len(corpus)].numpy()
    assert np.array_equal(eng.dedup_reps_sharded(corpus, mesh), want)
    assert eng.prewarm_sharded(mesh) == 8
    got = []
    for name, m in (("mesh", mesh), ("one", None)):
        idx = PersistentIndex(str(tmp_path / name))
        try:
            got.append(eng.dedup_against_index(corpus, idx, mesh=m).tolist())
        finally:
            idx.close()
    assert got[0] == got[1]
    client = ShardedIndexClient("127.0.0.1:9")  # opens no connection
    try:
        with pytest.raises(RuntimeError, match="spill_dir"):
            client.reshard_to("127.0.0.1:9;127.0.0.1:10")
    finally:
        client.close()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NearDupEngine(DedupConfig(**BASE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NearDupEngine(DedupConfig(**BASE), device="cuda")


# -- the default configuration: the rerank tier, exact verify at 0.72 ---------

#: tier stats both packages keep (the reference's ``tiles`` and the port's
#: ``launches`` count different things; ``h2d_bytes`` differs by design)
TIER_KEYS = (
    "pairs", "borderline", "exact_checks", "reprobes", "evicted", "clusters",
    "dropped_cells", "predicted_precision", "capped_buckets", "overflow_pairs",
)


def _assert_default_engine_matches(docs, **overrides):
    """``dedup_reps``, ``dedup_reps_async``, ``keep`` and the tier's
    stats, provenance and evictions of the port's default engine on the
    CPU equal the JAX engine's; returns the tier's stats."""
    ref = RefEngine(RefConfig(**overrides))
    eng = NearDupEngine(DedupConfig(**overrides), device="cpu")
    assert eng.rerank_hook is eng.rerank_tier is not None
    reps = eng.dedup_reps(docs)
    assert reps.dtype == np.int32
    assert np.array_equal(reps, ref.dedup_reps(docs))
    tier, ref_tier = eng.rerank_tier, ref.rerank_tier
    stats = tier.stats
    assert {k: stats[k] for k in TIER_KEYS} == {k: ref_tier.stats[k] for k in TIER_KEYS}
    assert stats["launches"] == stats["h2d_bytes"] == 0  # the plain settle ran
    assert tier.last_provenance == ref_tier.last_provenance
    assert tier.last_evicted == ref_tier.last_evicted
    assert tier.last_participants == ref_tier.last_participants
    got = eng.dedup_reps_async(docs)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref.dedup_reps_async(docs)))
    assert np.array_equal(eng.keep(docs), ref.keep(docs))
    assert (reps != np.arange(len(docs))).sum() > 10
    return stats


@pytest.mark.parametrize("sketch", [256, 1024])
def test_default_engine_matches_reference_on_dup_corpus(sketch):
    """``tests/test_rerank_dispatch.py``'s dup corpus and small config,
    at its sketch of 256 and at the default 1,024."""
    docs = _dup_corpus(np.random.RandomState(5))
    stats = _assert_default_engine_matches(
        docs, rerank_tile_rows=64, rerank_sketch=sketch, batch_size=256
    )
    assert stats["pairs"] > 100 and stats["clusters"] > 10


def test_default_engine_without_pairs():
    """No candidate pair: the tier settles nothing, launches nothing and
    rewrites an all-self matrix; an empty corpus still resolves."""
    rng = np.random.RandomState(0)
    docs = [rng.randint(32, 127, size=rng.randint(1, 600), dtype=np.uint8).tobytes()
            for _ in range(50)]
    ref = RefEngine(RefConfig())
    eng = NearDupEngine(DedupConfig(), device="cpu")
    assert np.array_equal(eng.dedup_reps(docs), ref.dedup_reps(docs))
    assert np.array_equal(eng.dedup_reps(docs), np.arange(len(docs)))
    assert eng.rerank_tier.stats["pairs"] == eng.rerank_tier.stats["launches"] == 0
    assert eng.dedup_reps([]).shape == (0,)
    assert np.array_equal(eng.dedup_reps_async([]).numpy(), np.asarray(ref.dedup_reps_async([])))


@pytest.fixture(scope="module")
def knee_corpus():
    """A small certification corpus with 40% of its planted pairs across
    the Jaccard knee, so borderline pairs and exact checks occur."""
    return build_certification_corpus(
        np.random.RandomState(1), 60, min_len=100, max_len=3000, n_long=0,
        knee_frac=0.4,
    )


def test_default_engine_matches_reference_at_the_knee(knee_corpus):
    stats = _assert_default_engine_matches(knee_corpus)
    assert stats["borderline"] > 0 and stats["exact_checks"] > 0


@pytest.mark.parametrize("cap", [8192, 1])
def test_exact_verify_matches_reference(knee_corpus, cap):
    """The certified path without the tier: exact verify at 0.72, and past
    a cap of one exact check the estimator at the strict bar."""
    kw = dict(rerank=False, exact_verify_cap=cap)
    ref = RefEngine(RefConfig(**kw))
    eng = NearDupEngine(DedupConfig(**kw), device="cpu")
    assert eng.rerank_hook is None
    reps = eng.dedup_reps(knee_corpus)
    assert np.array_equal(reps, ref.dedup_reps(knee_corpus))
    assert 0 < eng.last_exact_checks <= cap
    assert np.array_equal(eng.keep(knee_corpus), reps == np.arange(len(reps)))


@pytest.mark.parametrize("fine_margin", [0.0, 0.05])
def test_passthrough_hook_matches_reference(knee_corpus, fine_margin):
    """A hook that is not authoritative (here one that returns the matrix
    as it came): the hooked async path resolves by signature agreement,
    with the fine-only bars when ``fine_margin`` is set, and the one-shot
    path runs exact verify after it."""

    def passthrough(raw, sigs, rep_bands, valid):
        return np.asarray(rep_bands)

    kw = dict(rerank=False, fine_margin=fine_margin)
    ref = RefEngine(RefConfig(**kw))
    eng = NearDupEngine(DedupConfig(**kw), device="cpu")
    ref.rerank_hook = eng.rerank_hook = passthrough
    got = eng.dedup_reps_async(knee_corpus)
    assert np.array_equal(got.numpy(), np.asarray(ref.dedup_reps_async(knee_corpus)))
    assert not eng._rerank_applied
    assert np.array_equal(eng.dedup_reps(knee_corpus), ref.dedup_reps(knee_corpus))
    assert eng.last_exact_checks > 0 and eng.last_clock.seconds["hook"] >= 0


def test_stage_clock_laps_every_stage(knee_corpus):
    """The default engine's and the tier's last corpus keep host-clock
    seconds per stage; off the card they record no device time."""
    eng = NearDupEngine(DedupConfig(), device="cpu")
    eng.dedup_reps(knee_corpus)
    assert list(eng.last_clock.seconds) == [
        "fold", "candidate_epilogue", "readback", "hook", "writeback", "resolve"
    ]
    tier = eng.rerank_tier
    assert list(tier.last_clock.seconds) == [
        "coarse_pairs", "candidates", "bottom_sketches", "sketch_copy", "settle",
        "finalize", "settle_readback", "margin", "cluster", "evict", "rewrite",
    ]
    seconds = (*eng.last_clock.seconds.values(), *tier.last_clock.seconds.values())
    assert all(v >= 0 for v in seconds)
    assert eng.last_clock.device_ms() == tier.last_clock.device_ms() == {}
    clock = StageClock(torch.device("cpu"))
    for name in ("a", "b", "a"):
        clock.lap(name)
    assert list(clock.seconds) == ["a", "b"] and clock.device_ms() == {}
