"""The port's certification oracle (``cpu/oracle.py``) against the JAX
package's: the same seeded corpora byte for byte, the same signatures,
pair sets, clusterings, recall and precision.  numpy only on both sides."""

from __future__ import annotations

import numpy as np
import pytest

from advanced_scrapper_tpu.core.hashing import make_params as ref_make_params
from advanced_scrapper_tpu.cpu import oracle as ref
from advanced_scrapper_tpu.obs import canary as ref_canary
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.cpu import oracle
from advanced_scrapper_tpu_torch.obs import canary
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

PARAMS = make_params()
REF_PARAMS = ref_make_params()


def small_corpus(seed: int, knee_frac: float = 0.4) -> list[bytes]:
    """A certification corpus cut to test size: 24 bases (96 documents),
    two of them long, every length at most 8 kB."""
    return oracle.build_certification_corpus(
        np.random.RandomState(seed), 24, max_len=4000, n_long=2, long_len=8000,
        knee_frac=knee_frac)


@pytest.mark.parametrize("kw", [
    dict(n_bases=24, n_long=2),
    dict(n_bases=12, n_long=0, knee_frac=0.2, min_len=20, max_len=300),
    dict(n_bases=5, n_long=5, long_len=3000, knee_frac=1.0),
], ids=["reference_test_size", "representative_short", "all_long_knee"])
@pytest.mark.parametrize("seed", [31, 101])
def test_certification_corpus_equals_reference(seed, kw):
    kw = dict(kw)
    n = kw.pop("n_bases")
    got = oracle.build_certification_corpus(np.random.RandomState(seed), n, **kw)
    want = ref.build_certification_corpus(np.random.RandomState(seed), n, **kw)
    assert got == want


@pytest.mark.parametrize("target", [0.62, 0.7, 0.8, 0.97, 0.0, 1.0])
def test_mutate_to_jaccard_equals_reference(target):
    base = np.random.RandomState(3).randint(32, 127, size=777, dtype=np.uint8).tobytes()
    got = oracle.mutate_to_jaccard(np.random.RandomState(9), base, target)
    want = ref.mutate_to_jaccard(np.random.RandomState(9), base, target)
    assert got == want and len(got) == len(base)


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_canary_corpus_equals_reference(seed):
    for kw in (dict(), dict(threshold=0.6), dict(families=3, members=2, distractors=1,
                                                 shingle_k=5, tokens=30)):
        got = canary.make_canary_corpus(seed, **kw)
        want = ref_canary.make_canary_corpus(seed, **kw)
        assert got == want
        assert got[1], "a canary corpus plants oracle pairs"


def test_signatures_fast_equal_slow_and_reference():
    texts = oracle.build_certification_corpus(
        np.random.RandomState(5), 6, min_len=40, max_len=600, n_long=1, long_len=900)
    texts += [b"", b"abcd", "héllo wörld, the same shingles", b"abcde"]
    slow = oracle.oracle_signatures(texts, PARAMS)
    fast = oracle.oracle_signatures_fast(texts, PARAMS, chunk=64)
    assert slow.dtype == np.uint64 and np.array_equal(slow, fast)
    assert np.array_equal(fast, ref.oracle_signatures_fast(texts, REF_PARAMS))
    assert np.array_equal(slow, ref.oracle_signatures(texts, REF_PARAMS))
    assert (slow[-3] == int(oracle.MAX_HASH)).all(), "no shingle: the empty signature"
    assert oracle.sha1_hash32(b"abcde") == ref.sha1_hash32(b"abcde")
    assert oracle.band_tuples(slow[0], PARAMS) == ref.band_tuples(slow[0], REF_PARAMS)
    assert np.array_equal(oracle.oracle_dedup_reps(texts, PARAMS, 0.7),
                          ref.oracle_dedup_reps(texts, REF_PARAMS, 0.7))


@pytest.mark.parametrize("knee_frac", [0.4, 0.2])
def test_pairs_reps_recall_precision_equal_reference(knee_frac):
    texts = small_corpus(31, knee_frac)
    pairs = oracle.oracle_near_dup_pairs(texts, PARAMS, 0.7, fast=True)
    assert pairs == ref.oracle_near_dup_pairs(texts, REF_PARAMS, 0.7, fast=True)
    assert len(pairs) > 20
    assert oracle.oracle_candidate_pairs(
        oracle.oracle_signatures_fast(texts, PARAMS), PARAMS) >= pairs
    o_reps = oracle.oracle_reps(texts, PARAMS, 0.7, pairs=pairs)
    assert np.array_equal(o_reps, ref.oracle_reps(texts, REF_PARAMS, 0.7, pairs=pairs))
    # the port's CPU engine's reps, scored by both oracles
    reps = NearDupEngine(DedupConfig(), device="cpu").dedup_reps(texts)
    for r in (reps, o_reps):
        assert oracle.measured_recall(texts, r, PARAMS, 0.7, pairs=pairs) == \
            ref.measured_recall(texts, r, REF_PARAMS, 0.7, pairs=pairs)
        assert oracle.measured_precision(texts, r, 5, 0.7) == \
            ref.measured_precision(texts, r, 5, 0.7)
    recall, n = oracle.measured_recall(texts, reps, PARAMS, 0.7, pairs=pairs)
    assert n == len(pairs) and recall > 0.8
    assert oracle.measured_precision(texts, reps, 5, 0.7)[2] == 0, "an unchained merge"


def test_recall_precision_edges_equal_reference():
    texts = [b"x" * 10, b"y" * 10, b"z" * 3]
    reps = np.array([0, 0, 2])
    assert oracle.measured_recall(texts, reps, PARAMS, 0.7, pairs=set()) == (1.0, 0)
    for r in (reps, np.arange(3)):
        assert oracle.measured_precision(texts, r, 5, 0.7) == ref.measured_precision(
            texts, r, 5, 0.7)
    # a member reachable only through a weak edge is unchained
    assert oracle.measured_precision(texts, reps, 5, 0.7) == (0.0, 1, 1)
