"""The port's rerank tier against the JAX package's ``ops.rerank``: the
numpy host half (sketches, candidacy, union-find, recall weight, eviction,
rewrite), the settle's plain versions against the reference's jnp settle
step and finalize, the tier's settle on the CPU, and the settle wrapper's
checks.  Every comparison is exact."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.ops import rerank as ref
from advanced_scrapper_tpu.ops.pack import pack_pair_tile
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.cpu import oracle
from advanced_scrapper_tpu_torch.ops import rerank, rerank_cuda
from advanced_scrapper_tpu_torch.pipeline.clock import StageClock
from advanced_scrapper_tpu_torch.pipeline.rerank import RerankTier


def mutated_texts(rng: np.random.RandomState, n: int, length: int = 300) -> list[bytes]:
    """``tests/test_rerank_dispatch.py``'s settle inputs: ``n`` random
    texts, each followed by a copy with 1-39 byte edits, then two texts
    shorter than a shingle (all-PAD sketches)."""
    texts = []
    for _ in range(n):
        base = bytearray(rng.randint(32, 127, size=length, dtype=np.uint8))
        texts.append(bytes(base))
        mut = bytearray(base)
        for _ in range(rng.randint(1, 40)):
            mut[rng.randint(0, len(mut))] = rng.randint(32, 127)
        texts.append(bytes(mut))
    return texts + [b"xy", b"ab"]


def _u32(sk: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(sk.view(np.int32).copy()).view(torch.uint32)


def _i32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int32))


def _ref_settle(sk: np.ndarray, ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    """The reference's settle step (``make_rerank_tile_step``) over one
    tile of all the pairs, read back from its fold."""
    rows, size = len(ii), sk.shape[1]
    packed = pack_pair_tile(sk[ii], sk[jj], np.arange(rows, dtype=np.int32))
    fold = jax.device_put(np.full(rows, -7, np.int32))
    return np.asarray(ref.make_rerank_tile_step(rows, size)(fold, jax.device_put(packed)))


def _ref_settle_finalize(sk: np.ndarray, ii, jj, lo: int, hi: int) -> np.ndarray:
    """``int32[2, m]``: the reference's settle step, then its finalize."""
    fold, verdict = ref.make_rerank_finalize()(
        jax.device_put(_ref_settle(sk, ii, jj)), np.int32(lo), np.int32(hi)
    )
    return np.stack([np.asarray(fold), np.asarray(verdict).astype(np.int32)])


def _edge_pairs(rng: np.random.RandomState, n: int, m: int):
    """``(ii, jj)``: the settle's edge cases over ``mutated_texts`` rows
    (long texts first, the two all-PAD rows last) — empty ∪ empty,
    ``i == j``, short beside full both ways, empty beside full both ways,
    one row named twice — then ``m`` pairs, half in runs that share ``ia``
    (sorted, as the tier's list), half random."""
    ii = [n - 2, n - 1, 0, 5, 0, n - 3, n - 2, 0, 7, 7]
    jj = [n - 1, n - 1, 0, 5, n - 3, 0, 0, n - 2, 7, 8]
    half = m // 2
    ii = np.r_[ii, np.sort(rng.randint(0, n, half)), rng.randint(0, n, m - half)]
    jj = np.r_[jj, rng.randint(0, n, half), rng.randint(0, n, m - half)]
    return ii, jj


# -- host half ---------------------------------------------------------------


def test_shingle_set_and_jaccard_copies():
    from advanced_scrapper_tpu.cpu import oracle as ref_oracle

    for text in ("", "abcd", "abcde", "ab\udcffcdefgh", b"\xff\xfeabcdef", "naïve text"):
        for k in (1, 5):
            assert oracle.shingle_set(text, k) == ref_oracle.shingle_set(text, k)
    a, b = oracle.shingle_set(b"abcdefgh", 3), oracle.shingle_set(b"abcdxfgh", 3)
    for x, y in ((a, b), (set(), set()), (a, set()), (a, a)):
        assert oracle.jaccard(x, y) == ref_oracle.jaccard(x, y)


@pytest.mark.parametrize("k", [5, 9])
def test_bottom_sketches(k):
    rng = np.random.RandomState(k)
    texts = mutated_texts(rng, 12, 700) + [
        "", "abc", "ab\udcffcdefghij\ud800xyz", "naïve façade " * 30, b"a" * 40,
    ]
    skip = rng.rand(len(texts)) < 0.2
    for size, sk in ((256, None), (37, skip)):
        got = rerank.bottom_sketches(texts, k, size, skip=sk)
        want = ref.bottom_sketches(texts, k, size, skip=sk)
        assert got.dtype == np.uint32 and np.array_equal(got, want), (size, k)
    out = np.zeros((len(texts), 64), np.uint32)
    assert rerank.bottom_sketches(texts, k, 64, skip=skip, out=out) is out
    assert np.array_equal(out, ref.bottom_sketches(texts, k, 64, skip=skip))
    assert (out[skip] == rerank.PAD).all()


def test_sketch_jaccard_and_quantize():
    sk = rerank.bottom_sketches(mutated_texts(np.random.RandomState(2), 10), 5, 128)
    n = len(sk)
    for i in range(n):
        for j in (i, (i + 1) % n, n - 1):
            got = rerank.sketch_jaccard(sk[i], sk[j])
            assert got == ref.sketch_jaccard(sk[i], sk[j])
            assert rerank.quantize(got) == ref.quantize(got)


def _band_sigs(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Signatures whose band slices collide: 70 rows share band 0 (a
    bucket past 64 members), near copies share some bands."""
    sig = rng.randint(0, 1 << 32, size=(n, 128), dtype=np.uint64).astype(np.uint32)
    sig[10:80, :8] = sig[10, :8]
    for i in range(90, n):
        if rng.rand() < 0.4:
            src = rng.randint(0, i)
            keep = rng.rand(16) < 0.5
            sig[i] = np.where(np.repeat(keep, 8), sig[src], sig[i])
    return sig


def test_coarse_pairs_and_signature_agreement():
    rng = np.random.RandomState(4)
    sig = _band_sigs(rng, 200)
    valid = rng.rand(200) > 0.05
    got, capped = rerank.coarse_pairs(sig, valid, 16)
    want, want_capped = ref.coarse_pairs(sig, valid, 16)
    assert got == want and capped == want_capped == 1
    assert rerank.coarse_pairs(sig[:1], valid[:1], 16) == ref.coarse_pairs(sig[:1], valid[:1], 16)
    arr = np.array(sorted(got), np.int64)
    assert np.array_equal(
        rerank.signature_agreement(sig, arr), ref.signature_agreement(sig, arr)
    )
    assert rerank.signature_agreement(sig, arr[:0]).shape == (0,)


def test_union_find_and_rewrite_rep_bands():
    rng = np.random.RandomState(6)
    edges = rng.randint(0, 300, size=(250, 2))
    assert np.array_equal(rerank.union_find(300, edges), ref.union_find(300, edges))
    assert np.array_equal(rerank.union_find(5, []), ref.union_find(5, []))
    # row 40 holds more edges than the matrix has columns: the largest go
    edges = [(40, j) for j in range(30)] + [(a, b) for a, b in edges.tolist() if a != b]
    got, dropped = rerank.rewrite_rep_bands(320, 6, edges)
    want, want_dropped = ref.rewrite_rep_bands(320, 6, edges)
    assert np.array_equal(got, want) and dropped == want_dropped > 0
    assert got.dtype == np.int32


def test_op_weight():
    for jhat in np.linspace(0.0, 1.0, 101).tolist() + [0.6999, 0.7, 0.7001]:
        for lanes in (1, 128):
            for thr in (0.7, 0.5):
                assert rerank.op_weight(jhat, lanes, thr) == ref.op_weight(jhat, lanes, thr)


def _clusters_with_ties():
    """Two clusters whose members tie on the eviction score, with pure-loss
    and recall-carrying bad pairs."""
    clusters = {0: [0, 1, 2, 3, 4], 10: [10, 11, 12, 13], 20: [20, 21]}
    pairinfo = {}
    for r, ms in clusters.items():
        for x in range(len(ms)):
            for y in range(x + 1, len(ms)):
                a, b = ms[x], ms[y]
                bad = (a + b) % 3 == 0
                w = 0.1 if bad and a % 2 else (0.9 if not bad else 0.4)
                pairinfo[(a, b)] = (bad, w)
    return clusters, pairinfo


@pytest.mark.parametrize("target,floor,mass", [
    (0.96, 0.0, 0.0), (0.99, 0.955, 8.0), (0.99, 0.5, 8.0), (0.5, 0.0, 0.0),
])
def test_evict_for_precision(target, floor, mass):
    clusters, pairinfo = _clusters_with_ties()
    got = rerank.evict_for_precision(
        clusters, pairinfo, target, recall_floor=floor, total_op_mass=mass
    )
    want = ref.evict_for_precision(
        clusters, pairinfo, target, recall_floor=floor, total_op_mass=mass
    )
    assert got == want
    if (target, floor) == (0.96, 0.0):
        assert got[0]  # the walk evicted someone


# -- the settle --------------------------------------------------------------


def test_pair_jq_plain_matches_reference_settle():
    """The reference's settle-kernel test inputs: 64 random pairs of 40
    mutated text pairs and the all-PAD pair."""
    rng = np.random.RandomState(41)
    sk = rerank.bottom_sketches(mutated_texts(rng, 40), 5, 256)
    n = len(sk)
    ii = rng.randint(0, n, 64)
    jj = rng.randint(0, n, 64)
    ii[-1], jj[-1] = n - 2, n - 1
    got = rerank.pair_jq_plain(_u32(sk), _i32(ii), _i32(jj))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _ref_settle(sk, ii, jj))
    assert got[-1] == rerank.SCALE
    for s in range(64):
        assert got[s] == rerank.quantize(rerank.sketch_jaccard(sk[ii[s]], sk[jj[s]]))


@pytest.mark.parametrize("size", [1024, 37])
def test_pair_jq_plain_sizes(size, monkeypatch):
    """Documents longer and shorter than ``size`` shingles, ``i == j``
    pairs, a full sketch beside a short one, and several plain batches."""
    monkeypatch.setattr(rerank, "PLAIN_PAIRS", 16)
    rng = np.random.RandomState(size)
    texts = mutated_texts(rng, 10, 2000) + mutated_texts(rng, 10, 30)
    sk = rerank.bottom_sketches(texts, 5, size)
    n = len(sk)
    ii = np.r_[np.arange(n), rng.randint(0, n, 60), 0, n - 1]
    jj = np.r_[np.arange(n), rng.randint(0, n, 60), n - 1, 0]
    got = rerank.pair_jq_plain(_u32(sk), _i32(ii), _i32(jj))
    assert np.array_equal(got.numpy(), _ref_settle(sk, ii, jj))
    assert (got.numpy()[:n] == rerank.SCALE).all()


def test_rerank_finalize():
    jq = torch.tensor([0, 6599, 6600, 7399, 7400, 10000], dtype=torch.int32)
    got = rerank.rerank_finalize(jq, 6600, 7400)
    assert got.dtype == torch.int8
    assert got.tolist() == [0, 0, -1, -1, 1, 1]


@pytest.mark.parametrize("size", [37, 1024])
def test_settle_plain_matches_reference_settle_and_finalize(size):
    """The plain version of the fused kernel, ``pair_jq_plain`` then
    ``rerank_finalize``, against the reference's ``make_rerank_tile_step``
    then ``make_rerank_finalize``, on the edge cases and runs sharing
    ``ia``, at several margin bands."""
    rng = np.random.RandomState(size + 1)
    texts = mutated_texts(rng, 8, 2000) + mutated_texts(rng, 8, 30)
    texts = texts[:-2] + [texts[-3], b"xy", b"ab"]  # short row at n - 3
    sk = rerank.bottom_sketches(texts, 5, size)
    n = len(sk)
    ii, jj = _edge_pairs(rng, n, 60)
    for lo, hi in ((6600, 7400), (0, 0), (5000, 10001)):
        got = rerank.settle_plain(_u32(sk), _i32(ii), _i32(jj), lo, hi)
        assert got.dtype == torch.int32 and got.shape == (2, len(ii))
        assert np.array_equal(got.numpy(), _ref_settle_finalize(sk, ii, jj, lo, hi)), (lo, hi)
    assert (got[0, :4] == rerank.SCALE).all()  # empty ∪ empty and i == j
    assert rerank.settle_plain(_u32(sk), _i32([]), _i32([]), 0, 1).shape == (2, 0)


def test_settle_pairs_takes_the_plain_version_on_the_cpu():
    """On the CPU the tier settles with the plain versions, launches
    nothing and laps its settle stages; the kernel's wrapper refuses CPU
    tensors."""
    sk = rerank.bottom_sketches(mutated_texts(np.random.RandomState(1), 5), 5, 64)
    idx = _i32([[0, 1, 2, 10], [1, 1, 11, 11]])
    tier = RerankTier(DedupConfig(rerank_sketch=64), make_params(), device="cpu")
    clock = StageClock(torch.device("cpu"))
    before = rerank_cuda.rerank_settle.launches
    jq, verdict, h2d = tier._settle_device(torch.from_numpy(sk.view(np.int32)), idx, clock)
    assert rerank_cuda.rerank_settle.launches == before and h2d == 0
    want = rerank.settle_plain(_u32(sk), idx[0], idx[1], 6600, 7400)
    assert np.array_equal(jq, want[0].numpy()) and np.array_equal(verdict, want[1].numpy())
    assert verdict.dtype == np.int8
    assert list(clock.seconds) == ["sketch_copy", "settle", "finalize", "settle_readback"]
    got_sk, got_idx = tier.last_settle_inputs
    assert torch.equal(got_sk, _u32(sk)) and got_idx is idx
    with pytest.raises(ValueError, match="CUDA tensors"):
        rerank_cuda.rerank_settle(_u32(sk), idx[0], idx[1], 64, 6600, 7400)


@pytest.mark.parametrize("case", [
    "dtype-sk", "dtype-idx", "shape-sk", "lengths", "range-hi", "range-lo",
    "band-order", "band-type", "band-int32", "out-dtype", "out-shape", "out-device",
])
def test_settle_rejects_bad_inputs(case):
    """Each check raises before any launch: on the plain version and in
    the wrapper's own check (``check_settle``), which the CPU reaches."""
    sk = _u32(rerank.bottom_sketches([b"abcdefgh", b"abcdefgx"], 5, 16))
    ii, jj = _i32([0, 1]), _i32([1, 0])
    lo, hi, out = 6600, 7400, None
    if case == "band-order":
        lo, err = 7401, ValueError
    elif case == "band-type":
        hi, err = 7400.0, TypeError
    elif case == "band-int32":
        hi, err = 1 << 31, ValueError
    elif case == "out-dtype":
        out, err = torch.zeros((2, 2), dtype=torch.int64), TypeError
    elif case == "out-shape":
        out, err = torch.zeros((2, 3), dtype=torch.int32), ValueError
    elif case == "out-device":
        out, err = torch.zeros((2, 2), dtype=torch.int32, device="meta"), ValueError
    elif case == "dtype-sk":
        sk, err = sk.view(torch.int32).to(torch.int64), TypeError
    elif case == "dtype-idx":
        ii, err = ii.to(torch.int64), TypeError
    elif case == "shape-sk":
        sk, err = sk.reshape(-1), ValueError
    elif case == "lengths":
        jj, err = _i32([1]), ValueError
    elif case == "range-hi":
        jj, err = _i32([1, 2]), ValueError
    else:
        ii, err = _i32([-1, 0]), ValueError
    if out is None:
        with pytest.raises(err):
            rerank.settle_plain(sk, ii, jj, lo, hi)
    with pytest.raises(err):
        rerank_cuda.check_settle(sk, ii, jj, lo, hi, out)
    if not case.startswith(("band", "out")):
        with pytest.raises(err):
            rerank_cuda.check_pairs(sk, ii, jj)


def test_tier_index_and_prewarm_are_not_ported():
    """``index=`` is ported (its re-probe: ``tests/test_torch_persist.py``);
    ``prewarm`` still raises."""
    cfg, params = DedupConfig(), make_params()
    marker = object()
    assert RerankTier(cfg, params, index=marker, device="cpu").index is marker
    with pytest.raises(NotImplementedError, match="slice"):
        RerankTier(cfg, params, device="cpu").prewarm()
