"""The port's OPH backend (``advanced_scrapper_tpu_torch/ops/oph.py`` and
``DedupConfig(backend="oph")``) on the CPU against the JAX package's,
mirroring ``tests/test_oph.py`` at small sizes: raw signatures, densify,
the raw min-combine, empty and sub-shingle rows, the power-of-two check,
recall against the oracle, no false merges, sparse documents, the engine
on both transports with a chunk budget of a few kB, and the stream,
persist, index and CLI paths under ``backend="oph"``.  Exact equality
throughout (the JAX side through jnp: OPH has no Pallas kernel).

Numpy models of the CUDA kernels' walks (``csrc/oph.cu``) are held to the
plain versions: the fold's per-bin scatter-min, its walk (warp ranges,
one flush an owner run, word-assembled shingle bytes, the filtered
minimum; the segment and the tile modes, the latter also against the JAX
package) and densify's filled-mask search; the reader of the fold's SASS
and the variants of ``oph_probe.py`` are checked against the source."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.core.hashing import make_params as ref_make_params
from advanced_scrapper_tpu.core.tokenizer import encode_batch as ref_encode_batch
from advanced_scrapper_tpu.cpu.oracle import jaccard, oracle_near_dup_pairs, shingle_set
from advanced_scrapper_tpu.extractors import tpu_batch as ref_tb
from advanced_scrapper_tpu.index import PersistentIndex as RefIndex
from advanced_scrapper_tpu.ops import oph as ref_oph
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.core.tokenizer import encode_batch
from advanced_scrapper_tpu_torch.cpu.hostbatch import segment_ranges
from advanced_scrapper_tpu_torch.extractors import tpu_batch
from advanced_scrapper_tpu_torch.index import PersistentIndex
from advanced_scrapper_tpu_torch.ops import minhash, oph, oph_cuda
from advanced_scrapper_tpu_torch.ops.pack import pack_tile
from advanced_scrapper_tpu_torch.ops.shingle import U32_MAX, shingle_hash
from advanced_scrapper_tpu_torch.pipeline import dedup
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from test_recall_vs_oracle import PARAMS as REF_PARAMS
from test_recall_vs_oracle import _corpus, _mutate
from test_torch_hashing import adversarial_corpus
from test_torch_stream import run_stream, stream_records

OPH = dict(backend="oph", rerank=False, exact_verify_band=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this module's torch work: the suite runs
    several test processes at once, and each one's thread pool, spinning
    at its barriers, would take the cores the others need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def _t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).view(torch.uint32)


def _params(P: int):
    nb = min(16, P)
    return make_params(num_perm=P, num_bands=nb), ref_make_params(num_perm=P, num_bands=nb)


def _port_raw(tok, ln, params) -> np.ndarray:
    return _u32(oph.oph_raw_signatures(torch.from_numpy(tok), torch.from_numpy(ln), params))


def _port_oph(tok, ln, params) -> np.ndarray:
    return _u32(oph.oph_signatures(torch.from_numpy(tok), torch.from_numpy(ln), params))


def _raw_rows(rng, P: int, rows: int, fill: float) -> np.ndarray:
    """Raw signatures with about ``fill`` of the bins filled, the first row
    all empty and (when there are rows for it) the second one-filled at
    the last bin and the third full."""
    sig = rng.randint(0, 0xFFFFFFFF, size=(rows, P), dtype=np.uint64).astype(np.uint32)
    sig[rng.rand(rows, P) >= fill] = U32_MAX
    sig[0] = U32_MAX
    if rows > 2:
        sig[1] = U32_MAX
        sig[1, P - 1] = 7
        sig[2] = np.arange(P, dtype=np.uint32)
    return sig


@pytest.mark.parametrize("batch,block,P", [(48, 300, 128), (8, 1024, 64), (33, 64, 8),
                                           (1, 128, 128), (16, 200, 256)])
def test_raw_signatures_equal_reference(batch, block, P):
    rng = np.random.RandomState(batch * 7 + block)
    tok = rng.randint(0, 256, size=(batch, block)).astype(np.uint8)
    ln = rng.randint(0, block + 1, size=batch).astype(np.int32)
    ln[0] = 0
    params, ref_params = _params(P)
    want = np.asarray(ref_oph.oph_raw_signatures(tok, ln, ref_params))
    assert np.array_equal(_port_raw(tok, ln, params), want)
    assert np.array_equal(_port_oph(tok, ln, params),
                          np.asarray(ref_oph.oph_signatures(tok, ln, ref_params)))
    assert (want[0] == U32_MAX).all()


@pytest.mark.parametrize("P", [8, 32, 64, 128, 1024])
def test_densify_equals_reference(P):
    rng = np.random.RandomState(P)
    for fill in (0.0, 0.02, 0.3, 0.9, 1.0):
        sig = _raw_rows(rng, P, 24, fill)
        want = np.asarray(ref_oph.densify(sig))
        assert np.array_equal(_u32(oph.densify(_t32(sig))), want), fill
    # the reference's own case: one filled bin, the rest borrow with offset
    one = np.full((1, 8), U32_MAX, np.uint32)
    one[0, 5] = 42
    out = _u32(oph.densify(_t32(one)))
    assert out[0, 5] == 42
    for i in range(8):
        if i != 5:
            assert out[0, i] == np.uint32((42 + ((5 - i) % 8) * oph.DENSIFY_C) & 0xFFFFFFFF)


def test_raw_combine_equals_whole_doc():
    rng = np.random.RandomState(5)
    doc = bytes(rng.randint(32, 127, size=1000, dtype=np.uint8))
    params, ref_params = _params(128)
    k = params.shingle_k
    whole = _port_raw(*encode_batch([doc], block_len=1024), params)[0]
    cut = 504
    parts = _port_raw(*encode_batch([doc[: cut + k - 1], doc[cut:]], block_len=1024), params)
    combined = np.minimum(parts[0], parts[1])
    assert np.array_equal(combined, whole)
    assert np.array_equal(whole, np.asarray(
        ref_oph.oph_raw_signatures(*ref_encode_batch([doc], block_len=1024), ref_params))[0])
    assert np.array_equal(_u32(oph.densify(_t32(combined[None]))),
                          _u32(oph.densify(_t32(whole[None]))))


def test_empty_and_subshingle_rows():
    texts = [b"", b"abc", b"a perfectly normal document body"]
    params, ref_params = _params(128)
    sig = _port_oph(*encode_batch(texts, block_len=64), params)
    assert (sig[0] == U32_MAX).all() and (sig[1] == U32_MAX).all()
    assert (sig[2] != U32_MAX).any()
    assert np.array_equal(sig, np.asarray(
        ref_oph.oph_signatures(*ref_encode_batch(texts, block_len=64), ref_params)))


def test_oph_requires_power_of_two_perms():
    tok, ln = encode_batch([b"some document"], block_len=64)
    bad = make_params(num_perm=96)
    with pytest.raises(ValueError):
        ref_oph.oph_raw_signatures(tok, ln, ref_make_params(num_perm=96))
    with pytest.raises(ValueError, match="power-of-two"):
        oph.oph_raw_signatures(torch.from_numpy(tok), torch.from_numpy(ln), bad)
    with pytest.raises(ValueError, match="power-of-two"):
        minhash.check_backend("oph", 96)
    with pytest.raises(ValueError, match="power-of-two"):
        NearDupEngine(DedupConfig(**OPH, num_perm=96, num_bands=16), device="cpu")
    with pytest.raises(ValueError, match="unknown signature backend"):
        NearDupEngine(DedupConfig(backend="ohp"), device="cpu")


def test_oph_recall_vs_oracle():
    """The port's OPH engine reaches the north-star bar on the reference's
    recall corpus, with the JAX engine's representatives."""
    texts = _corpus()
    oracle_pairs = oracle_near_dup_pairs(texts, REF_PARAMS, threshold=0.7)
    assert len(oracle_pairs) >= 30
    kw = dict(OPH, sim_threshold=0.7, cand_subbands=0, block_len=512)
    rep = NearDupEngine(DedupConfig(**kw), device="cpu").dedup_reps(texts)
    assert np.array_equal(rep, RefEngine(RefConfig(**kw)).dedup_reps(texts))
    params, ref_params = _params(128)
    tok, ln = encode_batch(texts, block_len=512)
    assert np.array_equal(_port_oph(tok, ln, params),
                          np.asarray(ref_oph.oph_signatures(tok, ln, ref_params)))
    recall = sum(1 for i, j in oracle_pairs if rep[i] == rep[j]) / len(oracle_pairs)
    assert recall >= 0.95, f"OPH recall {recall:.3f} < 0.95"


def test_oph_no_false_merges():
    rng = np.random.RandomState(11)
    kw = dict(OPH, sim_threshold=0.7, cand_subbands=0, block_len=512)
    for size, n in ((300, 64), (12, 32)):  # short docs densify heavily
        texts = [bytes(rng.randint(32, 127, size=size, dtype=np.uint8)) for _ in range(n)]
        rep = NearDupEngine(DedupConfig(**kw), device="cpu").dedup_reps(texts)
        assert (rep == np.arange(n)).all()
        assert np.array_equal(rep, RefEngine(RefConfig(**kw)).dedup_reps(texts))


def test_sparse_docs_agreement_not_inflated():
    rng = np.random.RandomState(21)
    shared = bytes(rng.randint(32, 127, size=20, dtype=np.uint8))
    a = shared + bytes(rng.randint(32, 127, size=40, dtype=np.uint8))
    b = shared + bytes(rng.randint(32, 127, size=40, dtype=np.uint8))
    true_j = jaccard(shingle_set(a, 5), shingle_set(b, 5))
    params, ref_params = _params(128)
    tok, ln = encode_batch([a, b], block_len=64)
    sig = _port_oph(tok, ln, params)
    assert np.array_equal(sig, np.asarray(ref_oph.oph_signatures(tok, ln, ref_params)))
    assert float(np.mean(sig[0] == sig[1])) <= true_j + 0.15


@pytest.mark.parametrize("packed_h2d", [True, False], ids=["packed", "unpacked"])
def test_engine_backend_oph(monkeypatch, packed_h2d):
    """The reference's engine case (documents longer than a block, a near
    copy and an exact copy), plus an adversarial corpus through a chunk
    budget of a few kB and segments of 8 shingles: signatures, the
    estimator-only, certified and default representatives, all equal to
    the JAX engine's; one raw fold a chunk (tile on the unpacked
    transport) and the densify after it."""
    rng = np.random.RandomState(9)
    base = bytes(rng.randint(32, 127, size=6000, dtype=np.uint8))
    near = _mutate(rng, base, 10)
    other = bytes(rng.randint(32, 127, size=6000, dtype=np.uint8))
    small = dict(backend="oph", block_len=4096, batch_size=8, packed_h2d=packed_h2d)
    reps = NearDupEngine(DedupConfig(**small), device="cpu").dedup_reps([base, near, other, base])
    assert reps[1] == 0 and reps[3] == 0 and reps[2] == 2
    monkeypatch.setattr(dedup, "CHUNK_BYTES", 4096)
    monkeypatch.setattr(dedup, "SEGMENT_SHINGLES", 8)
    corpus = adversarial_corpus(np.random.RandomState(3), 64)
    for kw in (dict(OPH), dict(backend="oph", rerank=False), dict(backend="oph")):
        kw["packed_h2d"] = packed_h2d
        ref = RefEngine(RefConfig(**kw))
        eng = NearDupEngine(DedupConfig(**kw), device="cpu")
        assert np.array_equal(eng.signatures(corpus), ref.signatures(corpus))
        if packed_h2d:
            assert eng.last_chunks > 10
        got = eng.dedup_reps_async(corpus)
        assert np.array_equal(got.numpy(), np.asarray(ref.dedup_reps_async(corpus)))
        assert np.array_equal(eng.dedup_reps(corpus), ref.dedup_reps(corpus))


def test_engine_oph_under_the_oom_ladder(monkeypatch):
    """Injected OOMs halve OPH chunks as they halve dense ones: the raw
    fold of the halves is the fold of the whole."""
    from advanced_scrapper_tpu_torch.pipeline import dispatch

    monkeypatch.setattr(dedup, "CHUNK_BYTES", 8192)
    monkeypatch.setattr(dedup, "SEGMENT_SHINGLES", 64)
    corpus = adversarial_corpus(np.random.RandomState(4), 48)
    want = RefEngine(RefConfig(**OPH)).signatures(corpus)
    monkeypatch.setenv("ASTPU_CHAOS_DISPATCH_OOM", "3")
    dispatch.reset_chaos_oom()
    try:
        eng = NearDupEngine(DedupConfig(**OPH), device="cpu")
        assert np.array_equal(eng.signatures(corpus), want)
        assert eng.last_halvings == 3
    finally:
        monkeypatch.delenv("ASTPU_CHAOS_DISPATCH_OOM")
        dispatch.reset_chaos_oom()


def test_segment_fold_drops_owners_and_spans_chunks():
    """``oph_fold_segments`` on the CPU: two chunks folded into one
    accumulator, with owners outside the accumulator dropped, densified,
    equal to the JAX engine's OPH signatures of the same articles."""
    rng = np.random.RandomState(8)
    docs = [rng.randint(32, 127, size=n, dtype=np.uint8).tobytes()
            for n in (0, 3, 5, 6, 900, 2049, 4100, 77)]
    params, _ = _params(128)
    running = _t32(np.full((len(docs), 128), U32_MAX, np.uint32))
    for lo, hi in ((0, 5), (5, len(docs))):
        lens = np.array([len(d) for d in docs[lo:hi]], np.int64)
        off = np.concatenate([[0], np.cumsum(lens)[:-1]])
        start, shingles, owner = segment_ranges(off, lens, np.arange(lo, hi), 5, 100)
        owner = owner.copy()
        text = torch.from_numpy(np.frombuffer(b"".join(docs[lo:hi]), np.uint8).copy())
        extra = len(start)
        start = np.concatenate([start, [0]])
        shingles = np.concatenate([shingles, [1]]).astype(np.int32)
        owner = np.concatenate([owner, [len(docs) + 3]]).astype(np.int32)  # dropped
        assert extra and int(shingles[:-1].sum()) > 0
        oph.oph_fold_segments(running, text, torch.from_numpy(start.astype(np.int64)),
                              torch.from_numpy(shingles), torch.from_numpy(owner), params)
    want = RefEngine(RefConfig(**OPH)).signatures(docs)
    assert np.array_equal(_u32(oph.densify(running)), want)


def test_kernel_bin_min_equals_the_sort_form():
    """The fold kernel's walk, modelled in numpy: every valid shingle's
    hash mins into bin ``h >> (32 - log2 P)``.  Equal to the plain sort
    form bit for bit (the minimum of a bin does not depend on how it is
    found)."""
    rng = np.random.RandomState(12)
    tok = rng.randint(0, 256, size=(20, 300)).astype(np.uint8)
    ln = rng.randint(0, 301, size=20).astype(np.int32)
    for P in (2, 64, 128, 1024):
        params, _ = _params(P)
        h, valid = shingle_hash(torch.from_numpy(tok), torch.from_numpy(ln), 5)
        h, valid = h.numpy(), valid.numpy()
        shift = 32 - (P.bit_length() - 1)
        model = np.full((20, P), U32_MAX, np.uint64)
        for r in range(20):
            hv = h[r][valid[r]].astype(np.uint64)
            np.minimum.at(model[r], (hv >> np.uint64(shift)).astype(np.int64), hv)
        assert np.array_equal(model.astype(np.uint32), _port_raw(tok, ln, params)), P


_M32 = np.uint64(0xFFFFFFFF)
_WORD_K = 5  # the shingle width the fold kernel compiles in: it reads words


def _fnv_fmix(b: np.ndarray) -> np.ndarray:
    """FNV-1a over the last axis of bytes ``b``, then fmix32 (uint64 values)."""
    h = np.full(b.shape[:-1], 0x811C9DC5, np.uint64)
    for m in range(b.shape[-1]):
        h = ((h ^ b[..., m].astype(np.uint64)) * np.uint64(0x01000193)) & _M32
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    return h ^ (h >> np.uint64(16))


def _lane_bytes(text: np.ndarray, addr0: int, p: np.ndarray, k: int) -> np.ndarray:
    """The shingle bytes ``[lanes, LANE_SHINGLES, k]`` of lanes starting at
    byte ``p`` of ``text`` (whose address is ``addr0`` mod 16), as
    ``hash_lane`` assembles them: at k = 5 from the aligned 32-bit words
    that cover them (words reaching outside the text read byte by byte,
    zero outside), funnel-shifted by the start's residue mod 4; at any
    other k byte by byte.  Entries of shingles past a lane's valid ones
    are don't-cares."""
    lanes = oph_cuda.LANE_SHINGLES
    j = np.arange(lanes)[:, None] + np.arange(k)[None, :]  # stream position of (shingle, byte)
    if k != _WORD_K:
        return text[np.clip(p[:, None, None] + j[None], 0, len(text) - 1)]
    n_words = lanes // 4 + (k + 5) // 4
    a = ((addr0 + p) & 3).astype(np.uint64)
    idx = (p - (addr0 + p) % 4)[:, None] + np.arange(4 * n_words)[None, :]
    inside = (idx >= 0) & (idx < len(text))
    byte = np.where(inside, text[np.clip(idx, 0, len(text) - 1)], 0).astype(np.uint64)
    w = (byte.reshape(len(p), n_words, 4) << (np.uint64(8) * np.arange(4, dtype=np.uint64))
         ).sum(-1)  # little-endian words
    s = (((w[:, 1:] << np.uint64(32)) | w[:, :-1]) >> (np.uint64(8) * a[:, None])) & _M32
    sel = np.uint64(8) * (j & 3).astype(np.uint64)
    return ((s[:, j >> 2] >> sel) & np.uint64(0xFF)).astype(np.uint8)


def _span(count: int, fit: int) -> int:
    """Units a warp's range holds (``launch_k``): at most
    ``RANGES_PER_WARP`` ranges per resident warp of ``fit``."""
    return -(-count // min(count, fit * oph_cuda.RANGES_PER_WARP))


def _fold_walk(running: np.ndarray, text: np.ndarray, addr0: int, units: list, k: int,
               fit: int, filtered: bool = False) -> dict:
    """``oph_fold_kernel``'s walk over ``units`` ``(off, n, owner)``, in
    place on ``running uint64[N, P]``: a warp a range of ``_span`` units,
    one table kept across consecutive units of one owner and flushed
    (min into the owner's row) when the owner changes and at the range's
    end; owners outside ``[0, N)`` dropped.  A unit runs in whole warp
    iterations of ``32 · LANE_SHINGLES`` shingles, lane ``l`` hashing
    ``LANE_SHINGLES`` consecutive ones, each hash taking the shared min;
    ``filtered`` (``oph_probe.py``'s variant) only when below the bin it
    read, every lane reading before any lane's atomic (the stalest the
    table can be).  Returns the flushes, the shared atomics and the owners
    whose units span two ranges."""
    n_out, P = running.shape
    shift = np.uint64(32 - (P.bit_length() - 1))
    lanes = oph_cuda.LANE_SHINGLES
    run = 32 * lanes
    lane = np.arange(32)
    span = _span(len(units), fit)
    flushes = atomics = 0
    first_range: dict[int, int] = {}
    split: set[int] = set()
    for r, lo in enumerate(range(0, len(units), span)):
        table = np.full(P, U32_MAX, np.uint64)
        owner = -1
        for off, n, own in [*units[lo:lo + span], (0, 1, -2)]:  # -2: the range's end
            if own != -2 and (n <= 0 or not 0 <= own < n_out):
                continue
            if own != owner:
                if owner >= 0:
                    running[owner] = np.minimum(running[owner], table)
                    table[:] = U32_MAX
                    flushes += 1
                owner = own
                if own == -2:
                    break
                split.update([own] if first_range.setdefault(own, r) != r else [])
            for i in range(0, n, run):
                p = off + i + lanes * lane
                valid = np.clip(n - i - lanes * lane, 0, lanes)
                h = _fnv_fmix(_lane_bytes(text, addr0, p, k))
                h = h[np.arange(lanes)[None, :] < valid[:, None]]
                b = (h >> shift).astype(np.int64)
                hit = h < table[b] if filtered else np.ones(len(h), bool)
                np.minimum.at(table, b[hit], h[hit])
                atomics += int(hit.sum())
    return {"flushes": flushes, "atomics": atomics, "split_owners": split}


def _segment_units(text_len: int, start, shingles, owner, k: int) -> list:
    """``SegmentUnits.get`` of every descriptor: one outside the text
    yields no shingle."""
    return [(int(s), int(n) if s >= 0 and n <= oph_cuda.MAX_SEGMENT_SHINGLES
             and s + n + k - 1 <= text_len else 0, int(o))
            for s, n, o in zip(start, shingles, owner)]


def _tile_units(lens: np.ndarray, owners: np.ndarray, width: int, k: int, fit: int) -> list:
    """``TileUnits.plan`` and ``get``: each row cut into pieces of the
    planned size, row-major."""
    most = max(width - k + 1, 1)
    run = 32 * oph_cuda.LANE_SHINGLES
    piece = max(len(lens) * most // fit, oph_cuda.MIN_TILE_PIECE)
    piece = min(-(-piece // run) * run, oph_cuda.MAX_SEGMENT_SHINGLES)
    units = []
    for row, (ln, own) in enumerate(zip(lens, owners)):
        ln = min(max(int(ln), 0), width)
        for s0 in range(0, most, piece):
            units.append((row * width + s0, max(min(piece, ln - (k - 1) - s0), 0), int(own)))
    return units


@pytest.mark.parametrize("fit", [3, 40], ids=["fit3", "fit40"])
@pytest.mark.parametrize("P", [2, 8, 128, 1024])
@pytest.mark.parametrize("k", [1, 5, 9])
def test_kernel_fold_walk_equals_the_plain_and_reference_folds(k, P, fit):
    """The segment mode's walk (:func:`_fold_walk`) on articles of edge
    lengths among random ones, one 64× longer than the rest and last in
    a text that ends at its last shingle, cut into segments of 40
    shingles, with descriptors of 0 shingles and out-of-range owners
    interleaved, shared owners, ranges that cut articles, lane starts at
    every residue mod 16, the shared min filtered or not: equal to the
    plain segment fold and to the JAX package's raw OPH signatures
    min-combined by owner, from an accumulator that starts part filled."""
    rng = np.random.RandomState(1000 * k + P + fit)
    params = make_params(num_perm=P, num_bands=min(16, P), shingle_k=k)
    ref_params = ref_make_params(num_perm=P, num_bands=min(16, P), shingle_k=k)
    lens = np.r_[[0, 1, k - 1, k, k + 1, 40 + k - 1, 40 + k, 255 + k, 257 + k],
                 rng.randint(0, 160, size=40)]
    rng.shuffle(lens)
    lens = np.r_[lens, 64 * 150]  # the long one, last
    docs = [rng.randint(0, 256, size=int(n), dtype=np.uint8) for n in lens]
    n_out = 12
    doc_owner = rng.randint(0, n_out, size=len(docs))
    doc_owner[1::4] = rng.choice([-1, n_out, n_out + 7], size=len(doc_owner[1::4]))
    doc_owner[-1] = 3
    text = np.concatenate(docs)
    off = np.r_[0, np.cumsum(lens)[:-1]].astype(np.int64)
    start, shingles, owner = segment_ranges(off, lens, doc_owner, k, 40)
    zeros = rng.randint(0, len(start), size=5)  # descriptors of 0 shingles
    start = np.insert(start, zeros, rng.randint(0, len(text) - k, size=5))
    shingles = np.insert(shingles, zeros, 0).astype(np.int32)
    owner = np.insert(owner, zeros, rng.randint(0, n_out, size=5)).astype(np.int32)
    assert start[-1] + shingles[-1] + k - 1 == len(text)  # ends at its last shingle
    begin = _raw_rows(rng, P, n_out, 0.2).astype(np.uint64)

    units = _segment_units(len(text), start, shingles, owner, k)
    for addr0, filtered in ((5, True), (0, False)):  # the text's address mod 16
        model = begin.copy()
        walk = _fold_walk(model, text, addr0, units, k, fit, filtered)
        starts = (addr0 + np.concatenate([
            s + np.arange(0, n, oph_cuda.LANE_SHINGLES) for s, n in zip(start, shingles)]))
        assert set((starts % 16).tolist()) == set(range(16))
        assert walk["split_owners"], "no owner's units span two ranges"
        if filtered:
            assert 0 < walk["atomics"] < int(shingles.sum())
            filtered_model = model
    assert np.array_equal(model, filtered_model)

    running = _t32(begin.astype(np.uint32))
    oph.oph_fold_segments(running, torch.from_numpy(text), torch.from_numpy(start),
                          torch.from_numpy(shingles), torch.from_numpy(owner), params)
    assert np.array_equal(model.astype(np.uint32), _u32(running))

    tok = np.zeros((len(docs), int(lens.max())), np.uint8)
    for i, d in enumerate(docs):
        tok[i, :len(d)] = d
    raw = np.asarray(ref_oph.oph_raw_signatures(tok, lens.astype(np.int32), ref_params))
    want = begin.astype(np.uint32)
    for i, o in enumerate(doc_owner):
        if 0 <= o < n_out:
            want[o] = np.minimum(want[o], raw[i])
    assert np.array_equal(model.astype(np.uint32), want)


@pytest.mark.parametrize("fit", [64, 2000], ids=["fit64", "fit2000"])
@pytest.mark.parametrize("P", [2, 128, 1024])
@pytest.mark.parametrize("width,k", [(4096, 5), (512, 9), (64, 5)])
def test_kernel_tile_walk_equals_the_plain_and_reference_tiles(width, k, P, fit):
    """The tile modes' walk: a 64-row tile (the chunker's tail tiles) of
    rows empty, below k, full and random, cut into pieces planned for
    ``fit`` resident warps.  As ``oph_sig`` (owner = row) equal to the
    plain and the JAX package's raw signatures; as ``oph_fold`` (owners
    shared by runs of rows) equal to the plain tile step."""
    rng = np.random.RandomState(width + 10 * k + P + fit)
    params = make_params(num_perm=P, num_bands=min(16, P), shingle_k=k)
    ref_params = ref_make_params(num_perm=P, num_bands=min(16, P), shingle_k=k)
    rows = 64
    tok = rng.randint(0, 256, size=(rows, width)).astype(np.uint8)
    lens = rng.randint(0, width + 1, size=rows).astype(np.int32)
    lens[:4] = [0, k - 1, width, k]
    lens[-1] = width  # the tile's last byte is a shingle's
    flat = tok.ravel()

    sig = np.full((rows, P), U32_MAX, np.uint64)
    units = _tile_units(lens, np.arange(rows), width, k, fit)
    _fold_walk(sig, flat, 3, units, k, fit)
    assert np.array_equal(sig.astype(np.uint32), _port_raw(tok, lens, params))
    assert np.array_equal(sig.astype(np.uint32),
                          np.asarray(ref_oph.oph_raw_signatures(tok, lens, ref_params)))

    owners = np.repeat(np.arange(rows // 4), 4).astype(np.int32)
    owners[5] = rows  # dropped
    begin = _raw_rows(rng, P, rows // 4, 0.2).astype(np.uint64)
    folded = begin.copy()
    _fold_walk(folded, flat, 0, _tile_units(lens, owners, width, k, fit), k, fit)
    running = _t32(begin.astype(np.uint32))
    oph.oph_fused_tile_step_plain(running, torch.from_numpy(pack_tile(tok, lens, owners)),
                                  rows=rows, width=width, params=params)
    assert np.array_equal(folded.astype(np.uint32), _u32(running))


OPH_SASS = """
        Function : _ZN12_GLOBAL__N_115oph_fold_kernelINS_9TileUnitsELi5EEEvPKhlT_liiiPji
.L_x_9:
        /*0000*/                   LDS R2, [R3] ;
        /*0010*/                   LDG.E R4, desc[UR4][R6.64] ;
        /*0020*/                   BRA 0x0 ;
        Function : _ZN12_GLOBAL__N_115oph_fold_kernelINS_12SegmentUnitsELi5EEEvPKhlT_liiiPji
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LDG.E R4, desc[UR4][R6.64] ;
        /*0020*/                   SHF.R.W.U32 R5, R4, R8, R9 ;
        /*0030*/                   LOP3.LUT R10, R5, 0xff, R11, 0x6a, !PT ;
        /*0040*/                   IMAD R10, R10, R12, RZ ;
        /*0050*/                   PRMT R13, R5, 0x7771, RZ ;
        /*0060*/                   LDS R14, [R15] ;
        /*0070*/                   ISETP.GE.U32.AND P0, PT, R10, R14, PT ;
        /*0080*/              @!P0 ATOMS.MIN R14, [R15], R10 ;
        /*0090*/                   LDS R16, [R17] ;
        /*00a0*/                   ISETP.GE.U32.AND P1, PT, R13, R16, PT ;
        /*00b0*/              @!P1 ATOMS.MIN R16, [R17], R13 ;
        /*00c0*/               @P2 BRA `(.L_x_1) ;
.L_x_2:
        /*00d0*/                   LDS R2, [R3] ;
        /*00e0*/                   RED.E.MIN.STRONG.GPU desc[UR4][R6.64], R2 ;
        /*00f0*/                   STS [R3], R18 ;
        /*0100*/                   BRA 0xd0 ;
        /*0110*/                   EXIT ;
"""


def test_sass_reads_the_fold_hash_loop():
    """The OPH fold's hash loop in the named mode's k = 5 kernel, per
    shingle (a filtered read of its bin: LDS), not the flush loop (no
    global load); a design without the read counts its shared atomics."""
    from advanced_scrapper_tpu_torch.ops import sass

    got = sass.oph_loop(sass.parse_sass(OPH_SASS, "SegmentUnitsELi5E"))
    assert got["steps_in_loop"] == 2 and got["instructions_in_loop"] == 12
    assert got["by_pipe_per_step"] == {"alu": 2.5, "fma": 0.5, "mio": 2.5, "other": 0.5}
    unfiltered = OPH_SASS.replace("LDS R14", "MOV R14").replace("LDS R16", "MOV R16")
    got = sass.oph_loop(sass.parse_sass(unfiltered, "SegmentUnitsELi5E"))
    assert got["steps_in_loop"] == 2 and got["by_opcode_per_step"]["ATOMS"] == 1.0
    assert sass.oph_loop(sass.parse_sass(OPH_SASS, "TileUnitsELi5E"))["steps_in_loop"] == 1


def test_probe_variants_apply_to_the_fold_source():
    """``oph_probe.py``'s variants and cuts each apply to ``csrc/oph.cu``
    once and set 4, 8 and 16 shingles a lane, 1, 4, 8 and 16 ranges a
    warp, pieces of 256, 1,024 and 2,048 shingles; the C getters the
    wrappers check name the walk's constants."""
    import myers_probe
    import oph_probe

    src = (myers_probe._build.CSRC_DIR / "oph.cu").read_text()
    seen = {"lane": set(), "ranges": set(), "piece": set()}
    for name, edits in {**oph_probe.VARIANTS, **oph_probe.CUTS}.items():
        out = myers_probe.patched(src, edits)
        assert (out == src) == (name == "shipped")
        for key, const in (("lane", "kLaneShingles"), ("ranges", "kRangesPerWarp"),
                           ("piece", "kMinPiece")):
            seen[key] |= set(re.findall(rf"constexpr int {const} = (\d+);", out))
    assert seen == {"lane": {"4", "8", "16"}, "ranges": {"1", "4", "8", "16"},
                    "piece": {"256", "1024", "2048"}}
    for const, value in (("kLaneShingles", oph_cuda.LANE_SHINGLES),
                         ("kRangesPerWarp", oph_cuda.RANGES_PER_WARP),
                         ("kMinPiece", oph_cuda.MIN_TILE_PIECE),
                         ("kMaxSeg", oph_cuda.MAX_SEGMENT_SHINGLES),
                         ("kMaxBins", oph_cuda.MAX_BINS)):
        assert f"constexpr int {const} = {value};" in src, const


def test_probe_checked_builds_apply_to_both_sources():
    """``oph_probe.py --checked``: the macro goes ahead of ``oph.cu`` and
    ``minhash.cu`` once each, both sources test their loads only under it
    (``ASTT_CHECK`` is empty without it), and the control's failing test
    replaces the unguarded word load's test in ``oph.cu``."""
    import myers_probe
    import oph_probe

    for source in ("oph", "minhash"):
        src = (myers_probe._build.CSRC_DIR / f"{source}.cu").read_text()
        out = myers_probe.patched(src, oph_probe.CHECKED)
        assert out.startswith(src[: src.index("#include <cstdint>")])
        assert "#define ASTT_CHECK_BOUNDS 1\n#include <cstdint>" in out
        assert "#ifdef ASTT_CHECK_BOUNDS" in src and src.count("ASTT_CHECK(") >= 3
        assert "__trap()" in src.split("#else")[0]
    src = (myers_probe._build.CSRC_DIR / "oph.cu").read_text()
    control = myers_probe.patched(src, oph_probe.CONTROL)
    assert "ASTT_CHECK(base + 4 * i + 4 <= lo);" in control


def _densify_walk(sig: np.ndarray) -> np.ndarray:
    """``oph_densify``'s walk, modelled in numpy: the filled mask as words
    of 32 bins (a ``__ballot_sync`` each), and for each empty bin the
    nearest filled bin to its right by find-first-set over the words,
    wrapping once (``next_filled`` in ``csrc/oph.cu``)."""
    rows, bins = sig.shape
    words = (bins + 31) // 32
    out = sig.copy()
    for r in range(rows):
        masks = [0] * words
        for b in range(bins):
            if sig[r, b] != U32_MAX:
                masks[b >> 5] |= 1 << (b & 31)
        for b in range(bins):
            if sig[r, b] != U32_MAX:
                continue
            q, lane = b >> 5, b & 31
            above = 0 if lane == 31 else masks[q] & ((0xFFFFFFFF << (lane + 1)) & 0xFFFFFFFF)
            d = 0
            if above:
                d = 32 * q + (above & -above).bit_length() - 1 - b
            else:
                for t in range(1, words + 1):
                    qq = (q + t) % words
                    if masks[qq]:
                        w = masks[qq]
                        d = (32 * qq + (w & -w).bit_length() - 1 - b + bins) % bins
                        break
            if d:
                v = int(sig[r, (b + d) % bins])
                out[r, b] = (v + d * oph.DENSIFY_C) & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("P", [2, 8, 64, 128])
def test_kernel_densify_walk_equals_the_plain_version(P):
    rng = np.random.RandomState(100 + P)
    for fill in (0.0, 0.05, 0.5, 1.0):
        sig = _raw_rows(rng, P, 12, fill)
        assert np.array_equal(_densify_walk(sig), _u32(oph.densify_plain(_t32(sig)))), fill


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    tok = torch.zeros((4, 128), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    running = torch.zeros((4, 128), dtype=torch.uint32)
    with pytest.raises(ValueError, match="CUDA tensors"):  # no fallback to plain
        oph_cuda.oph_sig(tok, lens, 128, 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        oph_cuda.oph_densify(running)
    with pytest.raises(ValueError, match="CUDA tensors"):
        oph_cuda.oph_fold(running, torch.zeros(4 * 136, dtype=torch.uint8), rows=4,
                          width=128, k=5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        oph_cuda.oph_fold_segments(running, torch.zeros(16, dtype=torch.uint8),
                                   torch.zeros(1, dtype=torch.int64),
                                   torch.ones(1, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32), 5)
    for bins in (1, 96, 2048):
        with pytest.raises(ValueError, match="power-of-two bin count"):
            oph_cuda.check_bins(bins)
    assert oph_cuda.oph_sig.launches == oph_cuda.oph_densify.launches == 0


# -- the stream, persist, index and CLI paths -----------------------------------


@pytest.fixture(scope="module")
def records():
    return stream_records(23, n=256)


@pytest.mark.parametrize("mode", ["exact", "bloom"])
def test_stream_backend_oph_equals_reference(records, mode):
    over = dict(backend="oph", batch_size=64, bloom_bits=1 << 14, stream_index=mode)
    ref = ref_tb.TpuBatchBackend(RefConfig(**over))
    port = tpu_batch.TpuBatchBackend(DedupConfig(**over), device="cpu")
    got = run_stream(port, records)
    assert got == run_stream(ref, records)
    assert sum(1 for a in got if a[2] is not None) > 10


def test_signatures_and_keys_oph_equal_reference(records):
    texts = [r["article"] for r in records[:130]]
    ref = RefEngine(RefConfig(**OPH))
    eng = NearDupEngine(DedupConfig(**OPH), device="cpu")
    for wide in (False, True):
        want = ref.signatures_and_keys(texts, wide=wide)
        got = eng.signatures_and_keys(texts, wide=wide)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_persist_backend_and_index_oph_equal_reference(tmp_path, records):
    over = dict(backend="oph", batch_size=64, stream_index="persist",
                index_cut_postings=300, index_compact_segments=3)
    out = []
    for name, make, cfg, kw in (("jax", ref_tb.TpuBatchBackend, RefConfig, {}),
                                ("port", tpu_batch.TpuBatchBackend, DedupConfig,
                                 {"device": "cpu"})):
        b = make(cfg(**over), index_dir=str(tmp_path / name), **kw)
        b._pindex.compact_inline = b._pindex_urls.compact_inline = True
        out.append((run_stream(b, records), b._pindex.stats()))
        b.close()
    assert out[0] == out[1]
    texts = [r["article"] for r in records]
    got = []
    for name, eng, make_index in (
        ("jax", RefEngine(RefConfig(**OPH)), RefIndex),
        ("port", NearDupEngine(DedupConfig(**OPH), device="cpu"), PersistentIndex),
    ):
        idx = make_index(str(tmp_path / f"ix-{name}"))
        got.append((eng.dedup_against_index(texts[:150], idx).tolist(),
                    eng.dedup_against_index(texts[150:] + [texts[3]], idx).tolist()))
        idx.close()
    assert got[0] == got[1] and any(a >= 0 for a in got[1][1])


@pytest.mark.parametrize("mode", [[], ["--stream"]], ids=["whole", "stream"])
def test_cli_dedup_backend_oph_byte_equal(tmp_path, capsys, mode):
    from test_torch_cli import corpus, run_both_to

    corpus(tmp_path / "in.txt")
    argv = ["dedup", str(tmp_path / "in.txt"), "--backend", "oph", *mode, "-o"]
    want, got = run_both_to(argv, tmp_path, capsys)
    assert got == want and got[0] == 0
    a, b = (tmp_path / "ref.txt").read_bytes(), (tmp_path / "port.txt").read_bytes()
    assert a == b and 0 < a.count(b"\n") < 240
