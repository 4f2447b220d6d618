"""The port's plain MinHash versions against the JAX package: shingle
hashes, signatures (the XLA scan path and the Pallas kernel in interpret
mode), the packed tile step, the block combine and the segment fold.  All
exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.core.hashing import make_params as ref_make_params
from advanced_scrapper_tpu.ops import minhash as ref_minhash
from advanced_scrapper_tpu.ops import pack as ref_pack
from advanced_scrapper_tpu.ops.pallas_minhash import minhash_signatures_pallas
from advanced_scrapper_tpu.ops.shingle import shingle_hash as ref_shingle_hash
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu_torch.convert import accumulator_from_numpy
from advanced_scrapper_tpu_torch.core.hashing import fmix32_np, make_params
from advanced_scrapper_tpu_torch.cpu.hostbatch import segment_ranges
from advanced_scrapper_tpu_torch.ops import minhash, minhash_cuda, minhash_probe
from advanced_scrapper_tpu_torch.ops.pack import pack_tile, unpack_tile
from advanced_scrapper_tpu_torch.ops.shingle import fmix32, shingle_hash, to_u32, u32_values
from test_torch_hashing import adversarial_corpus

EDGE_LENGTHS = [0, 1, 4, 5, 6, 4095, 4096, 4097, 8191, 8192, 8193, 30000]


@pytest.fixture(scope="module")
def params():
    return make_params()


@pytest.fixture(scope="module")
def ref_params():
    return ref_make_params()


def _rows(rng, batch, block):
    tok = rng.randint(0, 256, size=(batch, block)).astype(np.uint8)
    lens = rng.randint(0, block + 1, size=(batch,)).astype(np.int32)
    lens[0] = 0  # empty row
    if batch > 2:
        lens[1] = min(3, block)  # shorter than the shingle width
        lens[2] = block  # full row
    return tok, lens


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("batch,block", [(48, 300), (8, 1024), (33, 64), (1, 128), (32, 127)])
def test_signatures_match_scan_and_pallas(params, ref_params, batch, block):
    rng = np.random.RandomState(batch * 1000 + block)
    tok, lens = _rows(rng, batch, block)
    got = _u32(minhash.minhash_signatures(torch.from_numpy(tok), torch.from_numpy(lens), params))
    scan = np.asarray(ref_minhash.minhash_signatures(jnp.asarray(tok), jnp.asarray(lens), ref_params))
    pallas = np.asarray(minhash_signatures_pallas(
        jnp.asarray(tok), jnp.asarray(lens), ref_params, interpret=True
    ))
    assert got.dtype == np.uint32 and got.shape == (batch, 128)
    assert np.array_equal(got, scan)
    assert np.array_equal(got, pallas)


def test_shingle_hash_matches_reference():
    rng = np.random.RandomState(5)
    tok, lens = _rows(rng, 16, 200)
    h, valid = shingle_hash(torch.from_numpy(tok), torch.from_numpy(lens), 5)
    rh, rvalid = ref_shingle_hash(jnp.asarray(tok), jnp.asarray(lens), 5)
    assert np.array_equal(h.numpy(), np.asarray(rh).astype(np.int64))
    assert np.array_equal(valid.numpy(), np.asarray(rvalid))


def test_int64_products_past_2_63_are_masked():
    """Values near 2³² multiply past 2⁶³ in int64 and wrap; the low 32
    bits — all that is kept — must still be exact."""
    vals = np.array([0xFFFFFFFF, 0xFFFFFFFE, 0x80000001, 0xDEADBEEF, 0, 1], np.uint32)
    assert np.array_equal(
        fmix32(torch.from_numpy(vals.astype(np.int64))).numpy(),
        fmix32_np(vals).astype(np.int64),
    )
    a = torch.tensor([0xFFFFFFFF, 0xFFFFFFFB], dtype=torch.int64)
    b = torch.tensor([0xFFFFFFFF, 7], dtype=torch.int64)
    h = torch.tensor([[0xFFFFFFFF, 0xFFFFFFFD]], dtype=torch.int64)
    assert int(a[0]) * int(h[0, 0]) > 2**63  # the case this test pins
    got = minhash.scan_min_signature(h, torch.ones_like(h, dtype=torch.bool), a, b, 128)
    want = [
        min((int(ai) * int(x) + int(bi)) % 2**32 for x in h[0].tolist())
        for ai, bi in zip(a.tolist(), b.tolist())
    ]
    assert got[0].tolist() == want
    v = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=torch.int64)
    assert torch.equal(u32_values(to_u32(v)), v)


def test_pack_round_trip_matches_reference():
    rng = np.random.RandomState(1)
    tok, lens = _rows(rng, 64, 128)
    owners = rng.randint(-3, 1 << 20, size=64).astype(np.int32)
    buf = pack_tile(tok, lens, owners)
    assert np.array_equal(buf, ref_pack.pack_tile(tok, lens, owners))
    t, l, o = unpack_tile(torch.from_numpy(buf), 64, 128)
    assert np.array_equal(t.numpy(), tok)
    assert np.array_equal(l.numpy(), lens)
    assert np.array_equal(o.numpy(), owners)


@pytest.mark.parametrize("rows,width,n_articles", [(64, 64, 64), (128, 256, 100), (64, 1024, 7)])
def test_fused_tile_step_matches_reference(params, ref_params, rows, width, n_articles):
    rng = np.random.RandomState(rows + width)
    tok, lens = _rows(rng, rows, width)
    owners = rng.randint(0, n_articles, size=rows).astype(np.int32)
    start = rng.randint(0, 1 << 32, size=(n_articles, 128), dtype=np.uint64).astype(np.uint32)
    start[0] = 0xFFFFFFFF
    buf = pack_tile(tok, lens, owners)
    ref_step = ref_minhash.make_fused_tile_step(ref_params, "scan")
    want = np.asarray(ref_step(
        jnp.asarray(start), jnp.asarray(buf), rows=rows, width=width, num_articles=n_articles
    ))
    for backend in ("scan", "pallas"):
        step = minhash.make_fused_tile_step(params, backend, "cpu")
        running = accumulator_from_numpy(start, "cpu")
        out = step(running, torch.from_numpy(buf), rows=rows, width=width)
        assert out.data_ptr() == running.data_ptr()  # folded in place
        assert np.array_equal(_u32(running), want), backend


def test_combine_block_signatures_matches_reference(params, ref_params):
    rng = np.random.RandomState(9)
    tok, lens = _rows(rng, 40, 256)
    owners = rng.randint(0, 12, size=40).astype(np.int32)
    sigs = minhash.minhash_signatures(torch.from_numpy(tok), torch.from_numpy(lens), params)
    got = minhash.combine_block_signatures(sigs, torch.from_numpy(owners), num_articles=16)
    want = ref_minhash.combine_block_signatures(
        jnp.asarray(_u32(sigs)), jnp.asarray(owners), num_articles=16
    )
    assert np.array_equal(_u32(got), np.asarray(want))


def test_accumulator_resumes_a_reference_corpus(params, ref_params):
    """Fold half the tiles in JAX, carry the accumulator across, fold the
    rest in the port: equal to JAX folding every tile."""
    rng = np.random.RandomState(4)
    tiles = []
    for _ in range(4):
        tok, lens = _rows(rng, 64, 128)
        tiles.append(pack_tile(tok, lens, rng.randint(0, 64, size=64).astype(np.int32)))
    ref_step = ref_minhash.make_fused_tile_step(ref_params, "scan")

    def ref_fold(acc, bufs):
        for buf in bufs:
            acc = ref_step(acc, jnp.asarray(buf), rows=64, width=128, num_articles=64)
        return acc

    full = np.asarray(ref_fold(jnp.full((64, 128), 0xFFFFFFFF, jnp.uint32), tiles))
    half = np.asarray(ref_fold(jnp.full((64, 128), 0xFFFFFFFF, jnp.uint32), tiles[:2]))
    running = accumulator_from_numpy(half, "cpu")
    step = minhash.make_fused_tile_step(params, "scan", "cpu")
    for buf in tiles[2:]:
        step(running, torch.from_numpy(buf), rows=64, width=128)
    assert np.array_equal(_u32(running), full)


def test_kernel_wrappers_reject_what_the_kernel_does_not_take(params):
    bad = params.__class__(**{**params.__dict__, "num_perm": 64})
    a64 = torch.zeros(64, dtype=torch.uint32)
    tok = torch.zeros((4, 128), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="128 perms"):
        minhash_cuda.minhash_sig(tok, lens, a64, a64, 5)
    with pytest.raises(ValueError, match="128 perms"):
        minhash.make_fused_tile_step(bad, "scan", "cuda")
    a, b = minhash.perm_tensors(params, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):  # no fallback to plain
        minhash_cuda.minhash_sig(tok, lens, a, b, 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        minhash_cuda.minhash_fold(
            torch.zeros((4, 128), dtype=torch.uint32),
            torch.zeros(4 * 136, dtype=torch.uint8), rows=4, width=128, a=a, b=b, k=5,
        )
    with pytest.raises(NotImplementedError, match="later slice"):
        minhash.make_fused_tile_step(params, "oph", "cpu")
    with pytest.raises(ValueError, match="unknown signature backend"):
        minhash.make_fused_tile_step(params, "bogus", "cpu")


@pytest.fixture(scope="module")
def segment_corpus():
    """The adversarial corpus plus the segment and block edge lengths, and
    the JAX engine's signatures of it."""
    rng = np.random.RandomState(21)
    docs = adversarial_corpus(rng, 64) + [
        rng.randint(32, 127, size=n, dtype=np.uint8).tobytes() for n in EDGE_LENGTHS
    ]
    ref = RefEngine(RefConfig(rerank=False, exact_verify_band=0.0))
    return docs, np.asarray(ref.signatures(docs))


def _segments(docs, k, S, owner=None, lead=0):
    lens = np.fromiter(map(len, docs), np.int64, count=len(docs))
    off = lead + np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    text = torch.from_numpy(np.frombuffer(bytes(lead) + b"".join(docs), np.uint8).copy())
    owner = np.arange(len(docs)) if owner is None else owner
    seg = [torch.from_numpy(x) for x in segment_ranges(off, lens, owner, k, S)]
    return text, seg


def _fresh(n):
    return to_u32(torch.full((n, 128), 0xFFFFFFFF, dtype=torch.int64))


@pytest.mark.parametrize("S", [8, 64, 1000])
def test_fold_segments_plain_matches_reference_engine(params, segment_corpus, S):
    docs, want = segment_corpus
    text, seg = _segments(docs, params.shingle_k, S, lead=3)
    running = _fresh(len(docs))
    out = minhash.fold_segments_plain(running, text, *seg, params)
    assert out.data_ptr() == running.data_ptr()  # folded in place
    assert np.array_equal(_u32(running), want)
    running = _fresh(len(docs))
    minhash.fold_segments(running, text, *seg, params)  # the CPU dispatch
    assert np.array_equal(_u32(running), want)


def test_fold_segments_plain_shared_dropped_owners_and_chunks(params, segment_corpus):
    """Several articles and two separate texts fold into shared owners of
    a random accumulator; owners N and N+1 are dropped."""
    docs, sigs = segment_corpus
    rng = np.random.RandomState(5)
    n = 40
    owner = rng.randint(0, n + 2, size=len(docs))
    owner[:2] = [n - 1, n]
    start = rng.randint(0, 1 << 32, size=(n, 128), dtype=np.uint64).astype(np.uint32)
    want = start.copy()
    for d, o in enumerate(owner):
        if o < n:
            want[o] = np.minimum(want[o], sigs[d])
    running = accumulator_from_numpy(start, "cpu")
    half = len(docs) // 2
    for part in (slice(0, half), slice(half, len(docs))):
        text, seg = _segments(docs[part], params.shingle_k, 64, owner[part])
        minhash.fold_segments_plain(running, text, *seg, params, batch_bytes=4096)
    assert np.array_equal(_u32(running), want)


def test_segment_wrapper_rejects_what_the_kernel_does_not_take(params):
    k = params.shingle_k
    a, b = minhash.perm_tensors(params, "cpu")
    text = torch.zeros(100, dtype=torch.uint8)
    running = torch.zeros((4, 128), dtype=torch.uint32)
    good = [torch.tensor([0, 50], dtype=torch.int64), torch.tensor([10, 46], dtype=torch.int32),
            torch.tensor([0, 3], dtype=torch.int32)]

    def call(*seg, a=a, b=b):
        return minhash_cuda.minhash_fold_segments(running, text, *seg, a, b, k)

    with pytest.raises(ValueError, match="CUDA tensors"):  # no fallback to plain
        call(*good)
    a64 = torch.zeros(64, dtype=torch.uint32)
    with pytest.raises(ValueError, match="128 perms"):
        call(*good, a=a64, b=a64)
    with pytest.raises(TypeError, match="seg_start"):
        call(good[0].to(torch.int32), *good[1:])
    with pytest.raises(TypeError, match="seg_owner"):
        call(*good[:2], good[2].to(torch.int64))
    with pytest.raises(ValueError, match="one length"):
        call(*good[:2], good[2][:1])
    with pytest.raises(ValueError, match="past the text"):
        call(torch.tensor([0, 51], dtype=torch.int64), *good[1:])
    with pytest.raises(ValueError, match=">= 0"):
        call(torch.tensor([-1, 0], dtype=torch.int64), *good[1:])
    with pytest.raises(ValueError, match="shingle counts"):
        call(good[0], torch.tensor([0, minhash_cuda.MAX_SEGMENT_SHINGLES + 1], dtype=torch.int32),
             good[2])
    with pytest.raises(ValueError, match="past the text"):  # the plain version checks too
        minhash.fold_segments_plain(_fresh(4), text, torch.tensor([0, 51]), *good[1:], params)


@pytest.mark.parametrize("name", sorted(minhash_probe.VARIANTS))
def test_probe_variants_apply_to_the_kernel_source(name):
    """Every variant of the card-side tuning probe still finds the text it
    swaps in ``csrc/minhash.cu``."""
    edits, _exact = minhash_probe.VARIANTS[name]
    src = minhash_probe._variant_source(edits)
    assert "minhash_fold_kernel" in src
    assert (src != minhash_probe._variant_source([])) == bool(edits)
