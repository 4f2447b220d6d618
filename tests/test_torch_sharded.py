"""The port's sharded steps (``parallel/sharded.py``, ``parallel/ring.py``)
on CPU meshes against the JAX package's on its 8-device virtual mesh:
the batch step (representatives and the ``psum`` histogram), the blockwise
step, the sequence-parallel signatures and the ring, on 4×2, 8×1 and 1×1
meshes, every output equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.core import build_mesh as ref_build_mesh
from advanced_scrapper_tpu.core import encode_batch as ref_encode_batch
from advanced_scrapper_tpu.core import make_params as ref_make_params
from advanced_scrapper_tpu.cpu.oracle import mutate_to_jaccard
from advanced_scrapper_tpu.parallel.ring import make_ring_dedup as ref_ring
from advanced_scrapper_tpu.parallel.sharded import make_sharded_block_dedup as ref_block
from advanced_scrapper_tpu.parallel.sharded import make_sharded_dedup as ref_dedup
from advanced_scrapper_tpu.parallel.sharded import seq_sharded_signatures as ref_seq
from advanced_scrapper_tpu.parallel.sharded import shard_batch as ref_shard_batch
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.core.mesh import build_mesh
from advanced_scrapper_tpu_torch.core.tokenizer import encode_batch, encode_blocks
from advanced_scrapper_tpu_torch.ops.minhash import minhash_signatures
from advanced_scrapper_tpu_torch.parallel.ring import make_ring_dedup
from advanced_scrapper_tpu_torch.parallel.sharded import (
    make_sharded_block_dedup,
    make_sharded_dedup,
    seq_sharded_signatures,
    shard_batch,
    sharded_dedup_step,
)

SHAPES = [(4, 2), (8, 1), (1, 1)]
#: every mesh with the dense MinHash, one with OPH
CASES = [(s, "scan") for s in SHAPES] + [((4, 2), "oph")]
PARAMS = make_params()


def case_id(case) -> str:
    (dp, sp), backend = case
    return f"{backend}-{dp}x{sp}"



@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this module's torch work: the suite runs
    several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def meshes(shape, devices8):
    n = shape[0] * shape[1]
    return ref_build_mesh(*shape, devices=devices8[:n]), build_mesh(*shape, devices=["cpu"] * n)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def _random_docs(n, length, seed):
    rng = np.random.RandomState(seed)
    return [bytes(rng.randint(32, 127, size=length, dtype=np.uint8)) for _ in range(n)]


@pytest.fixture(scope="module")
def batch():
    """64 rows of a 256-byte block: exact and near copies across data
    shards, a row below the threshold, an empty and a sub-shingle row."""
    rng = np.random.RandomState(9)
    texts = _random_docs(64, 200, seed=9)
    texts[10] = texts[4]
    texts[21] = texts[7][:-30] + bytes(rng.randint(32, 127, 30, dtype=np.uint8))
    texts[33] = texts[7][:-45] + bytes(rng.randint(32, 127, 45, dtype=np.uint8))
    texts[50] = texts[2]
    texts[60] = b""
    texts[61] = b"abc"
    tok, ln = encode_batch(texts, block_len=256)
    ref_tok, ref_ln = ref_encode_batch(texts, block_len=256)
    assert np.array_equal(tok, ref_tok) and np.array_equal(ln, ref_ln)
    return tok, ln


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sharded_dedup_matches_reference(devices8, batch, case):
    shape, backend = case
    ref_mesh, mesh = meshes(shape, devices8)
    tok, ln = batch
    want_rep, want_hist = ref_dedup(ref_mesh, ref_make_params(), backend=backend)(
        *ref_shard_batch(tok, ln, ref_mesh))
    rep, hist = make_sharded_dedup(mesh, PARAMS, backend=backend)(*shard_batch(tok, ln, mesh))
    assert rep.dtype == torch.int32 and hist.dtype == torch.int32
    assert np.array_equal(rep.numpy(), np.asarray(want_rep))
    assert np.array_equal(hist.numpy(), np.asarray(want_hist))
    assert rep[10] == 4 and rep[21] == 7 and rep[50] == 2 and rep[33] == 33
    assert int(hist.sum()) == (64 - 2) * PARAMS.num_bands
    # host arrays go straight in; one call of the convenience wrapper
    rep2, _ = sharded_dedup_step(tok, ln, PARAMS, mesh, backend=backend)
    assert torch.equal(rep2, rep)


def test_sharded_fine_margin_matches_reference(devices8):
    """The per-edge fine-only bars inside the step, against the reference
    at two margins on knee pairs; a prohibitive margin changes a result."""
    ref_mesh, mesh = meshes((4, 2), devices8)
    rng = np.random.RandomState(2)
    texts = []
    for _ in range(32):
        base = bytes(rng.randint(32, 127, size=240, dtype=np.uint8))
        texts += [base, mutate_to_jaccard(rng, base, 0.68)]
    tok, ln = encode_batch(texts, block_len=256)
    got = {}
    for margin in (0.0, 0.04, 0.5):
        want, _ = ref_dedup(ref_mesh, ref_make_params(), fine_margin=margin)(
            *ref_shard_batch(tok, ln, ref_mesh))
        got[margin], _ = make_sharded_dedup(mesh, PARAMS, fine_margin=margin)(tok, ln)
        assert np.array_equal(got[margin].numpy(), np.asarray(want)), margin
    assert not torch.equal(got[0.0], got[0.5])


@pytest.fixture(scope="module")
def blocks():
    """Blockwise rows of a ragged corpus (articles longer than a block,
    copies across shards), padded to 128 rows owned by the scratch slot."""
    rng = np.random.RandomState(4)
    docs = [rng.randint(32, 127, size=int(rng.randint(0, 700)), dtype=np.uint8).tobytes()
            for _ in range(24)]
    docs[2], docs[9] = (rng.randint(32, 127, size=n, dtype=np.uint8).tobytes() for n in (400, 300))
    docs[13], docs[20], docs[5] = docs[2], docs[9], b"ab"
    tok, lens, owners = encode_blocks(docs, 128, overlap=PARAMS.shingle_k - 1)
    n_art = 32
    pad = 128 - tok.shape[0]
    assert pad >= 0
    tok = np.concatenate([tok, np.zeros((pad, 128), np.uint8)])
    lens = np.concatenate([lens, np.zeros((pad,), np.int32)])
    owners = np.concatenate([owners.astype(np.int32), np.full((pad,), n_art, np.int32)])
    return tok, lens, owners, n_art


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sharded_block_dedup_matches_reference(devices8, blocks, case):
    shape, backend = case
    ref_mesh, mesh = meshes(shape, devices8)
    tok, lens, owners, n_art = blocks
    want_rep, want_hist = ref_block(ref_mesh, ref_make_params(), n_art, jump_rounds=5,
                                    backend=backend)(tok, lens, owners)
    rep, hist = make_sharded_block_dedup(mesh, PARAMS, n_art, jump_rounds=5,
                                         backend=backend)(tok, lens, owners)
    assert np.array_equal(rep.numpy(), np.asarray(want_rep))
    assert np.array_equal(hist.numpy(), np.asarray(want_hist))
    assert rep[13] == 2 and rep[20] == 9


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_seq_parallel_signatures_match_reference(devices8, shape):
    """Halo exchange and ``pmin`` reproduce the one-device signatures,
    with texts that end inside a shard, span every shard, fill the block,
    and fall below a shingle."""
    ref_mesh, mesh = meshes(shape, devices8)
    texts = [b"a" * 37, _random_docs(1, 200, 7)[0], _random_docs(1, 256, 8)[0], b"tiny",
             b"", _random_docs(1, 65, 3)[0], _random_docs(1, 128, 1)[0], b"xyzwv"]
    tok, ln = encode_batch(texts, block_len=256)
    want = np.asarray(ref_seq(tok, ln, ref_make_params(), ref_mesh))
    got = seq_sharded_signatures(tok, ln, PARAMS, mesh)
    assert got.dtype == torch.uint32 and np.array_equal(got.numpy(), want)
    one = minhash_signatures(torch.from_numpy(tok), torch.from_numpy(ln), PARAMS)
    assert np.array_equal(got.numpy(), u32(one))


def test_seq_parallel_rejects_an_indivisible_block():
    mesh = build_mesh(4, 2, devices=["cpu"] * 8)
    tok, ln = encode_batch([b"hello world"] * 4, block_len=65)
    with pytest.raises(ValueError, match="not divisible by seq=2"):
        seq_sharded_signatures(tok, ln, PARAMS, mesh)


def _ring_corpus(B=64, L=256, seed=0, dup_pairs=((0, 9), (3, 40), (17, 63), (20, 21))):
    rng = np.random.RandomState(seed)
    tok = rng.randint(32, 127, size=(B, L)).astype(np.uint8)
    lens = np.full((B,), L, dtype=np.int32)
    for a, b in dup_pairs:
        tok[b] = tok[a]
        if (a + b) % 2:
            tok[b, -4:] = rng.randint(32, 127, size=4)
    lens[5] = 0
    lens[6] = 3
    return tok, lens, tuple(dup_pairs)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ring_matches_reference_ring(devices8, shape):
    """The ring equals the reference's ring (not the gather path), with
    first-seen roots across shards, a chain and never-merging short rows."""
    ref_mesh, mesh = meshes(shape, devices8)
    tok, lens, pairs = _ring_corpus()
    tok[55] = tok[30] = tok[2]  # a chain 2 ≈ 30 ≈ 55 across shards
    want = np.asarray(ref_ring(ref_mesh, ref_make_params(), jump_rounds=8)(
        *ref_shard_batch(tok, lens, ref_mesh)))
    got = make_ring_dedup(mesh, PARAMS, jump_rounds=8)(*shard_batch(tok, lens, mesh))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for a, b in pairs:
        assert got[b] == a
    assert got[30] == 2 and got[55] == 2 and got[5] == 5 and got[6] == 6


def test_ring_on_borderline_chains_matches_the_reference(devices8):
    """Near copies around the bar, where ring and gather may differ: the
    port's ring still equals the reference's ring."""
    ref_mesh, mesh = meshes((8, 1), devices8)
    rng = np.random.RandomState(12)
    tok = rng.randint(32, 127, size=(64, 256)).astype(np.uint8)
    lens = np.full((64,), 256, np.int32)
    for i in range(1, 64, 3):
        src = tok[i - 1].tobytes()
        tok[i] = np.frombuffer(mutate_to_jaccard(rng, src, 0.66 + 0.01 * (i % 8))[:256].ljust(
            256, b" "), np.uint8)
    want = np.asarray(ref_ring(ref_mesh, ref_make_params(), jump_rounds=8)(
        *ref_shard_batch(tok, lens, ref_mesh)))
    got = make_ring_dedup(mesh, PARAMS, jump_rounds=8)(tok, lens)
    assert np.array_equal(got.numpy(), want)
    assert (want != np.arange(64)).any()
