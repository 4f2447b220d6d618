"""The ring join's kernel formulation (``csrc/ring.cu``) on the CPU.

The kernels run only on the card; here the ring's plain versions in
``parallel/ring.py`` are held exactly to the JAX package's
``parallel/ring.py``:

- the presort (``presort_plain``: the rows valid first, each band's packed
  keys sorted by ``torch.sort(stable=True)``, as ``lsh_sort`` sorts them on
  the card) against ``_presort_bands``' ``(sk, sg, sp)``, with a valid row
  whose band key is ``U32_MAX`` placed after invalid rows (the reference
  puts it before them: its ``gidx_eff`` is smaller), heavy key ties, every
  row valid and every row invalid; ``valid_first`` is that order; a stable
  sort by key alone (``lsh_sort``'s contract) gives the same keys;
- the join (``join_plain``) against ``_best_match_against_sorted`` at
  every hop of a ring of blocks: candidates repeated across bands, an
  agreement exactly at the bar (96/128 at 0.75) and one word under it,
  candidates after the row, invalid transit rows; and a model of the
  kernel's warp (a lane a band in rounds of 32, the smallest candidate
  left verified first, a failed one dropped from every lane, the first
  that verifies kept) against it, at 16, 40 and 3 bands and P = 128, 36;
- ``make_ring_dedup`` as a whole on two meshes at two thresholds, near
  copies around the bars across shards;
- the wrapper's refusal of a CPU tensor.
"""

from __future__ import annotations

import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.core import build_mesh as ref_build_mesh
from advanced_scrapper_tpu.core import make_params as ref_make_params
from advanced_scrapper_tpu.cpu.oracle import mutate_to_jaccard
from advanced_scrapper_tpu.parallel import ring as ref_ring
from advanced_scrapper_tpu.parallel.sharded import shard_batch as ref_shard_batch
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.core.mesh import build_mesh
from advanced_scrapper_tpu_torch.ops import ring_cuda
from advanced_scrapper_tpu_torch.ops.lsh import row_bits
from advanced_scrapper_tpu_torch.parallel import ring

U32 = 0xFFFFFFFF
BIG = (1 << 31) - 1


def _u32t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32).copy()).view(
        torch.uint32)


def _block(rng: np.random.RandomState, B: int, nb: int, P: int, shard: int, *,
           alphabet: int = 6, ties: float = 0.3, invalid: float = 0.2):
    """A block of ``B`` rows: random keys, a share ``ties`` of them from a
    small alphabet (runs of many rows, ``U32_MAX`` among them), random
    signatures, a share ``invalid`` of the rows invalid (keys ``U32_MAX``,
    ``gidx_eff`` int32-max)."""
    keys = rng.randint(0, 1 << 32, size=(B, nb), dtype=np.uint64).astype(np.uint32)
    tied = rng.rand(B, nb) < ties
    small = np.array([1, 7, 7 << 20, 123456, U32 - 1, U32], np.uint64)[:alphabet]
    keys[tied] = rng.choice(small, size=int(tied.sum())).astype(np.uint32)
    valid = rng.rand(B) >= invalid
    keys[~valid] = U32
    sig = rng.randint(0, 1 << 32, size=(B, P), dtype=np.uint64).astype(np.uint32)
    gidx = (shard * B + np.arange(B)).astype(np.int32)
    return keys, valid, sig, gidx


def _ref_presort(keys: np.ndarray, valid: np.ndarray, gidx: np.ndarray):
    g_eff = np.where(valid, gidx, BIG).astype(np.int32)
    sk, sg, sp = ref_ring._presort_bands(jnp.asarray(keys), jnp.asarray(g_eff))
    return np.asarray(sk), np.asarray(sg), np.asarray(sp), g_eff


def _port_presort(keys: np.ndarray, valid: np.ndarray):
    sorted_keys, perm = ring.presort_plain(torch.from_numpy(keys.astype(np.int64)),
                                           torch.from_numpy(valid))
    return sorted_keys, perm


def _unpack(sorted_keys: torch.Tensor, perm: torch.Tensor, bits: int):
    """``(sk, sp)`` as the reference's: the keys and each sorted
    position's block row."""
    sk = (sorted_keys >> bits).numpy().astype(np.uint32)
    sp = perm.to(torch.int64)[sorted_keys & ((1 << bits) - 1)].numpy().astype(np.int32)
    return sk, sp


# -- the presort ---------------------------------------------------------------


def _check_presort(keys, valid, gidx):
    sk, sg, sp, g_eff = _ref_presort(keys, valid, gidx)
    sorted_keys, perm = _port_presort(keys, valid)
    got_sk, got_sp = _unpack(sorted_keys, perm, row_bits(keys.shape[0]))
    assert np.array_equal(got_sk, sk) and np.array_equal(got_sp, sp)
    assert np.array_equal(g_eff[got_sp], sg)


def test_presort_puts_a_u32_max_valid_key_before_invalid_rows():
    """Rows 0-2 invalid, row 3 valid with band key ``U32_MAX`` in band 0:
    the reference sorts it first of its run (smaller ``gidx_eff``), which
    a stable sort by block row would not."""
    keys = np.array([[U32, U32], [U32, U32], [U32, U32], [U32, 5], [9, U32], [U32, 5]], np.uint32)
    valid = np.array([False, False, False, True, True, True])
    gidx = np.arange(6, dtype=np.int32) + 12
    _check_presort(keys, valid, gidx)
    sorted_keys, perm = _port_presort(keys, valid)
    _sk, sp = _unpack(sorted_keys, perm, row_bits(6))
    assert sp[0].tolist() == [4, 3, 5, 0, 1, 2]  # 9, then U32_MAX: valid 3, 5, invalid 0, 1, 2


@pytest.mark.parametrize("B,nb,invalid", [(1, 1, 0.0), (2, 3, 0.5), (37, 4, 0.2), (64, 16, 0.0),
                                          (64, 16, 1.0), (200, 5, 0.4)])
def test_presort_equals_reference(B, nb, invalid):
    rng = np.random.RandomState(B * 31 + nb)
    keys, valid, _sig, gidx = _block(rng, B, nb, 8, shard=3, ties=0.6, invalid=invalid)
    _check_presort(keys, valid, gidx)


def test_valid_first_and_a_stable_key_sort():
    """``valid_first`` lists valid rows, then invalid, each ascending; a
    stable sort of the packed keys by key alone (``lsh_sort``'s contract:
    the rows enter ascending) gives the plain presort's order."""
    rng = np.random.RandomState(5)
    for B in (0, 1, 9, 100):
        valid = rng.rand(B) < 0.6
        got = ring.valid_first(torch.from_numpy(valid)).numpy()
        assert got.dtype == np.int32
        assert got.tolist() == np.flatnonzero(valid).tolist() + np.flatnonzero(~valid).tolist()
    keys, valid, _sig, _g = _block(rng, 100, 6, 4, shard=0)
    sorted_keys, perm = _port_presort(keys, valid)
    bits = row_bits(100)
    packed = ring._packed(torch.from_numpy(keys.astype(np.int64)), perm, bits).numpy()
    stable = np.take_along_axis(packed, np.argsort(packed >> bits, axis=1, kind="stable"), 1)
    assert np.array_equal(stable, sorted_keys.numpy())
    assert (packed & ((1 << bits) - 1) == np.arange(100)).all()


# -- the join ------------------------------------------------------------------


def _plant(rng, local, transit, *, P: int, pairs: int):
    """Copy some transit rows' keys (in several bands) and signatures
    (agreeing on exactly 96 of 128 words, or 95, or all) into local rows."""
    keys_l, valid_l, sig_l, _ = local
    keys_b, valid_b, sig_b, _ = transit
    for _ in range(pairs):
        r, t = rng.randint(len(keys_l)), rng.randint(len(keys_b))
        if not (valid_l[r] and valid_b[t]):
            continue
        bands = rng.rand(keys_l.shape[1]) < 0.6
        keys_l[r, bands] = keys_b[t, bands]
        agree = int(rng.choice([P, P * 3 // 4, P * 3 // 4 - 1, P // 2]))
        sig_l[r] = sig_b[t]
        flip = rng.choice(P, P - agree, replace=False)
        sig_l[r, flip] ^= 1


def _ref_join(local, transit, threshold):
    keys_l, _v, sig_l, gidx_l = local
    keys_b, valid_b, sig_b, gidx_b = transit
    sk, _sg, sp, g_eff = _ref_presort(keys_b, valid_b, gidx_b)
    return np.asarray(ref_ring._best_match_against_sorted(
        jnp.asarray(keys_l), jnp.asarray(sig_l), jnp.asarray(gidx_l), jnp.asarray(sk),
        jnp.asarray(sp), jnp.asarray(g_eff), jnp.asarray(sig_b), threshold))


def _port_args(local, transit):
    keys_l, _v, sig_l, gidx_l = local
    keys_b, valid_b, sig_b, gidx_b = transit
    sorted_keys, perm = _port_presort(keys_b, valid_b)
    g_eff = torch.from_numpy(np.where(valid_b, gidx_b, BIG).astype(np.int32))
    return (torch.from_numpy(keys_l.astype(np.int64)), _u32t(sig_l), torch.from_numpy(gidx_l),
            sorted_keys, perm, g_eff, _u32t(sig_b))


def _ring_blocks(seed: int, shards: int, B: int, nb: int, P: int, alphabet: int = 6,
                 ties: float = 0.3):
    rng = np.random.RandomState(seed)
    blocks = [_block(rng, B, nb, P, s, alphabet=alphabet, ties=ties) for s in range(shards)]
    for i in range(shards):
        for j in range(shards):
            if i != j:
                _plant(rng, blocks[i], blocks[j], P=P, pairs=B // 3)
    return blocks


@pytest.mark.parametrize("threshold", [0.75, 0.7])
def test_join_equals_reference_at_every_hop(threshold):
    """Every (local, transit) pair of a 3-block ring: repeats across bands,
    agreements of 96/128 (at 0.75 exactly the bar) and 95/128, transit
    rows before and after the local ones, invalid rows on both sides."""
    P, B, nb = 128, 48, 16
    blocks = _ring_blocks(11, 3, B, nb, P)
    assert any((b[0] == U32).any(axis=1).sum() for b in blocks)
    verified = 0
    for local in blocks:
        for transit in blocks:
            want = _ref_join(local, transit, threshold)
            args = _port_args(local, transit)
            rep = args[2].clone()
            got = ring.join_plain(*args, rep, threshold, row_bits(B)).numpy()
            assert got.dtype == np.int32 and np.array_equal(got, want)
            verified += int((want != local[3]).sum())
    assert verified > 10


def test_join_at_the_bar_exactly():
    """A local row whose only candidate agrees on 96 of 128 words joins at
    0.75 and not above it; at 95 words it does not join."""
    rng = np.random.RandomState(3)
    P, nb = 128, 4
    keys_b = np.array([[5, 6, 7, 8], [9, 9, 9, 9]], np.uint32)
    sig_b = rng.randint(0, 1 << 32, size=(2, P), dtype=np.uint64).astype(np.uint32)
    transit = (keys_b, np.array([True, True]), sig_b, np.array([0, 1], np.int32))
    for agree, threshold, joins in ((96, 0.75, True), (96, 0.7501, False), (95, 0.75, False)):
        sig_l = sig_b[:1].copy()
        sig_l[0, :P - agree] ^= 0xFFFF
        local = (np.array([[5, 1, 7, 2]], np.uint32), np.array([True]), sig_l,
                 np.array([10], np.int32))
        want = _ref_join(local, transit, threshold)
        args = _port_args(local, transit)
        got = ring.join_plain(*args, args[2].clone(), threshold, row_bits(2)).numpy()
        assert np.array_equal(got, want) and (got[0] == 0) == joins


def _kernel_model(keys_l, sig_l, gidx_l, sorted_keys, perm, gidx_eff, sig_b, rep, threshold,
                  bits):
    """``ring_join_kernel``'s warp a row: a lane a band in rounds of 32,
    a binary search for the run head, the candidates that could lower the
    best; the smallest left verified first (count / P in float32 against
    the bar in float32), a failure dropped from every lane holding it, the
    first success kept."""
    keys_l, sig_l = keys_l.numpy(), sig_l.view(torch.int32).numpy()
    sig_b, perm, g_eff = sig_b.view(torch.int32).numpy(), perm.numpy(), gidx_eff.numpy()
    bands = [list(b) for b in sorted_keys.numpy()]
    (Bl, nb), P, Bt = keys_l.shape, sig_l.shape[1], sorted_keys.shape[1]
    thr, mask = np.float32(threshold), (1 << bits) - 1
    out = rep.numpy().copy()
    verifies = 0
    for r in range(Bl):
        gl, best = int(gidx_l[r]), BIG
        for b0 in range(0, nb, 32):
            cand = {}
            for b in range(b0, min(nb, b0 + 32)):
                kl = int(keys_l[r, b])
                pos = min(bisect.bisect_left(bands[b], kl << bits), Bt - 1)
                v = bands[b][pos]
                if v >> bits == kl:
                    row = int(perm[v & mask])
                    cg = int(g_eff[row])
                    if cg < gl and cg < best:
                        cand[b] = (cg, row)
            while cand:
                m, row = min(cand.values())
                verifies += 1
                count = int((sig_l[r] == sig_b[row]).sum())
                if np.float32(count) / np.float32(P) >= thr:
                    best = m
                    break
                cand = {b: c for b, c in cand.items() if c[0] != m}
        out[r] = min(out[r], gl if best == BIG else best)
    return out, verifies


@pytest.mark.parametrize("nb,P,alphabet,ties", [(16, 128, 6, 0.3), (40, 36, 3, 0.5),
                                                (3, 128, 2, 1.0)])
def test_kernel_model_equals_plain(nb, P, alphabet, ties):
    """More than 32 bands (two rounds), P not a multiple of 4, few distinct
    keys (every band repeats the same candidates); ``rep`` already below
    some rows' results."""
    B = 40
    blocks = _ring_blocks(nb + P, 2, B, nb, P, alphabet=alphabet, ties=ties)
    total = 0
    for local, transit in ((blocks[0], blocks[1]), (blocks[1], blocks[0]), (blocks[1], blocks[1])):
        args = _port_args(local, transit)
        rep = args[2].clone()
        rep[::5] = 0
        want = ring.join_plain(*args, rep, 0.75, row_bits(B)).numpy()
        got, verifies = _kernel_model(*args, rep, 0.75, row_bits(B))
        assert np.array_equal(got, want)
        total += verifies
    assert total > 0


# -- the whole ring -------------------------------------------------------------


def _ring_corpus(B=64, L=256, seed=4):
    """Exact and near copies across shards around the bars, an empty row
    and one shorter than a shingle."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(32, 127, size=(B, L)).astype(np.uint8)
    lens = np.full((B,), L, np.int32)
    for src, dst, j in ((0, 17, 1.0), (3, 40, 0.9), (17, 63, 0.8), (20, 21, 0.75), (5, 50, 0.7),
                        (50, 60, 0.86)):
        near = mutate_to_jaccard(rng, tok[src].tobytes(), j) if j < 1 else tok[src].tobytes()
        tok[dst] = np.frombuffer(near[:L].ljust(L, b" "), np.uint8)
    lens[30] = 0
    lens[31] = 3
    return tok, lens


@pytest.mark.parametrize("shape,threshold", [((8, 1), 0.7), ((4, 2), 0.85)])
def test_make_ring_dedup_equals_reference(devices8, shape, threshold):
    tok, lens = _ring_corpus()
    n = shape[0] * shape[1]
    ref_mesh = ref_build_mesh(*shape, devices=devices8[:n])
    want = np.asarray(ref_ring.make_ring_dedup(ref_mesh, ref_make_params(), threshold=threshold,
                                               jump_rounds=8)(*ref_shard_batch(tok, lens,
                                                                               ref_mesh)))
    mesh = build_mesh(*shape, devices=["cpu"] * n)
    got = ring.make_ring_dedup(mesh, make_params(), threshold=threshold, jump_rounds=8)(tok, lens)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (want != np.arange(len(tok))).sum() >= 2


def test_wrapper_raises_on_cpu_tensors():
    keys = torch.zeros((2, 1), dtype=torch.int64)
    sig = torch.zeros((2, 4), dtype=torch.int32)
    one = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_cuda.ring_join(keys, sig, one, keys.T.contiguous(), one, one, sig, one.clone(),
                            threshold=0.7, bits=1)
