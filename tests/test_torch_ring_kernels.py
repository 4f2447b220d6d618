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
  kernel's two phases (by band: tiles of the local presort's positions,
  the guessed transit window or the bracket of the tile's bounds staged,
  else a search in the band; by row: 16 or 32 lanes, the smallest
  candidate left verified first, a failed one dropped from every lane, the
  first that verifies kept) against it, at 16, 40, 33 and 3 bands and P =
  128, 36, 30, at the source's tile sizes and at small ones, and across
  long runs of equal keys (invalid rows, valid ``U32_MAX`` keys);
- ``join_probe.py``'s edits of the shipped sources, each found once;
- ``make_ring_dedup`` as a whole on two meshes at two thresholds, near
  copies around the bars across shards;
- the wrapper's refusal of a CPU tensor.
"""

from __future__ import annotations

import bisect
import re

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
from advanced_scrapper_tpu_torch.ops import _build, ring_cuda
from advanced_scrapper_tpu_torch.ops.lsh import row_bits
from advanced_scrapper_tpu_torch.parallel import ring

import join_probe
import myers_probe

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


RING_SRC = (_build.CSRC_DIR / "ring.cu").read_text()


def _ring_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", RING_SRC).group(1))


#: the kernel's phase-1 sizes, read from its source
THREADS, ITEMS, SLACK, GUARD = (_ring_const(n) for n in ("kThreads", "kItems", "kSlack",
                                                          "kGuard"))
for _formula in ("kTile = kThreads * kItems;", "kSpanMax = 4 * kTile;",
                 "kSearchLanes = kThreads / 2;"):
    assert _formula in RING_SRC, _formula
TILE, SPAN_MAX, SEARCH_LANES = THREADS * ITEMS, 4 * THREADS * ITEMS, THREADS // 2


def block_bracket(band, target: int, lanes: int, slack: int) -> tuple[int, int, int]:
    """``block_bracket``'s walk: while the range is wider than ``slack``,
    ``lanes`` evenly spaced keys of it, the ones below ``target`` counted,
    the range cut to the gap after the last of them.  ``(L, R, rounds)``
    with the first position whose key is >= ``target`` (``len(band)`` if
    none) in ``[L, R]``."""
    lo, hi, rounds = 0, len(band), 0
    while hi - lo > slack:
        n = hi - lo
        stride = -(-n // lanes)
        samples = range(lo, hi, stride)
        c = sum(1 for s in samples if band[s] < target)
        if c == 0:
            hi = lo
        else:
            hi = lo + c * stride if c < len(samples) else hi
            lo = lo + (c - 1) * stride + 1
        rounds += 1
    return lo, hi, rounds


def _kernel_model(keys_l, sig_l, gidx_l, sorted_keys, perm, gidx_eff, sig_b, rep, threshold,
                  bits, sorted_l, order_l, *, tile=TILE, span_max=SPAN_MAX,
                  lanes=SEARCH_LANES, slack=SLACK, guard=GUARD):
    """``ring_join``'s two phases.  Phase 1, a (band, tile of ``tile``
    local sorted positions): the guessed transit window (the tile's share of
    the band, ``guard`` positions each side) staged when it fits
    ``span_max``, kept when its first key is below the tile's first key (or
    it starts the band) and its last at least the tile's last key (or it
    ends the band); else brackets of the run heads of the tile's first and
    last keys by :func:`block_bracket`, the span from the first's low end to
    the last's high end staged (at most ``span_max`` keys) or, past that,
    each position searched between them in the band.  The run head's
    (gidx_eff, transit row) or (int32 max, 0) goes to the table at [the
    local row's place f in order_l, band], each entry once.
    Phase 2, a group of 16 lanes an f, for its row order_l[f] (32 above 16
    bands, bands in rounds of 32): the candidates before the row that could
    lower its best, the smallest left verified first (count / P in float32
    against the bar in float32), a failure dropped from every lane holding
    it, the first success kept.  ``keys_l`` is not read.  Returns ``(rep,
    verifies, paths)``."""
    sig_l = sig_l.view(torch.int32).numpy()
    sig_b, perm, g_eff = sig_b.view(torch.int32).numpy(), perm.numpy(), gidx_eff.numpy()
    sorted_l, order_l = sorted_l.numpy(), order_l.numpy()
    bands = [list(b) for b in sorted_keys.numpy()]
    (nb, Bl), P, Bt = sorted_l.shape, sig_l.shape[1], sorted_keys.shape[1]
    thr, mask = np.float32(threshold), (1 << bits) - 1
    table = np.zeros((Bl, nb, 2), np.int64)
    written = np.zeros((Bl, nb), np.int64)
    paths = {"guessed": 0, "staged": 0, "global": 0, "search_rounds": 0}
    for b in range(nb):
        lband, tband = sorted_l[b], bands[b]
        for j0 in range(0, Bl, tile):
            n_here = min(tile, Bl - j0)
            k_first, k_last = int(lband[j0]) >> bits, int(lband[j0 + n_here - 1]) >> bits
            scale = np.float32(Bt) / np.float32(Bl)
            s0 = max(int(np.floor(np.float32(j0) * scale)) - guard, 0)
            s1 = min(int(np.floor(np.float32(j0 + n_here) * scale)) + guard, Bt - 1)
            span = tband[s0:s1 + 1]
            staged = (len(span) <= span_max and (s0 == 0 or span[0] < k_first << bits)
                      and (s1 == Bt - 1 or span[-1] >= k_last << bits))
            lo = hi = 0
            if staged:
                paths["guessed"] += 1
            else:
                lo, _h, r0 = block_bracket(tband, k_first << bits, lanes, slack)
                _l, hi, r1 = block_bracket(tband, k_last << bits, lanes, slack)
                paths["search_rounds"] = max(paths["search_rounds"], r0, r1)
                s0, s1 = min(lo, Bt - 1), min(hi, Bt - 1)
                staged = s1 - s0 + 1 <= span_max
                span = tband[s0:s1 + 1]
                paths["staged" if staged else "global"] += 1
            for j in range(j0, j0 + n_here):
                v_l = int(lband[j])
                kl, f = v_l >> bits, v_l & mask
                if staged:
                    v = span[min(bisect.bisect_left(span, kl << bits), len(span) - 1)]
                else:
                    v = tband[min(bisect.bisect_left(tband, kl << bits, lo, hi), Bt - 1)]
                e = (BIG, 0)
                if v >> bits == kl and (v & mask) < Bt:
                    crow = int(perm[v & mask])
                    e = (int(g_eff[crow]), crow)
                table[f, b] = e
                written[f, b] += 1
    assert (written == 1).all()
    group = 16 if nb <= 16 else 32
    out = rep.numpy().copy()
    verifies = 0
    for f in range(Bl):
        r = int(order_l[f])
        gl, best = int(gidx_l[r]), BIG
        for b0 in range(0, nb, group):
            cand = {b: (int(table[f, b, 0]), int(table[f, b, 1]))
                    for b in range(b0, min(nb, b0 + group))
                    if table[f, b, 0] < gl and table[f, b, 0] < best}
            while cand:
                m, row = min(cand.values())
                verifies += 1
                count = int((sig_l[r] == sig_b[row]).sum())
                if np.float32(count) / np.float32(P) >= thr:
                    best = m
                    break
                cand = {b: c for b, c in cand.items() if c[0] != m}
        out[r] = min(out[r], gl if best == BIG else best)
    return out, verifies, paths


def _local_presort(local):
    keys_l, valid_l = local[0], local[1]
    return _port_presort(keys_l, valid_l)


@pytest.mark.parametrize("lanes", [128, 4, 2])
@pytest.mark.parametrize("slack", [SLACK, 0])
def test_block_bracket_holds_the_run_head(lanes, slack):
    """The bracket holds the first key >= the target and is at most
    ``slack`` wide (exact at 0), with runs of equal keys, targets below,
    between and past every key; at 8,192 keys the 128-way walk takes one
    round to the source's slack and two to the exact position."""
    rng = np.random.RandomState(lanes + slack)
    for n in (1, 2, 7, 129, 8192):
        band = np.sort(rng.choice([3, 5, 5, 5, 9, 1 << 40, (1 << 63) - 1],
                                  size=n)).tolist()
        for target in (0, 3, 4, 5, 6, 9, 10, 1 << 40, (1 << 63) - 1):
            lo, hi, rounds = block_bracket(band, target, lanes, slack)
            assert lo <= bisect.bisect_left(band, target) <= hi and hi - lo <= slack
            if lanes == 128 and n == 8192:
                assert rounds <= (1 if slack == SLACK else 2)


_SMALL = {"tile": 8, "span_max": 16, "lanes": 4, "slack": 2, "guard": 3}


@pytest.mark.parametrize("nb,P,alphabet,ties", [(16, 128, 6, 0.3), (40, 36, 3, 0.5),
                                                (3, 128, 2, 1.0), (33, 30, 6, 0.3)])
@pytest.mark.parametrize("sizes", ["source", "small"])
def test_kernel_model_equals_plain(nb, P, alphabet, ties, sizes):
    """More than 32 bands (two rounds of a full warp), 3 bands, P not a
    multiple of 4, few distinct keys (every band repeats the same
    candidates); ``rep`` already below some rows' results.  At the source's
    tile and span sizes, and at 8-position tiles with a 16-key span
    (several tiles a band: the guessed window, the bracket's span and, where
    ties run long, the global branch)."""
    B = 40
    blocks = _ring_blocks(nb + P, 2, B, nb, P, alphabet=alphabet, ties=ties)
    kw = _SMALL if sizes == "small" else {}
    total, paths = 0, {"guessed": 0, "staged": 0, "global": 0}
    for local, transit in ((blocks[0], blocks[1]), (blocks[1], blocks[0]), (blocks[1], blocks[1])):
        args = _port_args(local, transit)
        rep = args[2].clone()
        rep[::5] = 0
        want = ring.join_plain(*args, rep, 0.75, row_bits(B)).numpy()
        got, verifies, p = _kernel_model(*args, rep, 0.75, row_bits(B), *_local_presort(local),
                                         **kw)
        assert np.array_equal(got, want)
        total += verifies
        for k in paths:
            paths[k] += p[k]
    assert total > 0
    tiles = 3 * nb * (-(-B // (_SMALL["tile"] if sizes == "small" else TILE)))
    assert sum(paths.values()) == tiles and paths["guessed"] > 0
    if sizes == "small":  # ties run past the 16-key span: every branch
        assert paths["staged"] and paths["global"]


def test_kernel_model_across_long_runs():
    """A local tile across long runs of equal transit keys: a valid key
    ``K`` on 30 transit rows, invalid rows (``U32_MAX``) and valid rows
    whose key is ``U32_MAX``, in every band; local rows with keys just
    below, at and just above ``K`` and at ``U32_MAX``, some copies of
    transit rows.  A tile whose first key is at most ``K`` and whose last
    is above it spans the whole run, which passes the buffer: the global
    branch.  Only the run head is a candidate, as in the reference."""
    rng = np.random.RandomState(77)
    B, nb, P = 64, 4, 36
    K = 7 << 20
    transit = _block(rng, B, nb, P, 0, ties=0.0, invalid=0.0)
    local = _block(rng, B, nb, P, 1, ties=0.0, invalid=0.0)
    keys_b, valid_b, sig_b, _ = transit
    keys_b[:30] = K
    valid_b[40:50] = False
    keys_b[40:50] = U32
    keys_b[50:56] = U32  # valid rows with the key U32_MAX
    keys_l, valid_l, sig_l, _ = local
    keys_l[:4] = K - 1
    keys_l[4:12] = K
    keys_l[12:16] = K + 1
    keys_l[24:32] = U32
    valid_l[60:] = False
    keys_l[60:] = U32
    for r, t in ((4, 0), (5, 3), (24, 50), (25, 52)):
        sig_l[r] = sig_b[t]
        sig_l[r, :5] ^= 1  # 31 of 36 words agree
    args = _port_args(local, transit)
    total_global = 0
    for kw in ({}, _SMALL, {"tile": 16, "span_max": 20, "lanes": 8, "slack": 0, "guard": 1},
               {**_SMALL, "guard": 0}):
        for threshold in (0.7, 0.9):
            rep = args[2].clone()
            want = ring.join_plain(*args, rep, threshold, row_bits(B)).numpy()
            got, _v, paths = _kernel_model(*args, rep, threshold, row_bits(B),
                                           *_local_presort(local), **kw)
            assert np.array_equal(got, want)
            total_global += paths["global"]
    assert total_global > 0
    joined = ring.join_plain(*args, args[2].clone(), 0.7, row_bits(B)).numpy()
    # the run heads, the earliest valid rows of each run: transit rows 0 and 50
    assert joined[[4, 5, 24, 25]].tolist() == [0, 64 + 5, 50, 64 + 25]


@pytest.mark.parametrize("source,name", [
    (src, name) for src, variants in join_probe.VARIANTS.items()
    for name in [*variants, *join_probe.CUTS.get(src, {})]])
def test_probe_variants_patch_the_shipped_source(source, name):
    """Each of ``join_probe.py``'s edits of ``ring.cu`` and ``exact.cu`` is
    found exactly once in the shipped source (the probe builds them on the
    card only)."""
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    edits = {**join_probe.VARIANTS[source], **join_probe.CUTS.get(source, {})}[name]
    out = myers_probe.patched(src, edits)
    assert (out == src) == (name == "shipped")


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
                            threshold=0.7, bits=1, sorted_l=keys.T.contiguous(), order_l=one)
