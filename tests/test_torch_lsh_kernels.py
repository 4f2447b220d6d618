"""The LSH epilogue kernels' formulations (``csrc/lsh.cu``) on the CPU.

The kernels run only on the card; here their plain versions in
``ops.lsh`` and numpy models of their walks are held exactly to the JAX
package's ``ops.lsh``:

- the packed-key sort of the candidate stage (``(key << row_bits) | row``,
  invalid rows at ``U32_MAX``) and the run-head scan, at B = 1, 2, 3 and
  odd sizes, under heavy key ties, with every row invalid, a padding run of
  hundreds of rows and a valid row whose key is ``U32_MAX``; a model of the
  radix sort's passes (tiles, per-band digit offsets, stable warp ranks) at
  small tiles and other digit widths, over bands of many lengths; a model
  of the run-head kernels (a many-way search for a tile's run start, a
  max-scan of run starts, records a (band, row) transposed into the rows);
- the label: each row's distinct ok edges compacted as the first launch
  does it, then every round as the one cooperative launch runs them (``x``
  and two ``z`` buffers, grid syncs, a round stamp, atomics in a shuffled
  order, the early stop), at ``jump_rounds`` 0, 1, 2 and full on a 64-node
  chain, random graphs, rows whose 144 columns repeat one or two
  candidates, every column distinct and ok, and a shuffled chain that
  needs every round;
- the agreement pass at bars where ``count/P`` meets the bar exactly and at
  ``base + fine_margin`` boundaries, a model of the per-edge logic and one
  of the kernel's compaction (each distinct candidate of a chunk once) and
  grouping (lanes a candidate, words a lane), at P = 30, 36, 64 and 128;
- the keys, as each (row, key set) folds them, and the tiles of 32 rows
  (the load and pitch a shape takes, the staged keys written out in pairs,
  the packed keys of valid and invalid rows) at B = 1, 31, 32 and 33, P =
  36 with odd band widths, a signature off 16-byte alignment and a tile
  too large for a block; the packing pass's tiles from keys on and off
  16-byte alignment;
- the wrappers' argument checks, which raise before anything is built.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.core.hashing import make_params as ref_make_params
from advanced_scrapper_tpu.ops import lsh as ref_lsh
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.ops import _build, lsh, lsh_cuda

import lsh_probe
import myers_probe

U32 = 0xFFFFFFFF


def _t(sig: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(sig).view(np.int32).copy()).view(torch.uint32)


def _ref_rep_bands(keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
    return np.asarray(ref_lsh.duplicate_rep_bands(
        jnp.asarray(keys.astype(np.uint32)), jnp.asarray(valid)))


# -- the candidate stage: packed keys, sort, run heads ----------------------


def _keys_case(name: str) -> tuple[np.ndarray, np.ndarray]:
    """``(keys int64[B, nb], valid bool[B])`` for one edge case."""
    rng = np.random.RandomState(sum(name.encode()))
    if name.startswith("B="):
        B = int(name[2:])
        keys = rng.randint(0, 4, size=(B, 5)).astype(np.int64)
        valid = rng.rand(B) > 0.3
        return keys, valid
    if name == "heavy_ties":
        keys = rng.randint(0, 3, size=(999, 6)).astype(np.int64)
        return keys, rng.rand(999) > 0.1
    if name == "all_invalid":
        keys = rng.randint(0, U32 + 1, size=(301, 4), dtype=np.int64)
        return keys, np.zeros(301, bool)
    if name == "padding_run":
        keys = rng.randint(0, 50, size=(1333, 4)).astype(np.int64)
        valid = np.zeros(1333, bool)
        valid[:400] = rng.rand(400) > 0.05  # 933 padding rows share one U32_MAX run
        return keys, valid
    if name == "valid_u32_max":
        keys = rng.randint(0, 20, size=(517, 3)).astype(np.int64)
        valid = rng.rand(517) > 0.2
        keys[[0, 7, 8, 200, 516], :] = U32  # valid rows whose key is U32_MAX
        valid[[0, 7, 8, 200, 516]] = True
        valid[[1, 3, 9]] = False  # invalid rows in the same U32_MAX run
        return keys, valid
    if name == "random_wide":
        keys = rng.randint(0, U32 + 1, size=(1777, 8), dtype=np.int64)
        keys[100:300] = keys[:200]  # exact copies
        return keys, rng.rand(1777) > 0.02
    raise KeyError(name)


KEY_CASES = ["B=1", "B=2", "B=3", "B=5", "B=37", "B=255", "heavy_ties", "all_invalid",
             "padding_run", "valid_u32_max", "random_wide"]


@pytest.mark.parametrize("case", KEY_CASES)
def test_packed_sort_run_heads_match_the_reference(case):
    keys, valid = _keys_case(case)
    B, nb = keys.shape
    got = lsh.duplicate_rep_bands(torch.from_numpy(keys), torch.from_numpy(valid))
    reps = lsh.duplicate_reps(torch.from_numpy(keys), torch.from_numpy(valid))
    assert got.dtype == torch.int32 and got.shape == (B, 3 * nb)
    if B == 1:  # the reference's two-back shift does not trace at B = 1: self
        assert not got.numpy().any() and not reps.numpy().any()
        return
    assert np.array_equal(got.numpy(), _ref_rep_bands(keys, valid))
    if case not in ("heavy_ties", "padding_run", "valid_u32_max"):
        return  # each reference call compiles anew for its shape
    want = ref_lsh.duplicate_reps(jnp.asarray(keys.astype(np.uint32)), jnp.asarray(valid))
    assert np.array_equal(reps.numpy(), np.asarray(want))


def _packed_sorted(keys: np.ndarray, valid: np.ndarray) -> tuple[torch.Tensor, int]:
    bits = lsh.row_bits(keys.shape[0])
    packed = lsh.pack_keys_plain(torch.from_numpy(keys), torch.from_numpy(valid), bits)
    return torch.sort(packed, dim=1).values, bits


def run_start_search(s: list[int], lo: int, bits: int, threads: int) -> int:
    """The kernel's search for the run start of position ``lo``: ``lo``
    unless its key continues the run of ``lo - 1``; then the first position
    of ``[0, lo]`` with its key, ``threads`` probes a round, each round
    keeping the gap after the last probe below the key."""
    tkey = s[lo] >> bits
    if lo == 0 or s[lo - 1] >> bits != tkey:
        return lo
    a, z, rounds = 0, lo, 0
    while a < z:
        step = -(-(z - a) // threads)
        probes = [a + t * step for t in range(threads)]
        below = [m < z and s[m] >> bits < tkey for m in probes]
        c = sum(below)
        assert below == [True] * c + [False] * (threads - c)  # the block's count is a prefix
        if c == 0:
            z = a
        else:
            a, z = a + (c - 1) * step + 1, min(z, a + c * step)
        rounds += 1
    assert rounds <= max(1, int(np.ceil(np.log(lo + 1) / np.log(threads))) + 1)
    return a


#: rows' bits in one packed int64 record (``kRecBits``)
REC_BITS = 21


def run_heads_walk(sorted_keys: np.ndarray, valid: np.ndarray, bits: int,
                   threads: int = 4, items: int = 3, rows: int = 5,
                   pack: bool | None = None) -> np.ndarray:
    """numpy model of ``astt_lsh_run_heads``: ``run_heads_kernel``, a
    block a tile of ``threads × items`` sorted positions of one band (the
    tile's run start by :func:`run_start_search`, each thread's last run
    start among its items, the exclusive max-scan over the block's
    threads) writing a record a (band, row) whose three rows differ,
    packed into an int64 of three ``REC_BITS`` fields where the rows fit
    (``pack`` None) or as three fields of their own (``pack`` False), into
    records that start all ones; then ``heads_out_kernel``, a block ``rows``
    rows, the records of every band (three equal fields: the row itself)
    through a tile of ``rows × (3 nbt + 1)`` into the rows' contiguous
    columns."""
    nbt, B = sorted_keys.shape
    mask = (1 << bits) - 1
    pack = bits <= REC_BITS if pack is None else pack
    rec = np.full((nbt, B), -1, np.int64) if pack else np.full((nbt, B, 3), -1, np.int64)
    tile = threads * items
    for band in range(nbt):
        s = [int(v) for v in sorted_keys[band]]
        for lo in range(0, B, tile):
            carry = run_start_search(s, lo, bits, threads)
            lasts, starts = [], []
            for t in range(threads):
                p0 = lo + t * items
                prev = s[p0 - 1] >> bits if 0 < p0 < B else -1
                last, st = -1, []
                for i in range(items):
                    p = p0 + i
                    if p < B:
                        key = s[p] >> bits
                        if p == 0 or key != prev:
                            last = p
                        prev = key
                    st.append(last)
                lasts.append(last)
                starts.append(st)
            for t in range(threads):
                before = max([carry, *lasts[:t]])
                for i in range(items):
                    p = lo + t * items + i
                    if p >= B:
                        break
                    v = s[p]
                    key, row = v >> bits, v & mask
                    h = p1 = p2 = row
                    if valid[row]:
                        h = s[max(before, starts[t][i])] & mask
                        if p >= 1 and s[p - 1] >> bits == key:
                            p1 = s[p - 1] & mask
                        if p >= 2 and s[p - 2] >> bits == key:
                            p2 = s[p - 2] & mask
                    if h == p1 == p2:
                        assert h == row  # the run's first row, alone, or invalid
                    elif pack:
                        rec[band, row] = h | p1 << REC_BITS | p2 << 2 * REC_BITS
                    else:
                        rec[band, row] = (h, p1, p2)
    out = np.full((B, 3 * nbt), -9, np.int64)
    field = (1 << REC_BITS) - 1
    for r0 in range(0, B, rows):
        nr = min(rows, B - r0)
        tile_s = np.full((nr, 3 * nbt + 1), -5, np.int64)
        for band in range(nbt):
            for r in range(nr):
                v = rec[band, r0 + r]
                three = [(int(v) >> k * REC_BITS) & field for k in range(3)] if pack else v
                if three[0] == three[1] == three[2]:
                    three = [r0 + r] * 3
                for k in range(3):
                    tile_s[r, k * nbt + band] = three[k]
        out[r0:r0 + nr] = tile_s[:, :3 * nbt]
    return out.astype(np.int32)


@pytest.mark.parametrize("case", KEY_CASES)
def test_run_heads_tile_walk_equals_the_plain_version(case):
    keys, valid = _keys_case(case)
    sorted_keys, bits = _packed_sorted(keys, valid)
    plain = lsh.run_heads_plain(sorted_keys, torch.from_numpy(valid), bits)
    for threads, items, rows, pack in ((4, 3, 5, None), (3, 2, 1, False), (32, 8, 64, None)):
        walk = run_heads_walk(sorted_keys.numpy(), valid, bits, threads, items, rows, pack)
        assert np.array_equal(walk, plain.numpy()), (threads, items, rows, pack)


def radix_sort_walk(packed: np.ndarray, bits: int, radix_bits: int = 8, warps: int = 2,
                    lanes: int = 4, items: int = 3) -> np.ndarray:
    """numpy model of ``astt_lsh_sort``: ``ceil(32 / radix_bits)`` LSD passes
    over the key bits of ``(key << bits) | row``, each over every band.
    ``sort_digits_kernel`` counts every pass's digits of each band once, up
    front (the counts do not depend on the order).  A pass's
    ``sort_scatter_kernel``: warp w takes the tile's positions from
    ``w·lanes·items``, round i ``lanes`` of them; a position's rank is its
    digit's start in the tile plus the digit's count in earlier warps,
    earlier rounds and earlier lanes; the tile staged in digit order, each
    digit's run written from the digit's start in the band (its start in
    the band's counts) plus the earlier tiles' counts, summed by a
    look-back that stops at the first tile that published its inclusive
    count (which tiles did is left to chance)."""
    nbt, B = packed.shape
    bins = 1 << radix_bits
    tile = warps * lanes * items
    ntiles = -(-B // tile)
    src = packed.astype(np.int64)
    passes = -(-32 // radix_bits)
    band_counts = np.stack([[np.bincount((row >> (bits + k * radix_bits)) & (bins - 1),
                                         minlength=bins) for row in src]
                            for k in range(passes)])
    chance = np.random.RandomState(B * nbt)
    for k in range(passes):
        digit = (src >> (bits + k * radix_bits)) & (bins - 1)
        hist = np.zeros((nbt, bins, ntiles), np.int64)
        for t in range(ntiles):
            for band in range(nbt):
                hist[band, :, t] = np.bincount(digit[band, t * tile:(t + 1) * tile],
                                               minlength=bins)
        inclusive = np.cumsum(hist, axis=2)
        ofs = np.zeros((nbt, bins, ntiles), np.int64)
        for band in range(nbt):
            start = np.cumsum(band_counts[k, band]) - band_counts[k, band]
            for t in range(ntiles):
                published = chance.rand(t) < 0.5  # earlier tiles that hold their inclusive
                before = np.zeros(bins, np.int64)
                for u in range(t - 1, -1, -1):
                    if published[u]:
                        before += inclusive[band, :, u]
                        break
                    before += hist[band, :, u]
                ofs[band, :, t] = start + before
        dst = np.full_like(src, -1)
        for band in range(nbt):
            for t in range(ntiles):
                lo = t * tile
                wcnt = np.zeros((warps, bins), np.int64)
                ranked = []
                for w in range(warps):
                    for i in range(items):
                        ps = [lo + (w * items + i) * lanes + lane for lane in range(lanes)]
                        ds = [int(digit[band, p]) if p < B else bins for p in ps]
                        for lane, p in enumerate(ps):
                            if p < B:
                                d = ds[lane]
                                ranked.append((src[band, p], d, w,
                                               wcnt[w, d] + ds[:lane].count(d)))
                        for d in set(ds) - {bins}:
                            wcnt[w, d] += ds.count(d)
                prefix = np.cumsum(wcnt, axis=0) - wcnt
                total = wcnt.sum(axis=0)
                start = np.cumsum(total) - total
                n = min(tile, B - lo)
                stage = np.full(n, -1, np.int64)
                for v, d, w, r in ranked:
                    assert stage[start[d] + prefix[w, d] + r] == -1
                    stage[start[d] + prefix[w, d] + r] = v
                for q in range(n):
                    d = (stage[q] >> (bits + k * radix_bits)) & (bins - 1)
                    dst[band, ofs[band, d, t] + q - start[d]] = stage[q]
        assert (dst >= 0).all()
        src = dst
    return src


@pytest.mark.parametrize("case", KEY_CASES)
def test_radix_sort_walk_equals_torch_sort(case):
    keys, valid = _keys_case(case)
    bits = lsh.row_bits(keys.shape[0])
    packed = lsh.pack_keys_plain(torch.from_numpy(keys), torch.from_numpy(valid), bits)
    want = lsh.sort_plain(packed)
    for radix_bits, warps, lanes, items in ((8, 2, 4, 3), (5, 3, 2, 2), (8, 8, 32, 16)):
        got = radix_sort_walk(packed.numpy(), bits, radix_bits, warps, lanes, items)
        assert np.array_equal(got, want.numpy()), (radix_bits, warps, lanes, items)
    if keys.shape[0] > 1:  # the reference's candidates from the model's order
        got_rb = lsh.run_heads_plain(torch.from_numpy(got), torch.from_numpy(valid), bits)
        assert np.array_equal(got_rb.numpy(), _ref_rep_bands(keys, valid))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_sort_needs_rows_ascending(seed):
    """``lsh_sort`` sorts by the key bits alone, stably: rows that enter
    ascending, as ``pack_keys`` writes them, come out in the (key, row)
    order of ``torch.sort``; the same packed keys with their rows in
    another order come out by key and then in the order they entered,
    which is not that (the wrapper's precondition)."""
    rng = np.random.RandomState(seed)
    B = 40
    keys = rng.randint(0, 3, size=(B, 2)).astype(np.int64)
    valid = rng.rand(B) > 0.2
    bits = lsh.row_bits(B)
    packed = lsh.pack_keys_plain(torch.from_numpy(keys), torch.from_numpy(valid), bits).numpy()
    assert np.array_equal(radix_sort_walk(packed, bits), np.sort(packed, axis=1))
    shuffled = packed[:, rng.permutation(B)]
    got = radix_sort_walk(shuffled, bits)
    stable = np.argsort(shuffled >> bits, axis=1, kind="stable")
    assert np.array_equal(got, np.take_along_axis(shuffled, stable, axis=1))
    assert not np.array_equal(got, np.sort(shuffled, axis=1))


@pytest.mark.parametrize("B", [1, 2, 23, 24, 25, 97])
def test_radix_sort_walk_over_bands_of_many_lengths(B):
    """Bands of B rows, 1 to 7 of them, ties within and across tiles of
    24 (B one short of, at and past a tile), invalid rows at ``U32_MAX``
    beside valid rows whose key is ``U32_MAX``."""
    rng = np.random.RandomState(B)
    for nbt in (1, 3, 7):
        keys = rng.randint(0, 6, size=(B, nbt)).astype(np.int64) * 0x2F0F0F1
        keys[rng.rand(B, nbt) < 0.1] = U32
        valid = rng.rand(B) > 0.25
        bits = lsh.row_bits(B)
        packed = lsh.pack_keys_plain(torch.from_numpy(keys), torch.from_numpy(valid), bits)
        got = radix_sort_walk(packed.numpy(), bits)
        assert np.array_equal(got, lsh.sort_plain(packed).numpy()), nbt


def test_row_bits_bound():
    assert [lsh.row_bits(b) for b in (1, 2, 3, 65536, 65537, 1 << 31)] == [1, 1, 2, 16, 17, 31]
    with pytest.raises(ValueError, match="at most 31"):
        lsh.row_bits((1 << 31) + 1)


# -- the label rounds --------------------------------------------------------


def label_edge_lists(rep: np.ndarray, ok: np.ndarray) -> list[list[int]]:
    """numpy model of ``label_edges_kernel``: a warp a row, its columns in
    groups of 32 lanes; a lane's candidate counts when ok, in ``[0, B)``
    and not the row; ``match_any`` leaves the group's first lane of each
    value, which is dropped if the row's list already holds it; the fresh
    ones are appended in lane order (a ballot's prefix)."""
    B, nc = rep.shape
    lists = []
    for b in range(B):
        lst: list[int] = []
        for c0 in range(0, nc, 32):
            first: dict[int, int] = {}
            for c in range(c0, min(nc, c0 + 32)):
                j = int(rep[b, c])
                if ok[b, c] and j != b and 0 <= j < B:
                    first.setdefault(j, c)
            lst += [j for j, _c in sorted(first.items(), key=lambda t: t[1]) if j not in lst]
        assert len(lst) == len(set(lst)) <= nc  # the scratch's [B, nc] holds every list
        lists.append(lst)
    return lists


def label_walk(rep: np.ndarray, ok: np.ndarray, valid: np.ndarray,
               rounds: int) -> tuple[np.ndarray, int]:
    """numpy model of ``astt_lsh_label``: the edge lists
    (:func:`label_edge_lists`; ``x = z0 = arange(B)``, the stamp 0), then
    ``label_rounds_kernel``'s rounds: the pull over the lists, rows in a
    shuffled order (atomics land in any order), into ``z[r & 1]`` (which
    equals ``x``); a grid sync; the jump ``n = z[z]`` into ``x`` and
    ``z[(r + 1) & 1]``, the stamp set to ``r + 1`` where ``n`` differs from
    ``x``; a grid sync; stop unless the stamp reads ``r + 1``.  Then ``out
    = valid ? x : row``.  Returns ``(out, rounds run)``."""
    B = rep.shape[0]
    lists = label_edge_lists(rep, ok)
    x = np.arange(B)
    z = [np.arange(B), np.full(B, -7)]  # z1 is written before it is read
    stamp, ran = 0, 0
    rng = np.random.RandomState(B + rounds)
    for r in range(rounds):
        zr, zn = z[r & 1], z[(r + 1) & 1]
        assert np.array_equal(zr, x)
        for b in rng.permutation(B):
            if lists[b]:
                m = min(x[b], *(x[j] for j in lists[b]))
                zr[b] = min(zr[b], m)
                for j in lists[b]:
                    zr[j] = min(zr[j], m)
        n = zr[zr]
        if (n != x).any():
            stamp = r + 1
        x = n.copy()
        zn[:] = n
        ran += 1
        if stamp != r + 1:
            break
    return np.where(valid, x, np.arange(B)).astype(np.int32), ran


def _graph(name: str):
    """``(rep int32[B, nc], ok bool[B, nc], valid bool[B])``."""
    rng = np.random.RandomState(len(name))
    if name == "chain64":
        # a path 0 - 1 - ... - 63 whose edges all point forward: the min
        # label needs many rounds to reach the far end
        B, nc = 64, 3
        rep = np.tile(np.arange(B, dtype=np.int32)[:, None], (1, nc))
        rep[:-1, 0] = np.arange(1, B)
        ok = rep != np.arange(B)[:, None]
        return rep, ok, np.ones(B, bool)
    if name == "repeat_pairs":
        # the main corpus's pattern: 144 columns of self and one or two
        # candidates repeated, in and across groups of 32 columns
        B, nc = 300, 144
        pick = rng.randint(0, 3, size=(B, nc))
        two = rng.randint(0, B, size=(B, 2))
        rep = np.where(pick == 1, two[:, :1], np.where(pick == 2, two[:, 1:], np.arange(B)[:, None]))
        return rep.astype(np.int32), rng.rand(B, nc) < 0.9, rng.rand(B) > 0.05
    if name == "all_distinct":
        # every column distinct and ok: the edge lists fill their scratch
        B, nc = 160, 144
        rep = (np.arange(B)[:, None] + 1 + np.arange(nc)[None, :]) % B
        return rep.astype(np.int32), np.ones((B, nc), bool), np.ones(B, bool)
    if name == "chain_shuffled":
        # a path through every row in a shuffled order, backward edges and
        # out-of-range candidates beside it: no round before the last is a
        # fixed point
        B, nc = 512, 3
        order = rng.permutation(B)
        rep = np.tile(np.arange(B, dtype=np.int32)[:, None], (1, nc))
        rep[order[1:], 0] = order[:-1]
        rep[:, 2] = rng.choice([-1, B, B + 5], size=B)
        return rep, np.ones((B, nc), bool), np.ones(B, bool)
    B, nc = {"random_sparse": (500, 6), "random_dense": (257, 12)}[name]
    rep = rng.randint(0, B, size=(B, nc)).astype(np.int32)
    ok = rng.rand(B, nc) < (0.2 if name == "random_sparse" else 0.5)
    valid = rng.rand(B) > 0.05
    return rep, ok, valid


@pytest.mark.parametrize("name", ["chain64", "random_sparse", "random_dense", "repeat_pairs",
                                  "all_distinct", "chain_shuffled"])
@pytest.mark.parametrize("rounds", [0, 1, 2, "full"])
def test_label_rounds_match_the_reference(name, rounds):
    rep, ok, valid = _graph(name)
    B = rep.shape[0]
    n = int(np.ceil(np.log2(B))) if rounds == "full" else rounds
    ref_ok = ok & (rep >= 0) & (rep < B)  # the reference takes candidates in range
    want = np.asarray(ref_lsh.resolve_rep_bands_from_ok(
        jnp.asarray(rep), jnp.asarray(ref_ok), jnp.asarray(valid), jump_rounds=n))
    got = lsh.resolve_rep_bands_from_ok(
        torch.from_numpy(rep), torch.from_numpy(ref_ok), torch.from_numpy(valid), jump_rounds=n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    walk, ran = label_walk(rep, ok, valid, n)
    assert np.array_equal(walk, want)
    if name.startswith("chain") and rounds in (1, 2):
        assert (want != 0).any()  # truncated: the far end has not heard of row 0
    if name == "chain_shuffled":
        assert ran == n and (want != 0).any()  # every round ran, and was not enough
    if name == "all_distinct" and rounds == "full":
        assert ran < n and not want.any()  # one component: the rounds stop early


# -- the agreement pass at its bars -------------------------------------------

#: agreements (of 128) and whether the pair shares a coarse band
PAIRS = [(k, shared) for k in (89, 90, 92, 93, 95, 96, 97, 128) for shared in (False, True)]


@pytest.fixture(scope="module")
def boundary():
    """Rows 2i and 2i+1 agree on exactly ``k`` of 128 words; the words
    that differ hit every coarse band of 8 words unless the pair shares
    one (band 0 left whole).  Row 2i+1's candidates: 2i in every column.
    The last pair's second row is invalid."""
    rng = np.random.RandomState(5)
    n = len(PAIRS)
    sig = rng.randint(0, 1 << 32, size=(2 * n, 128), dtype=np.uint64).astype(np.uint32)
    for i, (k, shared) in enumerate(PAIRS):
        diff = 128 - k
        bands = list(range(1 if shared else 0, 16))
        first = [8 * b + rng.randint(8) for b in bands][:diff]
        rest = [p for p in range(8 if shared else 0, 128) if p not in first]
        pos = first + list(rng.choice(rest, diff - len(first), replace=False))
        row = sig[2 * i].copy()
        row[pos] ^= np.uint32(0x5A5A5A5A)
        sig[2 * i + 1] = row
    valid = np.ones(2 * n, bool)
    valid[-1] = False
    keys = lsh._coarse_fine_keys(_t(sig), make_params().band_salt, lsh.subband_salt(32))
    nk = keys.shape[1]
    rep = np.tile(np.arange(2 * n, dtype=np.int32)[:, None], (1, 3 * nk))
    rep[1::2] = np.arange(0, 2 * n, 2, dtype=np.int32)[:, None]
    return sig, valid, keys, rep


def _ref_keys(keys: torch.Tensor):
    return jnp.asarray(keys.numpy().astype(np.uint32))


@pytest.mark.parametrize("threshold", [0.75, 0.7, 0.72, 96 / 128, "column", "edge"])
def test_resolve_at_exact_bars(boundary, threshold):
    sig, valid, keys, rep = boundary
    nc = rep.shape[1]
    if threshold == "column":
        thr = np.where(np.arange(nc) % 2, np.float32(0.75), np.float32(0.7)).astype(np.float32)
    elif threshold == "edge":
        thr = np.where(np.arange(rep.size).reshape(rep.shape) % 3, 0.75, 0.7).astype(np.float32)
    else:
        thr = threshold
    got = lsh.resolve_rep_bands(torch.from_numpy(rep), _t(sig), torch.from_numpy(valid),
                                torch.from_numpy(thr) if isinstance(thr, np.ndarray) else thr,
                                jump_rounds=6)
    want = ref_lsh.resolve_rep_bands(jnp.asarray(rep), jnp.asarray(sig), jnp.asarray(valid),
                                     jnp.asarray(thr) if isinstance(thr, np.ndarray) else thr,
                                     jump_rounds=6)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if threshold == 0.75:  # 96 of 128 is exactly 0.75: merged
        i96, i95 = PAIRS.index((96, False)), PAIRS.index((95, False))
        assert got[2 * i96 + 1] == 2 * i96 and got[2 * i95 + 1] == 2 * i95 + 1


@pytest.mark.parametrize("base,margin,band", [
    (0.7, 0.05, 0.72), (0.7, 0.05, 0.75), (0.71, 0.04, 0.75), (0.6875, 0.0625, 0.7265625),
    (0.7, 0.0, 0.72),
])
def test_fine_bars_and_borderline_at_boundaries(boundary, base, margin, band):
    sig, valid, keys, rep = boundary
    rk = _ref_keys(keys)
    got = lsh.fine_edge_thresholds(torch.from_numpy(rep), keys, base, margin, num_coarse=16)
    want = ref_lsh.fine_edge_thresholds(jnp.asarray(rep), rk, base, margin, num_coarse=16)
    assert np.array_equal(got.numpy(), np.asarray(want))
    got_r = lsh.fused_resolve_epilogue(
        _t(sig), torch.from_numpy(valid), make_params().band_salt, lsh.subband_salt(32), base,
        margin, num_coarse=16, jump_rounds=6, use_fine_margin=True)
    want_r = ref_lsh.fused_resolve_epilogue(
        jnp.asarray(sig), jnp.asarray(valid), np.asarray(ref_make_params().band_salt),
        ref_lsh.subband_salt(32), base, margin, densify_oph=False, num_coarse=16,
        jump_rounds=6, use_fine_margin=True)
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    need, ok = lsh.borderline_edge_mask(torch.from_numpy(rep), _t(sig), keys,
                                        torch.from_numpy(valid), base, band, num_coarse=16)
    want_need, want_ok = ref_lsh.borderline_edge_mask(
        jnp.asarray(rep), jnp.asarray(sig), rk, jnp.asarray(valid), base, band, num_coarse=16)
    assert np.array_equal(need.numpy(), np.asarray(want_need))
    assert np.array_equal(ok.numpy(), np.asarray(want_ok))
    model = verify_walk(rep, sig, valid, keys.numpy(), 16, base=base, band=band,
                        strict=lsh.strict_bar(base, margin))
    assert np.array_equal(model["ok"], ok.numpy())
    assert np.array_equal(model["need"], need.numpy())
    assert np.array_equal(model["bars"], got.numpy())
    assert np.array_equal(model["ok_fine"], verify_ok_fine(rep, sig, valid, got))


def verify_ok_fine(rep, sig, valid, bars) -> np.ndarray:
    """The plain ``ok`` of :func:`lsh.resolve_rep_bands` against per-edge
    bars: the fine-bar mode of the kernel computes the same matrix."""
    s = sig.view(np.int32)
    agree = (s[:, None, :] == s[rep]).sum(2).astype(np.float32) / np.float32(s.shape[1])
    return (agree >= bars.numpy()) & valid[:, None] & valid[rep]


def verify_walk(rep, sig, valid, keys, num_coarse, *, base, band, strict) -> dict:
    """numpy model of ``verify_kernel``'s per-edge logic: the count of
    equal words (P for self, 0 out of range), ``count / P`` in float32,
    the fine-only test of column ``c % nk``, each mode's bar."""
    B, nc = rep.shape
    P, nk = sig.shape[1], keys.shape[1]
    res = {k: np.zeros((B, nc), bool) for k in ("ok", "need", "ok_fine")}
    res["bars"] = np.zeros((B, nc), np.float32)
    for b in range(B):
        for c in range(nc):
            j = int(rep[b, c])
            in_range = 0 <= j < B
            count = P if j == b else int((sig[b] == sig[j]).sum()) if in_range else 0
            fo = in_range and c % nk >= num_coarse and not (
                keys[b, :num_coarse] == keys[j, :num_coarse]).any()
            agree = np.float32(count) / np.float32(P)
            both = in_range and valid[b] and valid[j]
            res["bars"][b, c] = np.float32(strict) if fo else np.float32(base)
            ok = both and agree >= np.float32(base)
            res["ok"][b, c] = ok
            res["need"][b, c] = ok and j != b and (fo or agree < np.float32(band))
            res["ok_fine"][b, c] = both and agree >= res["bars"][b, c]
    return res


def verify_compact_walk(rep, sig, valid, keys, num_coarse, *, thr=None, base=0.0,
                        strict=None, band=None, chunk=192, lanes=32, sub=16,
                        rounds=(1, 2, 4, 8)) -> dict:
    """numpy model of ``verify_kernel``'s compaction and grouping, a warp
    of ``lanes`` a row: each chunk of ``chunk`` columns, in groups of
    ``lanes``, gives its non-self in-range candidates slots, each distinct
    candidate once (the first lane of a group holding it takes a slot
    unless an earlier group's slot holds it; the new slots in lane order);
    each slot's count is summed the way the lanes split it (``sub`` lanes
    a candidate, lane g the 4 words ``4(r·sub + g)`` of round r, where ``P
    = 4·sub·R`` with R in ``rounds``; else a lane every ``lanes``-th
    word), whether it shares a coarse key (lane g the keys ``g + sub·i``,
    or every ``lanes``-th) and whether it is valid; then each column's bar
    and edge from its slot.  Returns ``ok``, ``need`` and ``bars``."""
    B, nc = rep.shape
    P = 0 if sig is None else sig.shape[1]
    fast = sig is not None and P % (4 * sub) == 0 and P // (4 * sub) in rounds
    step = sub if fast else lanes
    res = {"ok": np.zeros((B, nc), bool), "need": np.zeros((B, nc), bool),
           "bars": np.zeros((B, nc), np.float32)}
    for b in range(B):
        for c0 in range(0, nc, chunk):
            cn = min(chunk, nc - c0)
            uj, slot_of = [], [None] * cn
            for g0 in range(0, cn, lanes):
                js = [int(rep[b, c0 + g0 + lane]) if g0 + lane < cn else b
                      for lane in range(lanes)]
                cand = [g0 + lane < cn and j != b and 0 <= j < B for lane, j in enumerate(js)]
                first = {}
                for lane in range(lanes):
                    if cand[lane] and js[lane] not in first:
                        first[js[lane]] = uj.index(js[lane]) if js[lane] in uj else len(uj)
                        if first[js[lane]] == len(uj):
                            uj.append(js[lane])
                    if cand[lane]:
                        slot_of[g0 + lane] = first[js[lane]]
            assert len(set(uj)) == len(uj) <= cn
            count, shares, vflag = [], [], []
            for j in uj:
                if sig is None:
                    count.append(0)
                else:
                    words = []
                    if fast:
                        for r in range(P // (4 * sub)):
                            for g in range(sub):
                                words += range(4 * (r * sub + g), 4 * (r * sub + g) + 4)
                    else:
                        for lane in range(lanes):
                            words += range(lane, P, lanes)
                    assert sorted(words) == list(range(P))  # each word once
                    count.append(int((sig[b, words] == sig[j, words]).sum()))
                eq = keys is not None and any(
                    keys[j, i] == keys[b, i] for g in range(step)
                    for i in range(g, num_coarse, step))
                shares.append(eq)
                vflag.append(valid is not None and bool(valid[j]))
            for cl in range(cn):
                c = c0 + cl
                j = int(rep[b, c])
                in_range = 0 <= j < B
                if j == b:
                    n, sh, vj = P, num_coarse > 0, valid is not None and bool(valid[b])
                elif slot_of[cl] is not None:
                    u = slot_of[cl]
                    n, sh, vj = count[u], shares[u], vflag[u]
                else:
                    n, sh, vj = 0, True, False
                fo = keys is not None and in_range and c % keys.shape[1] >= num_coarse and not sh
                res["bars"][b, c] = np.float32(strict) if fo else np.float32(base)
                if sig is None:
                    continue
                agree = np.float32(n) / np.float32(P)
                if thr is not None:
                    bar = thr[c] if thr.ndim == 1 else thr[b, c]
                elif strict is not None:
                    bar = res["bars"][b, c]
                else:
                    bar = np.float32(base)
                ok = in_range and agree >= bar and bool(valid[b]) and vj
                res["ok"][b, c] = ok
                res["need"][b, c] = ok and j != b and (
                    fo or (band is not None and agree < np.float32(band)))
    return res


#: (chunk, lanes, sub): the kernel's, and small ones whose groups, chunks
#: and candidates a warp split the boundary pairs' 144 columns many ways
VERIFY_SHAPES = [(192, 32, 16), (192, 32, 8), (10, 4, 2), (7, 8, 4)]


@pytest.mark.parametrize("base,margin,band", [
    (0.7, 0.05, 0.72), (0.75, 0.0, 0.75), (0.6875, 0.0625, 0.7265625),
])
@pytest.mark.parametrize("shape", VERIFY_SHAPES)
def test_verify_compaction_at_boundaries(boundary, base, margin, band, shape):
    """The compacted, grouped agreement equals the reference's at the exact
    bars and at ``base + fine_margin`` (the boundary rows name their pair
    in every column: every candidate repeats)."""
    sig, valid, keys, rep = boundary
    chunk, lanes, sub = shape
    strict = lsh.strict_bar(base, margin)
    kw = dict(chunk=chunk, lanes=lanes, sub=sub)
    model = verify_compact_walk(rep, sig.view(np.int32), valid, keys.numpy(), 16, base=base,
                                band=band, strict=None, **kw)
    need, ok = ref_lsh.borderline_edge_mask(
        jnp.asarray(rep), jnp.asarray(sig), _ref_keys(keys), jnp.asarray(valid), base, band,
        num_coarse=16)
    assert np.array_equal(model["ok"], np.asarray(ok))
    assert np.array_equal(model["need"], np.asarray(need))
    fine = verify_compact_walk(rep, sig.view(np.int32), valid, keys.numpy(), 16, base=base,
                               strict=strict, **kw)
    bars = ref_lsh.fine_edge_thresholds(jnp.asarray(rep), _ref_keys(keys), base, margin,
                                        num_coarse=16)
    assert np.array_equal(fine["bars"], np.asarray(bars))
    plain = lsh.verify_plain(torch.from_numpy(rep), torch.from_numpy(valid), _t(sig), base=base,
                             strict=strict, keys=keys, num_coarse=16)[0]
    assert np.array_equal(fine["ok"], plain.numpy())


@pytest.mark.parametrize("P", [30, 36, 64, 128])
@pytest.mark.parametrize("shape", VERIFY_SHAPES)
def test_verify_compaction_any_width(P, shape):
    """P not a multiple of 4 (30) or of 32 (36) takes the general path,
    64 and 128 the fast one at the kernel's shape; words from a 3-letter
    alphabet put agreements on the bars; candidates repeat within rows;
    the keys share coarse values at random.  Candidates outside ``[0, B)``
    (no edge; the plain version takes none) against the per-edge model."""
    rng = np.random.RandomState(P + shape[0])
    B, nk, num_coarse = 41, 6, 2
    sig = rng.randint(0, 3, size=(B, P)).astype(np.uint32)
    sig[1::4] = sig[0::4][: len(sig[1::4])]  # exact copies
    valid = rng.rand(B) > 0.15
    keys = rng.randint(0, 3, size=(B, nk)).astype(np.int64)
    rep = rng.randint(-2, B + 2, size=(B, 3 * nk)).astype(np.int32)
    rep[:, ::2] = rep[:, :1]  # the same candidate in many columns
    rep[::5, 1] = np.arange(0, B, 5)  # self
    base, band, strict = 0.5, 0.6, 0.55
    chunk, lanes, sub = shape
    kw = dict(chunk=chunk, lanes=lanes, sub=sub)
    model = verify_compact_walk(rep, sig.view(np.int32), valid, keys, num_coarse, base=base,
                                band=band, **kw)
    edge = verify_walk(rep, sig, valid, keys, num_coarse, base=base, band=band, strict=strict)
    assert np.array_equal(model["ok"], edge["ok"])
    assert np.array_equal(model["need"], edge["need"])
    fine = verify_compact_walk(rep, sig.view(np.int32), valid, keys, num_coarse, base=base,
                               strict=strict, **kw)
    assert np.array_equal(fine["bars"], edge["bars"])
    assert np.array_equal(fine["ok"], edge["ok_fine"])
    rep = np.where((rep >= 0) & (rep < B), rep, np.arange(B)[:, None]).astype(np.int32)
    model = verify_compact_walk(rep, sig.view(np.int32), valid, keys, num_coarse, base=base,
                                band=band, **kw)
    plain = lsh.verify_plain(torch.from_numpy(rep), torch.from_numpy(valid), _t(sig), base=base,
                             band=band, keys=torch.from_numpy(keys), num_coarse=num_coarse)
    assert np.array_equal(model["ok"], plain[0].numpy())
    assert np.array_equal(model["need"], plain[1].numpy())
    thr = np.where(np.arange(3 * nk) % 2, np.float32(0.5), np.float32(0.6)).astype(np.float32)
    model = verify_compact_walk(rep, sig.view(np.int32), valid, None, 0, thr=thr, **kw)
    plain = lsh.verify_plain(torch.from_numpy(rep), torch.from_numpy(valid), _t(sig),
                             thr=torch.from_numpy(thr))[0]
    assert np.array_equal(model["ok"], plain.numpy())
    want = np.asarray(ref_lsh.resolve_rep_bands(
        jnp.asarray(rep), jnp.asarray(sig), jnp.asarray(valid), jnp.asarray(thr),
        jump_rounds=6))
    got = lsh.resolve_rep_bands(torch.from_numpy(rep), _t(sig), torch.from_numpy(valid),
                                torch.from_numpy(thr), jump_rounds=6)
    assert np.array_equal(got.numpy(), want)


# -- the keys ----------------------------------------------------------------


def keys_walk(sig: np.ndarray, salts: np.ndarray, nb: int, nf: int, wide: bool) -> np.ndarray:
    """numpy model of the fold each (row, key set) of ``keys_kernel``
    runs: ``P/nb`` (or ``P/nf``) words from ``j·r`` in uint32, XOR
    ``salts[j]``, fmix32 (:func:`keys_tile_walk` models the tiles)."""
    B, P = sig.shape

    def fmix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    out = np.zeros((B, nb + nf, 2), np.uint32)
    with np.errstate(over="ignore"):
        for j in range(nb + nf):
            r = P // nb if j < nb else P // nf
            w = sig[:, (j if j < nb else j - nb) * r:][:, :r]
            for lane, (off, prime) in enumerate(((0x811C9DC5, 0x01000193),
                                                 (lsh.WIDE_OFFSET, lsh.WIDE_PRIME))):
                k = np.full(B, off, np.uint32)
                for i in range(r):
                    k = (k ^ w[:, i]) * np.uint32(prime)
                s = np.uint32(salts[j])
                s = s if lane == 0 else np.uint32(((int(s) << 13) | (int(s) >> 19)) & U32)
                out[:, j, lane] = fmix(k ^ s)
    return out if wide else out[:, :, 0]


@pytest.mark.parametrize("cs,wide", [(32, False), (0, False), (0, True), (64, False)])
def test_keys_walk_matches_the_reference(cs, wide):
    rng = np.random.RandomState(cs + wide)
    sig = rng.randint(0, 1 << 32, size=(333, 128), dtype=np.uint64).astype(np.uint32)
    sig[::7] = U32  # rows of a signature with no shingle
    salt = make_params().band_salt
    fine = lsh.subband_salt(cs) if cs else np.zeros((0,), np.uint32)
    walk = keys_walk(sig, np.concatenate([salt, fine]), len(salt), cs, wide)
    if wide:
        want = np.asarray(ref_lsh.band_keys_wide(jnp.asarray(sig), jnp.asarray(salt)))
        got = lsh.fused_keys_epilogue(_t(sig), salt, fine, densify_oph=False, wide=True)[1]
    else:
        want = np.asarray(ref_lsh.candidate_keys(jnp.asarray(sig), salt, cs))
        got = lsh.fused_keys_epilogue(_t(sig), salt, fine, densify_oph=False, wide=False)[1]
    assert np.array_equal(walk, want)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    if not wide:  # the packed sort keys the same launch writes
        valid = rng.rand(333) > 0.1
        bits = lsh.row_bits(333)
        packed = lsh.pack_keys_plain(got, torch.from_numpy(valid), bits).numpy()
        k = np.where(valid[:, None], want.astype(np.int64), U32)
        assert np.array_equal(packed, ((k << bits) | np.arange(333)[:, None]).T)


#: rows a keys tile (``kKeyRows``), threads and warps a block, shared
#: memory a block may opt in to (``kMaxBlockSmem``), KeysLoad
KEY_ROWS, THREADS, WARPS, MAX_BLOCK_SMEM = 32, 256, 8, 232448
LOAD_GLOBAL, LOAD_WORDS, LOAD_VEC = 0, 1, 2


def key_stage_words(ncol: int) -> int:
    return (KEY_ROWS * (ncol | 1) + 3) & ~3


def keys_plan(aligned: bool, P: int, nb: int, nf: int, wide: bool) -> tuple[int, int, int]:
    """``keys_plan`` of ``csrc/lsh.cu``: ``(load, pitch, shared bytes)``."""
    stage = 4 * key_stage_words(2 * nb if wide else nb + nf)
    if aligned and P % 4 == 0 and (P // nb) % 4 == 0 and (nf == 0 or (P // nf) % 4 == 0):
        pitch = 4 * ((P // 4) | 1)
        if stage + 4 * KEY_ROWS * pitch <= MAX_BLOCK_SMEM:
            return LOAD_VEC, pitch, stage + 4 * KEY_ROWS * pitch
    pitch = P | 1
    if stage + 4 * KEY_ROWS * pitch <= MAX_BLOCK_SMEM:
        return LOAD_WORDS, pitch, stage + 4 * KEY_ROWS * pitch
    return LOAD_GLOBAL, 0, stage


def keys_tile_walk(sig: np.ndarray, salts: np.ndarray, nb: int, nf: int, wide: bool,
                   valid: np.ndarray | None = None, bits: int = 0,
                   aligned: bool = True) -> tuple[np.ndarray, np.ndarray | None, int]:
    """numpy model of ``astt_lsh_keys``'s ``keys_kernel<load>``: a block
    takes rows ``[r0, r0 + KEY_ROWS)``; its flat shared memory (words, set
    to a marker a read of an unwritten word would show) holds the staged
    keys (``KEY_ROWS × (ncol | 1)``, rounded to 4 words), then the tile:
    16-byte words at ``pitch / 4`` a row (``i → r·p4 + i − r·c4``) or
    words at ``pitch`` (``i → r·pitch + i − r·P``); warp w folds sets w, w
    + WARPS, ... with lane l over row r0 + l (4 words at a time from the
    16-byte tile) and stores ``lane·kp + j`` (wide: ``2j``, ``2j + 1``) and
    the packed key ``j·B + b``; the tile's keys leave in pairs ``(e, e +
    1)``, the second one's (row, column) carried past the row's end.
    Returns ``(keys, packed, load)``."""
    B, P = sig.shape
    nk, ncol = nb + nf, 2 * nb if wide else nb + nf
    kp = ncol | 1
    load, pitch, smem = keys_plan(aligned, P, nb, nf, wide)
    flat = sig.reshape(-1)
    keys = np.full(B * ncol, -3, np.int64)
    packed = np.full((nk, B), -3, np.int64) if valid is not None else None
    marker = np.uint32(0xA5A5A5A5)
    for r0 in range(0, B, KEY_ROWS):
        nr = min(KEY_ROWS, B - r0)
        sm = np.full(smem // 4, marker, np.uint32)
        written = np.zeros(smem // 4, bool)
        base = key_stage_words(ncol)
        rows = flat[r0 * P:]
        if load == LOAD_VEC:
            c4, p4 = P // 4, pitch // 4
            i = np.arange(nr * c4)
            r = i // c4
            dst = base + 4 * (r * p4 + i - r * c4)
            for k in range(4):
                sm[dst + k] = rows[4 * i + k]
                written[dst + k] = True
        elif load == LOAD_WORDS:
            i = np.arange(nr * P)
            r = i // P
            sm[base + r * pitch + i - r * P] = rows[i]
            written[base + r * pitch + i - r * P] = True
        lanes = np.arange(nr)
        for warp in range(WARPS):
            for j in range(warp, nk, WARPS):
                width = P // nb if j < nb else P // nf
                start = (j if j < nb else j - nb) * width
                if load == LOAD_GLOBAL:
                    words = np.stack([flat[(r0 + lanes) * P + start + i] for i in range(width)], 1)
                else:
                    at = base + lanes[:, None] * pitch + start + np.arange(width)[None, :]
                    assert written[at].all()
                    words = sm[at]
                if load == LOAD_VEC:
                    assert width % 4 == 0 and (base + start) % 4 == 0 and pitch % 4 == 0
                lanes_out = []
                for off, prime in ((0x811C9DC5, 0x01000193), (lsh.WIDE_OFFSET, lsh.WIDE_PRIME)):
                    k = np.full(nr, off, np.uint32)
                    with np.errstate(over="ignore"):
                        for i in range(width):
                            k = (k ^ words[:, i]) * np.uint32(prime)
                    lanes_out.append(k)
                    if not wide:
                        break
                salt = int(salts[j])
                lo = _fmix(lanes_out[0] ^ np.uint32(salt))
                if wide:
                    rot = np.uint32(((salt << 13) | (salt >> 19)) & U32)
                    sm[lanes * kp + 2 * j] = lo
                    sm[lanes * kp + 2 * j + 1] = _fmix(lanes_out[1] ^ rot)
                    written[lanes * kp + 2 * j] = written[lanes * kp + 2 * j + 1] = True
                    continue
                sm[lanes * kp + j] = lo
                written[lanes * kp + j] = True
                if packed is not None:
                    k = np.where(valid[r0 + lanes], lo.astype(np.int64), U32)
                    packed[j, r0 + lanes] = (k << bits) | (r0 + lanes)
        n = nr * ncol
        for t in range(THREADS):
            for e in range(2 * t, n, 2 * THREADS):
                r, c = divmod(e, ncol)
                assert written[r * kp + c]
                keys[r0 * ncol + e] = sm[r * kp + c]
                if e + 1 == n:
                    break
                c += 1
                if c == ncol:
                    r, c = r + 1, 0
                assert written[r * kp + c] and (r0 * ncol + e) % 2 == 0
                keys[r0 * ncol + e + 1] = sm[r * kp + c]
    shape = (B, nb, 2) if wide else (B, nk)
    return keys.reshape(shape), packed, load


def _fmix(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))


#: (B, P, coarse, fine, wide, aligned, the load it takes): a tile at, one
#: below and one past 32 rows and one row; P = 36 with odd band widths, at
#: 9 bands (16-byte words, 9 a row), wide; a signature off 16-byte
#: alignment; a tile too large for a block
KEY_TILE_CASES = [
    (1, 128, 16, 32, False, True, LOAD_VEC), (31, 128, 16, 32, False, True, LOAD_VEC),
    (32, 128, 16, 32, False, True, LOAD_VEC), (33, 128, 16, 32, False, True, LOAD_VEC),
    (65, 128, 16, 0, True, True, LOAD_VEC), (70, 36, 12, 18, False, True, LOAD_WORDS),
    (70, 36, 12, 0, True, True, LOAD_WORDS), (70, 36, 9, 0, False, True, LOAD_VEC),
    (45, 128, 16, 32, False, False, LOAD_WORDS), (40, 2048, 16, 32, False, True, LOAD_GLOBAL),
]


@pytest.mark.parametrize("case", KEY_TILE_CASES, ids=lambda c: "-".join(map(str, c[:6])))
def test_keys_tile_walk_matches_the_reference(case):
    B, P, nb, nf, wide, aligned, load = case
    rng = np.random.RandomState(B + P + nb + nf)
    sig = rng.randint(0, 1 << 32, size=(B, P), dtype=np.uint64).astype(np.uint32)
    sig[::5] = U32
    salt = make_params().band_salt[:nb]
    fine = lsh.subband_salt(nf) if nf else np.zeros((0,), np.uint32)
    valid = rng.rand(B) > 0.25
    bits = lsh.row_bits(B)
    keys, packed, got_load = keys_tile_walk(sig, np.concatenate([salt, fine]), nb, nf, wide,
                                            None if wide else valid, bits, aligned)
    assert got_load == load
    if wide:
        want = np.asarray(ref_lsh.band_keys_wide(jnp.asarray(sig), jnp.asarray(salt)))
    elif nf:
        want = np.asarray(ref_lsh._coarse_fine_keys(jnp.asarray(sig), salt, fine))
    else:
        want = np.asarray(ref_lsh.band_keys(jnp.asarray(sig), jnp.asarray(salt)))
    assert np.array_equal(keys, want.astype(np.int64))
    assert np.array_equal(keys, lsh.keys_plain(_t(sig), salt, fine, wide=wide).numpy())
    if not wide:
        plain = lsh.pack_keys_plain(torch.from_numpy(keys), torch.from_numpy(valid), bits)
        assert np.array_equal(packed, plain.numpy())
        assert (packed[:, ~valid] >> bits == U32).all()


def pack_tile_walk(keys: np.ndarray, valid: np.ndarray, bits: int, offset: int) -> np.ndarray:
    """numpy model of ``pack_kernel``: a block's ``KEY_ROWS`` rows of keys,
    one contiguous span that starts ``offset`` int64 into a 16-byte
    aligned buffer, into shared memory at a pitch of ``nk | 1`` (in pairs
    of 16-byte loads where the span is aligned, else one key a load), then
    warp w writes sets w, w + WARPS, ... lane l row r0 + l."""
    B, nk = keys.shape
    kp = nk | 1
    packed = np.full((nk, B), -3, np.int64)
    flat = keys.reshape(-1)
    for r0 in range(0, B, KEY_ROWS):
        nr = min(KEY_ROWS, B - r0)
        sm = np.full(KEY_ROWS * kp, -9, np.int64)
        n = nr * nk
        if (offset + r0 * nk) % 2 == 0:
            for e in range(0, n, 2):
                r, c = divmod(e, nk)
                sm[r * kp + c] = flat[r0 * nk + e]
                if e + 1 == n:
                    break
                c += 1
                if c == nk:
                    r, c = r + 1, 0
                sm[r * kp + c] = flat[r0 * nk + e + 1]
        else:
            for e in range(n):
                r, c = divmod(e, nk)
                sm[r * kp + c] = flat[r0 * nk + e]
        lanes = np.arange(nr)
        for warp in range(WARPS):
            for j in range(warp, nk, WARPS):
                k = np.where(valid[r0 + lanes], sm[lanes * kp + j], U32)
                packed[j, r0 + lanes] = (k << bits) | (r0 + lanes)
    return packed


@pytest.mark.parametrize("case", [*KEY_CASES[:4], "heavy_ties", "valid_u32_max", "random_wide"])
@pytest.mark.parametrize("offset", [0, 1])
def test_pack_tile_walk_matches_the_plain_version(case, offset):
    keys, valid = _keys_case(case)
    bits = lsh.row_bits(keys.shape[0])
    plain = lsh.pack_keys_plain(torch.from_numpy(keys), torch.from_numpy(valid), bits).numpy()
    assert np.array_equal(pack_tile_walk(keys, valid, bits, offset), plain)


# -- the wrappers raise before any build ------------------------------------


@pytest.fixture
def no_build(monkeypatch):
    """Any build or load fails the test: the checks come first."""
    def refuse(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    lsh_cuda._lib.cache_clear()
    yield
    lsh_cuda._lib.cache_clear()


def _calls():
    sig = torch.zeros((8, 128), dtype=torch.int32)
    rep = torch.zeros((8, 6), dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    ok = torch.ones((8, 6), dtype=torch.bool)
    keys = torch.zeros((8, 6), dtype=torch.int64)
    srt = torch.zeros((6, 8), dtype=torch.int64)
    salt = np.arange(16, dtype=np.uint32)
    return {
        "keys_dtype": (TypeError, lambda: lsh_cuda.lsh_keys(sig.float(), salt)),
        "keys_ndim": (ValueError, lambda: lsh_cuda.lsh_keys(sig[0], salt)),
        "keys_salts": (ValueError, lambda: lsh_cuda.lsh_keys(sig, np.arange(600))),
        "keys_divide": (ValueError, lambda: lsh_cuda.lsh_keys(sig, np.arange(24))),
        "keys_wide_fine": (ValueError, lambda: lsh_cuda.lsh_keys(sig, salt, salt, wide=True)),
        "keys_valid_len": (ValueError, lambda: lsh_cuda.lsh_keys(sig, salt, valid=valid[:5])),
        "keys_bits": (ValueError, lambda: lsh_cuda.lsh_keys(sig, salt, valid=valid, bits=2)),
        "keys_strided": (ValueError, lambda: lsh_cuda.lsh_keys(sig[:, ::2], salt)),
        "pack_dtype": (TypeError, lambda: lsh_cuda.pack_keys(keys.int(), valid, 3)),
        "pack_valid": (TypeError, lambda: lsh_cuda.pack_keys(keys, valid.int(), 3)),
        "pack_cols": (ValueError, lambda: lsh_cuda.pack_keys(
            torch.zeros((8, lsh_cuda.MAX_SALTS + 1), dtype=torch.int64), valid, 3)),
        "sort_dtype": (TypeError, lambda: lsh_cuda.lsh_sort(srt.int(), 3)),
        "sort_ndim": (ValueError, lambda: lsh_cuda.lsh_sort(srt[0], 3)),
        "sort_no_bands": (ValueError, lambda: lsh_cuda.lsh_sort(srt[:0], 3)),
        "sort_bits": (ValueError, lambda: lsh_cuda.lsh_sort(srt, 2)),
        "sort_bits_32": (ValueError, lambda: lsh_cuda.lsh_sort(srt, 32)),
        "sort_strided": (ValueError, lambda: lsh_cuda.lsh_sort(srt[:, ::2], 2)),
        "heads_dtype": (TypeError, lambda: lsh_cuda.lsh_run_heads(srt.int(), valid, 3)),
        "heads_valid": (ValueError, lambda: lsh_cuda.lsh_run_heads(srt, valid[:3], 3)),
        "heads_bits": (ValueError, lambda: lsh_cuda.lsh_run_heads(srt, valid, 32)),
        "heads_bands": (ValueError, lambda: lsh_cuda.lsh_run_heads(
            torch.zeros((lsh_cuda.MAX_HEAD_BANDS + 1, 8), dtype=torch.int64), valid, 3)),
        "verify_rep_dtype": (TypeError, lambda: lsh_cuda.lsh_verify(rep.long(), valid, sig)),
        "verify_rows": (ValueError, lambda: lsh_cuda.lsh_verify(rep, valid, sig[:4])),
        "verify_no_valid": (ValueError, lambda: lsh_cuda.lsh_verify(rep, None, sig)),
        "verify_thr_shape": (ValueError, lambda: lsh_cuda.lsh_verify(
            rep, valid, sig, thr=torch.zeros(5))),
        "verify_keys_cols": (ValueError, lambda: lsh_cuda.lsh_verify(
            rep, valid, sig, band=0.7, keys=torch.zeros((8, 4), dtype=torch.int64))),
        "verify_fine_no_keys": (ValueError, lambda: lsh_cuda.lsh_verify(
            rep, valid, sig, strict=0.75)),
        "verify_bars_no_strict": (ValueError, lambda: lsh_cuda.lsh_verify(rep, None)),
        "label_ok_shape": (ValueError, lambda: lsh_cuda.lsh_label(rep, ok[:, :3], valid, 2)),
        "label_ok_dtype": (TypeError, lambda: lsh_cuda.lsh_label(rep, ok.int(), valid, 2)),
        "label_rounds": (ValueError, lambda: lsh_cuda.lsh_label(rep, ok, valid, -1)),
    }


@pytest.mark.parametrize("case", list(_calls()))
def test_wrappers_check_arguments_before_any_build(no_build, monkeypatch, case):
    monkeypatch.setattr(lsh_cuda, "_on_card", lambda t, name: None)
    err, call = _calls()[case]
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("fn", ["lsh_keys", "pack_keys", "lsh_sort", "lsh_run_heads",
                                "lsh_verify", "lsh_label"])
def test_wrappers_refuse_cpu_tensors(no_build, fn):
    sig = torch.zeros((8, 128), dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    rep = torch.zeros((8, 6), dtype=torch.int32)
    calls = {
        "lsh_keys": lambda: lsh_cuda.lsh_keys(sig, np.arange(16)),
        "pack_keys": lambda: lsh_cuda.pack_keys(rep.long(), valid, 3),
        "lsh_sort": lambda: lsh_cuda.lsh_sort(rep.long().T.contiguous(), 3),
        "lsh_run_heads": lambda: lsh_cuda.lsh_run_heads(rep.long().T.contiguous(), valid, 3),
        "lsh_verify": lambda: lsh_cuda.lsh_verify(rep, valid, sig),
        "lsh_label": lambda: lsh_cuda.lsh_label(rep, rep.bool(), valid, 1),
    }
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[fn]()


def test_wrapper_limits_match_the_kernel_source():
    src = (_build.CSRC_DIR / "lsh.cu").read_text()
    ints = int(re.search(r"constexpr int kStageInts = (\d+);", src).group(1))
    assert "kMaxHeadBands = (kStageInts - 1) / 3;" in src
    assert lsh_cuda.MAX_HEAD_BANDS == (ints - 1) // 3 == 4095
    assert f"constexpr int kMaxSalts = {lsh_cuda.MAX_SALTS};" in src
    # the label's launches, whatever its rounds: the edge lists, then one
    # cooperative launch; the keys' tiles and their loads as modelled here
    assert f"constexpr int kLabelLaunches = {lsh_cuda.LABEL_LAUNCHES};" in src
    label = src[src.index("int astt_lsh_label(const void* rep"):]
    label = label[:label.index("\n}\n")]
    assert label.count("<<<") + label.count("cudaLaunchCooperativeKernel(") == \
        lsh_cuda.LABEL_LAUNCHES == 2
    assert "grid.sync();" in src and "for (int round = 0; round < rounds; ++round)" not in label
    assert f"constexpr int kKeyRows = {KEY_ROWS};" in src
    assert f"constexpr size_t kMaxBlockSmem = {MAX_BLOCK_SMEM};" in src
    assert f"constexpr int kThreads = {THREADS};" in src
    assert "enum KeysLoad { kLoadGlobal = 0, kLoadWords = 1, kLoadVec = 2 };" in src
    assert (lsh_cuda.KEYS_LOAD_GLOBAL, lsh_cuda.KEYS_LOAD_WORDS, lsh_cuda.KEYS_LOAD_VEC) == (
        LOAD_GLOBAL, LOAD_WORDS, LOAD_VEC)
    assert "return (kKeyRows * (ncol | 1) + 3) & ~3;" in src  # key_stage_words
    assert "const int pitch = 4 * ((P / 4) | 1);" in src and "const int pitch = P | 1;" in src


@pytest.mark.parametrize("name", [*lsh_probe.VARIANTS, *lsh_probe.CUTS])
def test_probe_variants_patch_the_shipped_source(name):
    """Each of ``lsh_probe.py``'s edits is found exactly once in the
    shipped ``lsh.cu`` (the probe builds them on the card only)."""
    src = (_build.CSRC_DIR / "lsh.cu").read_text()
    edits = {**lsh_probe.VARIANTS, **lsh_probe.CUTS}[name]
    out = myers_probe.patched(src, edits)
    assert (out == src) == (name == "shipped")
