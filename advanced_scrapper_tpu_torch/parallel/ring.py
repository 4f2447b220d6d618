"""Ring-pass cross-shard dedup: resolution whose per-shard payload stays
at the local batch's size.

Counterpart of the reference's ``parallel/ring.py``.  Each data shard
keeps its own block and a same-sized transit block that rotates one step
along the data axis per hop (``ppermute``); after ``n`` hops every pair of
blocks has met.  Each block is sorted once, per band, in the reference's
``(key, global row)`` order: its rows are put valid first (each group
ascending, so that within a key the order is the global rows'), and each
band's packed keys ``(key << bits) | i``, ``i`` the position in that
order, are sorted by key stably (``lsh_sort`` on the card).  What rotates
is the sorted packed keys, that order (``perm``), the block's global rows
and its signatures.  A hop joins each shard's rows against the transit
block (``ring_join`` on the card, a merge of the shard's own presorted keys
with the transit block's, every band in one call): a local row takes the
smallest transit global row that heads its key's run in some band, agrees
on at least ``threshold`` of the signature (``count/P`` in float32) and
comes before it.  Only the 4-byte representatives are
gathered, and pointer jumping resolves chains on them.

It equals the reference's ring, not the gather path
(``parallel.sharded.make_sharded_dedup``): the ring verifies every met
candidate, the gather path only the band-proposed one, so the two may
pick different valid representatives on borderline chains.
"""

from __future__ import annotations

import torch

from advanced_scrapper_tpu_torch.core.hashing import MinHashParams
from advanced_scrapper_tpu_torch.core.mesh import Mesh
from advanced_scrapper_tpu_torch.ops import lsh_cuda, ring_cuda
from advanced_scrapper_tpu_torch.ops.lsh import band_keys, row_bits
from advanced_scrapper_tpu_torch.ops.minhash import minhash_signatures
from advanced_scrapper_tpu_torch.ops.shingle import U32_MAX
from advanced_scrapper_tpu_torch.parallel import collectives as C
from advanced_scrapper_tpu_torch.parallel.sharded import as_sharded

_BIG = (1 << 31) - 1  # int32 max: invalid rows' global index, sorts last


def valid_first(valid: torch.Tensor) -> torch.Tensor:
    """``int32[Bt]``: the block's rows, valid ones first, each group
    ascending (a scan and a scatter, no sort).  Global rows ascend with
    block rows and invalid rows share ``gidx_eff`` int32-max, so within a
    key this is the reference's ``(key, gidx_eff, row)`` order."""
    Bt = valid.shape[0]
    v = valid.to(torch.int64)
    before = torch.cumsum(v, 0)
    rows = torch.arange(Bt, device=valid.device)
    pos = torch.where(valid, before - 1, before[-1:] + rows - before) if Bt else rows
    return torch.empty_like(rows).scatter_(0, pos, rows).to(torch.int32)


def _packed(keys: torch.Tensor, perm: torch.Tensor, bits: int) -> torch.Tensor:
    """``int64[nb, Bt]``: band b's ``(keys[perm[i], b] << bits) | i``."""
    i = torch.arange(keys.shape[0], device=keys.device)
    return ((keys[perm.to(torch.int64)].T << bits) | i[None, :]).contiguous()


def presort_plain(keys: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the presort on ``lsh_sort``: ``(sorted_keys
    int64[nb, Bt], perm int32[Bt])`` from ``keys int64[Bt, nb]`` in ``[0,
    2³²)`` (invalid rows ``U32_MAX``): :func:`valid_first`'s order, each
    band's packed keys sorted by ``torch.sort(stable=True)``."""
    perm = valid_first(valid)
    packed = _packed(keys, perm, row_bits(keys.shape[0]))
    return torch.sort(packed, dim=1, stable=True).values, perm


def _presort_bands(keys: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-band sort of a block's keys in the reference's ``(key, global
    row)`` order (:func:`presort_plain`): on the card ``lsh_sort``, a
    stable sort by key of rows that enter ascending; on the CPU its plain
    version.  The run head at a searchsorted position is the earliest
    global row with that band key; the block row at sorted position ``j``
    of band ``b`` is ``perm[sorted_keys[b, j] & (2**bits - 1)]``."""
    if keys.device.type != "cuda":
        return presort_plain(keys, valid)
    bits = row_bits(keys.shape[0])
    perm = valid_first(valid)
    return lsh_cuda.lsh_sort(_packed(keys, perm, bits), bits), perm


def join_plain(keys_l, sig_l, gidx_l, sorted_keys, perm, gidx_eff, sig_b, rep, threshold,
               bits) -> torch.Tensor:
    """Plain version of the ``ring_join`` kernel: ``min(rep, cand)`` as a
    new ``int32[Bl]``, where ``cand`` is the smallest transit global row
    that band-collides with each local row (the run head at the band's
    ``searchsorted`` position), verifies by signature agreement and comes
    before it, the row's own index otherwise; one band at a time."""
    Bt = sorted_keys.shape[1]
    P = sig_l.shape[1]
    dev = sig_l.device
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    s_l = sig_l.view(torch.int32)
    s_b = sig_b.view(torch.int32)
    gl = gidx_l.to(torch.int64)
    order, gidx_b = perm.to(torch.int64), gidx_eff.to(torch.int64)
    mask = (1 << bits) - 1
    best = torch.full_like(gl, _BIG)
    for b in range(sorted_keys.shape[0]):
        skb, klb = sorted_keys[b].contiguous(), keys_l[:, b].contiguous()
        pos = torch.searchsorted(skb, klb << bits, side="left").clamp(0, Bt - 1)
        v = skb[pos]
        hit = (v >> bits) == klb
        row = order[v & mask]
        cand_gidx = gidx_b[row]
        agree = (s_l == s_b[row]).sum(dim=1).to(torch.float32) / P
        ok = hit & (agree >= thr) & (cand_gidx < gl)
        best = torch.minimum(best, torch.where(ok, cand_gidx, _BIG))
    cand = torch.where(best == _BIG, gl, best).to(torch.int32)
    return torch.minimum(rep, cand)


def _best_match_against_sorted(keys_l, sig_l, gidx_l, sorted_keys, perm, gidx_eff, sig_b, rep,
                               threshold, bits, sorted_l, order_l) -> torch.Tensor:
    """One hop's join for one shard: ``min(rep, cand)`` (see
    :func:`join_plain`); on the card ``ring_join`` over every band, which
    reads the local keys through the shard's own presort (``sorted_l``,
    ``order_l``) and updates ``rep`` in place; on the CPU the plain
    version."""
    if keys_l.device.type == "cuda":
        return ring_cuda.ring_join(keys_l, sig_l, gidx_l, sorted_keys, perm, gidx_eff, sig_b, rep,
                                   threshold=threshold, bits=bits, sorted_l=sorted_l,
                                   order_l=order_l)
    return join_plain(keys_l, sig_l, gidx_l, sorted_keys, perm, gidx_eff, sig_b, rep, threshold,
                      bits)


def make_ring_dedup(
    mesh: Mesh,
    params: MinHashParams,
    *,
    threshold: float = 0.7,
    jump_rounds: int = 20,
):
    """The ring-resolution dedup step: ``step(tokens, lengths) -> rep``
    with ``tokens`` split on the data axis and ``rep`` the ``int32[B]``
    global first-seen representatives (union-find roots after pointer
    jumping), on the rank's first local shard's device."""
    data = mesh.axis_names[0]
    n = mesh.shape[data]
    k, salt = params.shingle_k, params.band_salt
    perm = [(s, (s + 1) % n) for s in range(n)]

    def step(tokens, lengths) -> torch.Tensor:
        tok = as_sharded(mesh, tokens, (data, None))
        lens = as_sharded(mesh, lengths, (data,))
        local = []
        for t, ln, s in zip(tok.pieces, lens.pieces, C.axis_index(mesh, data)):
            Bl = t.shape[0]
            sig = minhash_signatures(t, ln, params)
            valid = ln >= k
            keys = torch.where(valid[:, None], band_keys(sig, salt), U32_MAX)
            gidx = (s * Bl + torch.arange(Bl, device=t.device)).to(torch.int32)
            gidx_eff = torch.where(valid, gidx, _BIG).to(torch.int32)
            sorted_keys, order = _presort_bands(keys, valid)
            # the shard keeps its own presort for every hop; a copy of it rotates
            local.append({"keys": keys, "sig": sig, "gidx": gidx, "rep": gidx.clone(),
                          "bits": row_bits(Bl), "own": (sorted_keys, order),
                          "blk": [sorted_keys, order, gidx_eff, sig]})
        for hop in range(n):
            for sh in local:
                sh["rep"] = _best_match_against_sorted(sh["keys"], sh["sig"], sh["gidx"],
                                                       *sh["blk"], sh["rep"], threshold,
                                                       sh["bits"], *sh["own"])
            if hop == n - 1:
                break  # every pair of blocks has met
            moved = [C.ppermute(mesh, [sh["blk"][i] for sh in local], data, perm)
                     for i in range(4)]
            for j, sh in enumerate(local):
                sh["blk"] = [m[j] for m in moved]
        # chains resolve on the 4-byte representatives only
        g_rep = C.all_gather(mesh, [sh["rep"] for sh in local], data)[0].to(torch.int64)
        for _ in range(jump_rounds):
            g_rep = g_rep[g_rep]
        return g_rep.to(torch.int32)

    return step
