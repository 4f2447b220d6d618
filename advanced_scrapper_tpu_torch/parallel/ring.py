"""Ring-pass cross-shard dedup: resolution whose per-shard payload stays
at the local batch's size.

Counterpart of the reference's ``parallel/ring.py``.  Each data shard
keeps its own block and a same-sized transit block that rotates one step
along the data axis per hop (``ppermute``); after ``n`` hops every pair of
blocks has met.  Each block is sorted once, per band by (key, global row)
as one ``int64`` key, as ``ops.lsh`` sorts; what rotates is the sorted
keys (in sign-flip ``int32`` order, ``ops.lsh``'s ``uint32`` values less
2³¹), each sorted position's row, the block's global rows and its
signatures.  A hop joins with ``searchsorted`` one band at a time, so its
transient stays ``O(Bl·P)``: a local row takes the smallest transit
global row that shares a band key with it, agrees on at least
``threshold`` of the signature (``count/P`` in float32) and comes before
it.  Only the 4-byte representatives are gathered, and pointer jumping
resolves chains on them.

It equals the reference's ring, not the gather path
(``parallel.sharded.make_sharded_dedup``): the ring verifies every met
candidate, the gather path only the band-proposed one, so the two may
pick different valid representatives on borderline chains.
"""

from __future__ import annotations

import torch

from advanced_scrapper_tpu_torch.core.hashing import MinHashParams
from advanced_scrapper_tpu_torch.core.mesh import Mesh
from advanced_scrapper_tpu_torch.ops.lsh import band_keys
from advanced_scrapper_tpu_torch.ops.minhash import minhash_signatures
from advanced_scrapper_tpu_torch.ops.shingle import U32_MAX
from advanced_scrapper_tpu_torch.parallel import collectives as C
from advanced_scrapper_tpu_torch.parallel.sharded import as_sharded

_BIG = (1 << 31) - 1  # int32 max: invalid rows' global index, sorts last


def _presort_bands(keys: torch.Tensor, gidx_eff: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-band sort of a block's (key, global row) pairs: ``(sk, sp)``,
    each ``int32[nb, Bt]``: the keys in order (as ``key − 2³¹``) and the
    block row at each sorted position.  ``keys`` are ``int64[Bt, nb]``
    in ``[0, 2³²)`` (invalid rows ``U32_MAX``), ``gidx_eff`` ``int32[Bt]``
    (invalid rows int32-max): a run's head is its earliest global row."""
    comb = (keys.T << 31) | gidx_eff.to(torch.int64)[None, :]
    order = torch.sort(comb, dim=1).indices
    sk = (keys.T.gather(1, order) - (1 << 31)).to(torch.int32)
    return sk, order.to(torch.int32)


def _best_match_against_sorted(keys_l, sig_l, gidx_l, sk, sp, gidx_eff, sig_b, threshold):
    """``int32[Bl]``: the smallest transit global row that band-collides
    with each local row and verifies by signature agreement, the row's
    own index otherwise; one band at a time."""
    Bt = sk.shape[1]
    P = sig_l.shape[1]
    dev = sig_l.device
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    kl = (keys_l - (1 << 31)).to(torch.int32)
    s_l = sig_l.view(torch.int32)
    s_b = sig_b.view(torch.int32)
    gl = gidx_l.to(torch.int64)
    best = torch.full_like(gl, _BIG)
    for b in range(sk.shape[0]):
        skb, klb = sk[b].contiguous(), kl[:, b].contiguous()
        pos = torch.searchsorted(skb, klb, side="left").clamp(0, Bt - 1)
        hit = skb[pos] == klb
        row = sp[b].to(torch.int64)[pos]
        cand_gidx = gidx_eff.to(torch.int64)[row]
        agree = (s_l == s_b[row]).sum(dim=1).to(torch.float32) / P
        ok = hit & (agree >= thr) & (cand_gidx < gl)
        best = torch.minimum(best, torch.where(ok, cand_gidx, _BIG))
    return torch.where(best == _BIG, gl, best).to(torch.int32)


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
            sk, sp = _presort_bands(keys, gidx_eff)
            local.append({"keys": keys, "sig": sig, "gidx": gidx, "rep": gidx,
                          "blk": [sk, sp, gidx_eff, sig]})
        for hop in range(n):
            for sh in local:
                cand = _best_match_against_sorted(sh["keys"], sh["sig"], sh["gidx"],
                                                  *sh["blk"], threshold)
                sh["rep"] = torch.minimum(sh["rep"], cand)
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
