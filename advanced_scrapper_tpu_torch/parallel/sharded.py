"""Mesh-sharded dedup: the batch, block and sequence steps over a mesh.

Counterpart of the reference's ``parallel/sharded.py``.  Each step runs
its per-shard work on every local shard, on the shard's device, and
combines shards with the collectives of ``parallel.collectives``:

- **data axis** — the batch is split; each shard computes its rows'
  signatures (the ``minhash_sig`` kernel on the card) and candidate keys,
  then ``all_gather`` s the keys, signatures and valid mask, so the
  resolution sees the whole batch; the band-key histograms merge with
  ``psum``;
- **blocks** — :func:`make_sharded_block_dedup` folds each shard's blocks
  into per-article partials with a segment minimum and combines them
  with ``pmin`` (validity with ``pmax``);
- **seq axis** — :func:`make_seq_sharded_signatures` splits the byte axis:
  each shard takes a ``(k-1)``-byte halo from the next shard through
  ``ppermute`` and hashes its slice with the existing kernel on the
  extended row at the effective length ``clip(len − start, 0, Ls + k −
  1)``, which masks shingles against global positions; ``pmin`` over
  ``seq`` combines the partial signatures.

After a combine every shard of a rank holds the same values, so the
replicated tail (candidates, resolution, histogram) runs once per rank,
on its first local shard's device; the steps return it there.  Inputs
are :class:`~advanced_scrapper_tpu_torch.core.mesh.ShardedArray` s, or
host arrays holding the global batch, which the step splits over the
mesh (:func:`shard_batch`).
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import MinHashParams
from advanced_scrapper_tpu_torch.core.mesh import Mesh, ShardedArray, place
from advanced_scrapper_tpu_torch.ops.lsh import (
    band_keys,
    bucket_histogram,
    candidate_keys,
    duplicate_rep_bands,
    fine_edge_thresholds,
    resolve_rep_bands,
)
from advanced_scrapper_tpu_torch.ops.minhash import (
    check_backend,
    combine_block_signatures,
    minhash_signatures,
)
from advanced_scrapper_tpu_torch.parallel import collectives as C


def _data_axis(mesh: Mesh) -> str:
    return mesh.axis_names[0]


def _seq_axis(mesh: Mesh) -> str | None:
    return mesh.axis_names[1] if len(mesh.axis_names) > 1 else None


def signature_fn(backend: str, *, raw: bool = False):
    """The per-shard signature function of ``backend``: the dense MinHash
    (``scan``, ``pallas``) or OPH, densified unless ``raw`` (the form
    that combines under a minimum)."""
    check_backend(backend)
    if backend != "oph":
        return minhash_signatures
    from advanced_scrapper_tpu_torch.ops.oph import oph_raw_signatures, oph_signatures

    return oph_raw_signatures if raw else oph_signatures


def _defaults(cand_subbands, fine_margin) -> tuple[int, float]:
    """The certified engine's config as the single source of the defaults."""
    cfg = DedupConfig()
    return (cfg.cand_subbands if cand_subbands is None else cand_subbands,
            cfg.fine_margin if fine_margin is None else fine_margin)


def as_sharded(mesh: Mesh, x, spec) -> ShardedArray:
    """``x`` as it is when already a :class:`ShardedArray` on ``mesh``,
    else the global host array split under ``spec``."""
    if isinstance(x, ShardedArray):
        if x.mesh != mesh:
            raise ValueError(f"array is on {x.mesh}, step is built for {mesh}")
        return x
    return place(mesh, x, spec)


def _resolve(rep_bands, keys, sig, valid, *, threshold, fine_margin, cand_subbands,
             num_coarse, jump_rounds) -> torch.Tensor:
    """Per-band verification and component labels, with the fine-only
    edges' stricter bars when both ``cand_subbands`` and ``fine_margin``
    are set."""
    if cand_subbands and fine_margin:
        thr = fine_edge_thresholds(rep_bands, keys, threshold, fine_margin,
                                   num_coarse=num_coarse)
    else:
        thr = threshold
    return resolve_rep_bands(rep_bands, sig, valid, thr, jump_rounds=jump_rounds)


def make_sharded_dedup(
    mesh: Mesh,
    params: MinHashParams,
    *,
    threshold: float = 0.7,
    jump_rounds: int = 16,
    hist_bins: int = 1 << 16,
    backend: str = "scan",
    cand_subbands: int | None = None,
    fine_margin: float | None = None,
):
    """The batch-sharded dedup step: ``step(tokens, lengths) -> (rep,
    hist)`` with ``tokens uint8[B, L]`` split on the data axis, ``rep`` the
    ``int32[B]`` global first-seen representatives and ``hist`` the
    ``psum`` of the shards' bucket histograms.  ``backend="oph"`` takes
    densified OPH signatures (data shards own whole rows).  Resolution is
    the certified engine's: ``duplicate_rep_bands`` over the coarse + fine
    candidate keys, then ``resolve_rep_bands``."""
    data = _data_axis(mesh)
    sig_fn = signature_fn(backend)
    cand_subbands, fine_margin = _defaults(cand_subbands, fine_margin)
    k, salt = params.shingle_k, params.band_salt

    def step(tokens, lengths):
        tok = as_sharded(mesh, tokens, (data, None))
        lens = as_sharded(mesh, lengths, (data,))
        sigs, keys, valids, all_keys = [], [], [], []
        for t, ln in zip(tok.pieces, lens.pieces):
            sig = sig_fn(t, ln, params)
            sigs.append(sig)
            keys.append(band_keys(sig, salt))
            valids.append(ln >= k)
            all_keys.append(candidate_keys(sig, salt, cand_subbands))
        # cross-shard resolution gathers the compact summaries, never the text
        g_keys = C.all_gather(mesh, all_keys, data)[0]
        g_sig = C.all_gather(mesh, sigs, data)[0]
        g_valid = C.all_gather(mesh, valids, data)[0]
        rep = _resolve(
            duplicate_rep_bands(g_keys, g_valid), g_keys, g_sig, g_valid,
            threshold=threshold, fine_margin=fine_margin, cand_subbands=cand_subbands,
            num_coarse=params.num_bands, jump_rounds=jump_rounds,
        )
        hists = [bucket_histogram(kk, v, nbins=hist_bins) for kk, v in zip(keys, valids)]
        return rep, C.psum(mesh, hists, data)[0]

    return step


def make_sharded_block_dedup(
    mesh: Mesh,
    params: MinHashParams,
    num_articles: int,
    *,
    threshold: float = 0.7,
    jump_rounds: int = 16,
    hist_bins: int = 1 << 16,
    backend: str = "scan",
    cand_subbands: int | None = None,
    fine_margin: float | None = None,
):
    """Blockwise sharded dedup with the per-article combine in the step:
    ``step(tokens, lengths, owners) -> (rep, hist)``.  ``tokens`` are
    ``uint8[B, L]`` blocks (``core.tokenizer.encode_blocks``) split on the
    data axis and ``owners int32[B]`` each block's global article (padding
    blocks name ``num_articles``, a scratch row).  Each shard folds its
    blocks per article with a segment minimum, ``pmin`` combines the
    shards (``pmax`` the validity), so only ``[num_articles, P]`` partials
    cross.  OPH folds raw signatures and densifies after the combine."""
    data = _data_axis(mesh)
    use_oph = backend == "oph"
    sig_fn = signature_fn(backend, raw=True)
    cand_subbands, fine_margin = _defaults(cand_subbands, fine_margin)
    k, salt = params.shingle_k, params.band_salt
    n_seg = num_articles + 1  # +1 scratch row for padding blocks

    def step(tokens, lengths, owners):
        tok = as_sharded(mesh, tokens, (data, None))
        lens = as_sharded(mesh, lengths, (data,))
        own = as_sharded(mesh, owners, (data,))
        parts, v_parts = [], []
        for t, ln, o in zip(tok.pieces, lens.pieces, own.pieces):
            parts.append(combine_block_signatures(sig_fn(t, ln, params), o, num_articles=n_seg))
            v_parts.append(torch.zeros((n_seg,), dtype=torch.int32, device=t.device)
                           .scatter_reduce_(0, o.to(torch.int64), (ln >= k).to(torch.int32),
                                            "amax", include_self=True))
        sig = C.pmin(mesh, parts, data)[0][:num_articles]
        if use_oph:
            from advanced_scrapper_tpu_torch.ops.oph import densify

            sig = densify(sig)
        valid = C.pmax(mesh, v_parts, data)[0][:num_articles] > 0
        all_keys = candidate_keys(sig, salt, cand_subbands)
        rep = _resolve(
            duplicate_rep_bands(all_keys, valid), all_keys, sig, valid,
            threshold=threshold, fine_margin=fine_margin, cand_subbands=cand_subbands,
            num_coarse=params.num_bands, jump_rounds=jump_rounds,
        )
        hist = bucket_histogram(band_keys(sig, salt), valid, nbins=hist_bins)
        return rep, hist

    return step


def make_seq_sharded_signatures(
    mesh: Mesh,
    params: MinHashParams,
    block_len: int,
    *,
    chunk: int = 128,
):
    """The sequence-parallel MinHash step: ``step(tokens, lengths) ->
    ShardedArray uint32[B, P]`` split on the data axis, bit-equal to the
    one-device signatures.  ``tokens uint8[B, block_len]`` are split on
    (data, seq), ``lengths`` (full lengths) on data.  Each seq shard hashes
    its slice extended by the next shard's first ``k - 1`` bytes
    (``ppermute``; the last shard's wrapped halo lies past every text's
    end) with ``minhash_signatures`` at the effective length ``clip(len −
    start, 0, Ls + k − 1)``; ``pmin`` over seq combines.  ``chunk`` is the
    plain version's shingle chunk."""
    data, seq = _data_axis(mesh), _seq_axis(mesh)
    if seq is None:
        raise ValueError("mesh has no seq axis")
    n_seq = mesh.shape[seq]
    k = params.shingle_k
    if block_len % n_seq:
        raise ValueError(f"block length {block_len} not divisible by seq={n_seq}")
    Ls = block_len // n_seq
    perm = [(i, (i - 1) % n_seq) for i in range(n_seq)]

    def step(tokens, lengths) -> ShardedArray:
        tok = as_sharded(mesh, tokens, (data, seq))
        lens = as_sharded(mesh, lengths, (data,))
        if tok.shape[1] != block_len:
            raise ValueError(f"step built for block length {block_len}, got {tok.shape[1]}")
        halos = C.ppermute(mesh, [t[:, : k - 1].contiguous() for t in tok.pieces], seq, perm)
        partial = []
        for t, halo, ln, j in zip(tok.pieces, halos, lens.pieces, C.axis_index(mesh, seq)):
            ext = torch.cat([t, halo], dim=1)
            eff = (ln.to(torch.int64) - j * Ls).clamp(0, Ls + k - 1).to(torch.int32)
            partial.append(minhash_signatures(ext, eff, params, chunk=chunk))
        sig = C.pmin(mesh, partial, seq)
        return ShardedArray(mesh, (data, None), sig, (tok.shape[0], params.num_perm))

    return step


def seq_sharded_signatures(tokens, lengths, params: MinHashParams, mesh: Mesh, *,
                           chunk: int = 128) -> ShardedArray:
    """One call of :func:`make_seq_sharded_signatures` (the step is a
    closure over the mesh: there is no compiled kernel to keep)."""
    L = tokens.shape[-1]
    return make_seq_sharded_signatures(mesh, params, L, chunk=chunk)(tokens, lengths)


def sharded_dedup_step(tokens, lengths, params: MinHashParams, mesh: Mesh, **kw):
    """One call of :func:`make_sharded_dedup`."""
    return make_sharded_dedup(mesh, params, **kw)(tokens, lengths)


def shard_batch(tokens, lengths, mesh: Mesh) -> tuple[ShardedArray, ShardedArray]:
    """Place a global host batch on the mesh with rows split over the data
    axis: each local shard's rows copied to its device."""
    data = _data_axis(mesh)
    return (place(mesh, np.asarray(tokens), (data, None)),
            place(mesh, np.asarray(lengths), (data,)))
