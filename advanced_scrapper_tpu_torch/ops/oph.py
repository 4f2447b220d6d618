"""One-permutation MinHash (OPH): the opt-in signature backend
``DedupConfig(backend="oph")``.

Counterpart of the reference's ``ops/oph.py``, bit-equal to it.  OPH
(Li, Owen & Zhang, NeurIPS 2012) computes one hash per shingle, splits the
32-bit hash space into ``num_perm`` bins (the bin is the hash's top
``log2(num_perm)`` bits) and keeps each bin's minimum; an empty bin holds
``U32_MAX``.  Rotation densification (Shrivastava & Li, ICML 2014) then
fills each empty bin from the nearest filled bin to its right, offset by
the distance times ``0x9E3779B1``, so two documents' jointly empty bins
agree only when they borrowed the same value from the same distance.

Raw signatures combine exactly under the elementwise minimum (the segment
fold, the tile accumulator); densify only after every minimum is taken:
``min(densify(a), densify(b)) != densify(min(a, b))``.  So the engine
folds raw signatures and densifies once per corpus or stream batch.

The public functions pick by the tensor's device: the CUDA kernels
(``ops.oph_cuda``: ``oph_fold_segments``, ``oph_fold``, ``oph_sig``,
``oph_densify``) for a CUDA tensor, the plain versions here for a CPU
tensor, with no fallback between them.  The plain raw form is the
reference's own (a sort of each row's shingle hashes and a
``searchsorted`` of each bin's lower bound); the plain densify runs the
reference's pointer doubling.  Both carry 32-bit values in ``int64``
(``ops.shingle``): PyTorch has no unsigned 32-bit shift or minimum on the
CPU.
"""

from __future__ import annotations

import torch

from advanced_scrapper_tpu_torch.core.hashing import MinHashParams
from advanced_scrapper_tpu_torch.ops.minhash import (
    fold_segments_plain,
    fused_tile_step_plain,
)
from advanced_scrapper_tpu_torch.ops.shingle import (
    U32_MASK,
    U32_MAX,
    shingle_hash,
    to_u32,
    u32_values,
)

#: densify's offset per bin of distance (odd: a bijection per distance)
DENSIFY_C = 0x9E3779B1


def _bin_bits(num_perm: int) -> int:
    bits = num_perm.bit_length() - 1
    if 1 << bits != num_perm:
        raise ValueError(f"OPH requires power-of-two num_perm, got {num_perm}")
    return bits


def oph_raw_signatures_plain(
    tokens: torch.Tensor, lengths: torch.Tensor, params: MinHashParams
) -> torch.Tensor:
    """Plain raw ``uint32[B, num_perm]`` OPH signatures of ``tokens
    uint8[B, W]`` with ``lengths int32[B]`` valid bytes, in the
    reference's form: sort each row's hashes (invalid shingles as
    ``U32_MAX``); the bin is the top bits, so each bin's minimum sits at
    the ``searchsorted`` of its lower bound."""
    num_perm = params.num_perm
    shift = 32 - _bin_bits(num_perm)
    h, valid = shingle_hash(tokens, lengths, params.shingle_k)
    hs, _ = torch.sort(torch.where(valid, h, U32_MAX), dim=1)
    B, S = hs.shape
    bins = torch.arange(num_perm, dtype=torch.int64, device=hs.device)
    bounds = (bins << shift).expand(B, num_perm).contiguous()
    pos = torch.searchsorted(hs, bounds, side="left")
    v = torch.take_along_dim(hs, pos.clamp(0, S - 1), dim=1)
    inbin = (v >> shift) == bins[None, :]
    return to_u32(torch.where(inbin & (pos < S), v, U32_MAX))


def oph_raw_signatures(
    tokens: torch.Tensor, lengths: torch.Tensor, params: MinHashParams
) -> torch.Tensor:
    """Raw ``uint32[B, num_perm]`` OPH signatures (empty bins
    ``U32_MAX``): the ``oph_sig`` kernel for a CUDA tensor, the plain
    version for a CPU one.  Combine under ``min``; densify after."""
    _bin_bits(params.num_perm)
    if tokens.device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.oph_cuda import oph_sig

        return oph_sig(
            tokens.contiguous(), lengths.to(torch.int32).contiguous(),
            params.num_perm, params.shingle_k,
        )
    return oph_raw_signatures_plain(tokens, lengths, params)


def densify_plain(sig: torch.Tensor) -> torch.Tensor:
    """Plain rotation densification of ``uint32[B, P]``, the reference's
    pointer doubling: after the rounds of shift 1, 2, 4, … below ``P``,
    ``dist`` is each bin's distance to the nearest filled bin to its
    right (circularly) and ``val`` that bin's value."""
    P = sig.shape[-1]
    s = u32_values(sig)
    big = U32_MAX
    filled = s != U32_MAX
    dist = torch.where(filled, 0, big)
    val = s
    shift = 1
    while shift < P:
        nd_raw = torch.roll(dist, -shift, dims=-1)
        nd = torch.where(nd_raw == big, big, nd_raw + shift)
        better = nd < dist
        dist = torch.where(better, nd, dist)
        val = torch.where(better, torch.roll(val, -shift, dims=-1), val)
        shift <<= 1
    dense = (val + dist * DENSIFY_C) & U32_MASK
    return to_u32(torch.where(dist == big, U32_MAX, torch.where(filled, s, dense)))


def densify(sig: torch.Tensor) -> torch.Tensor:
    """Densified ``uint32[B, P]`` from raw OPH signatures: the
    ``oph_densify`` kernel for a CUDA tensor, the plain version for a CPU
    one.  All-empty rows stay all-``U32_MAX`` (the no-shingle sentinel)."""
    if sig.device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.oph_cuda import oph_densify

        return oph_densify(sig.contiguous())
    return densify_plain(sig)


def oph_signatures(
    tokens: torch.Tensor, lengths: torch.Tensor, params: MinHashParams
) -> torch.Tensor:
    """Densified OPH signatures of whole documents (rows split across
    blocks take the raw form and densify after the combine)."""
    return densify(oph_raw_signatures(tokens, lengths, params))


def oph_fold_segments(
    running: torch.Tensor,
    text: torch.Tensor,
    seg_start: torch.Tensor,
    seg_shingles: torch.Tensor,
    seg_owner: torch.Tensor,
    params: MinHashParams,
) -> torch.Tensor:
    """Fold the raw OPH signatures of the segments of ``text`` into
    ``running uint32[N, num_perm]`` in place: the ``oph_fold_segments``
    kernel for a CUDA text, for a CPU text ``ops.minhash``'s plain segment
    fold over :func:`oph_raw_signatures_plain`."""
    _bin_bits(params.num_perm)
    if text.device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.oph_cuda import oph_fold_segments as kernel

        return kernel(running, text, seg_start, seg_shingles, seg_owner, params.shingle_k)
    return fold_segments_plain(
        running, text, seg_start, seg_shingles, seg_owner, params,
        signatures=oph_raw_signatures_plain,
    )


def oph_fused_tile_step_plain(
    running: torch.Tensor, packed: torch.Tensor, *, rows: int, width: int,
    params: MinHashParams,
) -> torch.Tensor:
    """Plain version of the ``oph_fold`` kernel: unpack → raw OPH
    signatures → min by owner into ``running``, in place."""
    return fused_tile_step_plain(
        running, packed, rows=rows, width=width, params=params,
        signatures=oph_raw_signatures_plain,
    )
