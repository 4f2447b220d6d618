"""MinHash signatures: plain PyTorch versions and the tile step.

Counterpart of the reference's ``ops/minhash.py`` (k=5 byte shingles,
128 permutations ``a·h + b mod 2³²``).  Every function here is device
agnostic plain PyTorch except the entry points that pick by the tensor's
device: :func:`minhash_signatures`, :func:`fold_segments` and the step
built by :func:`make_fused_tile_step` run the plain version for a CPU
tensor and launch the CUDA kernel (``ops.minhash_cuda``) for a CUDA
tensor.  There is no fallback from the kernel to the plain version.

:func:`fold_segments` is the engine's main path: segments of at most
:data:`SEGMENT_SHINGLES` shingles, read from one flat text, folded into the
per-article accumulator.  The minimum over an article's segments is the
minimum over its shingles, so the result does not depend on the cut.

Signatures and the accumulator are ``torch.uint32`` tensors (bit-equal to
the reference's ``uint32`` arrays); the plain arithmetic runs in ``int64``
(``ops.shingle``).
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_scrapper_tpu_torch.core.hashing import MinHashParams
from advanced_scrapper_tpu_torch.ops.minhash_cuda import check_segments
from advanced_scrapper_tpu_torch.ops.pack import unpack_tile
from advanced_scrapper_tpu_torch.ops.shingle import (
    U32_MASK,
    U32_MAX,
    shingle_hash,
    to_u32,
    u32_values,
)

#: Shingles per segment on the main path (at most the kernel's
#: ``MAX_SEGMENT_SHINGLES``).
SEGMENT_SHINGLES = 1024


def perm_tensors(
    params: MinHashParams, device: str | torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """The permutation family ``(a, b)`` as ``uint32[num_perm]`` tensors."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))
        .to(device)
        .view(torch.uint32)
        for x in (params.a32, params.b32)
    )


def scan_min_signature(
    h: torch.Tensor, valid: torch.Tensor, a: torch.Tensor, b: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Per-permutation minimum over shingle hashes, in shingle chunks.

    ``h`` is ``int64[B, S]`` in ``[0, 2³²)``, ``valid`` ``bool[B, S]``,
    ``a``/``b`` ``int64[P]``; returns ``int64[B, P]``.  The peak
    intermediate is ``[B, chunk, P]``.
    """
    B, S = h.shape
    sig = torch.full((B, a.shape[0]), U32_MAX, dtype=torch.int64, device=h.device)
    for c0 in range(0, S, chunk):
        ph = (h[:, c0 : c0 + chunk, None] * a + b) & U32_MASK
        ph = torch.where(valid[:, c0 : c0 + chunk, None], ph, U32_MAX)
        sig = torch.minimum(sig, ph.amin(dim=1))
    return sig


def minhash_signatures_plain(
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    params: MinHashParams,
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """Plain PyTorch ``uint32[B, num_perm]`` signatures on any device.

    Rows with fewer than k valid bytes give all-``U32_MAX``.  Columns past
    the longest row's length hold no valid shingle, so they are cut off
    before hashing; the result is the same as hashing the full width.
    """
    B, width = tokens.shape
    k = params.shingle_k
    if width < k:
        raise ValueError(f"block length {width} < shingle width {k}")
    a, b = (u32_values(x) for x in perm_tensors(params, tokens.device))
    longest = int(lengths.max()) if B else 0
    if longest < k:
        sig = torch.full((B, params.num_perm), U32_MAX, dtype=torch.int64,
                         device=tokens.device)
        return to_u32(sig)
    h, valid = shingle_hash(tokens[:, : min(longest, width)], lengths, k)
    return to_u32(scan_min_signature(h, valid, a, b, chunk))


def minhash_signatures(
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    params: MinHashParams,
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """``uint32[B, num_perm]`` MinHash signatures of ``tokens uint8[B, W]``
    with ``lengths int32[B]`` valid bytes: the CUDA kernel for a CUDA
    tensor (128 permutations only), the plain version for a CPU tensor."""
    if tokens.device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.minhash_cuda import minhash_sig

        a, b = perm_tensors(params, tokens.device)
        return minhash_sig(
            tokens.contiguous(), lengths.to(torch.int32).contiguous(), a, b,
            params.shingle_k,
        )
    return minhash_signatures_plain(tokens, lengths, params, chunk=chunk)


def accumulate_block_signatures(
    running: torch.Tensor, block_sigs: torch.Tensor, owners: torch.Tensor
) -> torch.Tensor:
    """Fold block signatures into ``running uint32[N, P]`` in place:
    ``running[o] = min(running[o], block_sigs[r])`` for every row ``r``
    with owner ``o``.  Owners outside ``[0, N)`` are dropped, as
    ``segment_min`` drops them.  Returns ``running``."""
    n, p = running.shape
    acc = u32_values(running)
    idx = owners.to(torch.int64)
    keep = (idx >= 0) & (idx < n)
    acc.scatter_reduce_(
        0, idx[keep][:, None].expand(-1, p), u32_values(block_sigs)[keep],
        "amin", include_self=True,
    )
    running.view(torch.int32).copy_(to_u32(acc).view(torch.int32))
    return running


def combine_block_signatures(
    block_sigs: torch.Tensor, owners: torch.Tensor, *, num_articles: int
) -> torch.Tensor:
    """Per-article signature = elementwise min over its blocks' signatures
    (exact: the blockwise split with k-1 overlap keeps the shingle set)."""
    running = to_u32(torch.full(
        (num_articles, block_sigs.shape[1]), U32_MAX, dtype=torch.int64,
        device=block_sigs.device,
    ))
    return accumulate_block_signatures(running, block_sigs, owners)


def fold_segments_plain(
    running: torch.Tensor,
    text: torch.Tensor,
    seg_start: torch.Tensor,
    seg_shingles: torch.Tensor,
    seg_owner: torch.Tensor,
    params: MinHashParams,
    *,
    batch_bytes: int = 1 << 22,
) -> torch.Tensor:
    """Plain version of the kernel's segment fold, in place on ``running``:
    gather each segment's ``shingles + k - 1`` bytes of ``text uint8[T]``
    into a row, take the rows' signatures, min them into their owners'
    rows (owners outside ``[0, N)`` dropped).  Rows go ``batch_bytes`` of
    gathered text at a time, which bounds the peak intermediate."""
    k = params.shingle_k
    check_segments(text.numel(), seg_start, seg_shingles, seg_owner, k)
    dev = text.device
    n = seg_shingles.to(dev, torch.int64)
    keep = torch.nonzero(n > 0).flatten()
    if not keep.numel():
        return running
    start, n, owner = seg_start.to(dev)[keep], n[keep], seg_owner.to(dev)[keep]
    width = int(n.max()) + k - 1
    col = torch.arange(width, device=dev)
    rows = max(1, batch_bytes // width)
    for r0 in range(0, keep.numel(), rows):
        st, ns = start[r0 : r0 + rows], n[r0 : r0 + rows]
        idx = torch.clamp(st[:, None] + col, max=text.numel() - 1)
        sigs = minhash_signatures_plain(
            text[idx], (ns + (k - 1)).to(torch.int32), params
        )
        accumulate_block_signatures(running, sigs, owner[r0 : r0 + rows])
    return running


def fold_segments(
    running: torch.Tensor,
    text: torch.Tensor,
    seg_start: torch.Tensor,
    seg_shingles: torch.Tensor,
    seg_owner: torch.Tensor,
    params: MinHashParams,
    perm: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Fold the segments of ``text`` into ``running`` in place: the CUDA
    kernel's ``minhash_fold_segments`` for a CUDA text (``perm`` is the
    ``(a, b)`` pair on the card, made here when not given), the plain
    version for a CPU text."""
    if text.device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.minhash_cuda import minhash_fold_segments

        a, b = perm if perm is not None else perm_tensors(params, text.device)
        return minhash_fold_segments(
            running, text, seg_start, seg_shingles, seg_owner, a, b, params.shingle_k
        )
    return fold_segments_plain(running, text, seg_start, seg_shingles, seg_owner, params)


def fused_tile_step_plain(
    running: torch.Tensor,
    packed: torch.Tensor,
    *,
    rows: int,
    width: int,
    params: MinHashParams,
) -> torch.Tensor:
    """Plain version of the CUDA kernel's fold: unpack → signatures →
    segment-min by owner → min into ``running``, in place."""
    tok, lens, owners = unpack_tile(packed, rows, width)
    return accumulate_block_signatures(
        running, minhash_signatures_plain(tok, lens, params), owners
    )


def check_backend(backend: str) -> None:
    """``scan`` and ``pallas`` name the signature function the reference
    holds bit-identical across its two backends, and both take the kernel
    here; ``oph`` is a later slice."""
    if backend == "oph":
        raise NotImplementedError(
            "backend='oph' (one-permutation hashing) is not ported yet; "
            "it is a later slice of the port (ROADMAP queue 1)"
        )
    if backend not in ("scan", "pallas"):
        raise ValueError(f"unknown signature backend {backend!r}; use scan|pallas|oph")


def make_fused_tile_step(
    params: MinHashParams, backend: str, device: str | torch.device
):
    """The per-tile step of the packed dedup path, ``step(running, packed,
    *, rows, width) -> running``: fold one packed tile (``ops.pack``) into
    the accumulator in place.  For a CUDA tile it launches the kernel's
    fold entry point; for a CPU tile it runs :func:`fused_tile_step_plain`.
    ``backend`` is checked by :func:`check_backend`.
    """
    check_backend(backend)
    device = torch.device(device)
    if device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.minhash_cuda import NUM_PERM, minhash_fold

        if params.num_perm != NUM_PERM:
            raise ValueError(
                f"the CUDA MinHash kernel is specialised to {NUM_PERM} perms, "
                f"got {params.num_perm}"
            )
        a, b = perm_tensors(params, device)

    def fused_tile_step(
        running: torch.Tensor, packed: torch.Tensor, *, rows: int, width: int
    ) -> torch.Tensor:
        if packed.device.type != device.type:
            raise ValueError(f"step built for {device}, tile is on {packed.device}")
        if device.type == "cuda":
            return minhash_fold(
                running, packed, rows=rows, width=width, a=a, b=b,
                k=params.shingle_k,
            )
        return fused_tile_step_plain(
            running, packed, rows=rows, width=width, params=params
        )

    return fused_tile_step
