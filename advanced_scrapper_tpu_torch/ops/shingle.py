"""Byte-shingle hashing in plain PyTorch.

Counterpart of the reference's ``ops/shingle.py``: a k-byte rolling
FNV-1a hash and the murmur3 finaliser over ``uint8[B, L]`` rows.

PyTorch has no unsigned 32-bit arithmetic on the CPU (no ``>>``,
``minimum`` or ``amin`` for ``uint32``), so the plain versions carry
32-bit values in ``int64`` in ``[0, 2³²)`` and mask after every multiply.
A product of two such values can pass 2⁶³ and wrap; its low 32 bits are
still exact, and the mask keeps only those.  :func:`u32_values` and
:func:`to_u32` convert at the boundaries; 32-bit data at rest (signatures,
the accumulator) is ``torch.uint32``, handled through its ``int32`` view,
which every device supports.
"""

from __future__ import annotations

import torch

FNV_OFFSET = 0x811C9DC5
FNV_PRIME = 0x01000193
U32_MAX = 0xFFFFFFFF
U32_MASK = 0xFFFFFFFF


def u32_values(x: torch.Tensor) -> torch.Tensor:
    """``uint32``/``int32`` bit patterns → ``int64`` values in ``[0, 2³²)``."""
    if x.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"expected a 32-bit tensor, got {x.dtype}")
    return x.view(torch.int32).to(torch.int64) & U32_MASK


def to_u32(v: torch.Tensor) -> torch.Tensor:
    """``int64`` values in ``[0, 2³²)`` → a ``torch.uint32`` tensor (built
    through its ``int32`` view: the cast to ``int32`` is exact)."""
    return (v - ((v & 0x80000000) << 1)).to(torch.int32).view(torch.uint32)


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finaliser on ``int64`` values in ``[0, 2³²)``.  The
    shifts are logical because the values are non-negative."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32_MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32_MASK
    return h ^ (h >> 16)


def shingle_hash(
    tokens: torch.Tensor, lengths: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash every k-byte shingle of each row.

    ``tokens`` is ``uint8[B, L]``, ``lengths`` ``int32[B]``.  Returns
    ``(hashes int64[B, L-k+1] in [0, 2³²), valid bool[B, L-k+1])`` with
    ``valid[b, i]`` iff shingle ``i`` lies inside the first ``lengths[b]``
    bytes.
    """
    if tokens.ndim != 2:
        raise ValueError(f"tokens must be rank-2, got {tuple(tokens.shape)}")
    L = tokens.shape[-1]
    if L < k:
        raise ValueError(f"block length {L} < shingle width {k}")
    t = tokens.to(torch.int64)
    n = L - k + 1
    h = torch.full(
        (tokens.shape[0], n), FNV_OFFSET, dtype=torch.int64, device=tokens.device
    )
    for j in range(k):
        h = ((h ^ t[:, j : j + n]) * FNV_PRIME) & U32_MASK
    h = fmix32(h)
    pos = torch.arange(n, dtype=torch.int64, device=tokens.device)
    n_valid = (lengths.to(torch.int64) - (k - 1)).clamp_min(0)
    return h, pos[None, :] < n_valid[:, None]
