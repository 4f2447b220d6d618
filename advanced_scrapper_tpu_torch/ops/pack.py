"""One buffer per dedup tile, so each tile crosses to the card in one copy.

Counterpart of the reference's ``ops/pack.py`` (dedup form).  Layout,
with ``rows`` and ``width`` known to both sides::

    [0, rows*width)                  tokens, row-major uint8
    [rows*width, +4*rows)            lengths, int32 little-endian
    [rows*width + 4*rows, +4*rows)   owners, int32 little-endian

The CUDA kernel reads this buffer in place; ``rows*width`` is a multiple
of 4 (``width ≥ 64`` in the engine's buckets, ``rows`` a multiple of 64),
so the two planes are 4-byte aligned.
"""

from __future__ import annotations

import numpy as np
import torch

#: trailer bytes per row: lengths (4) + owners (4)
TRAILER_BYTES_PER_ROW = 8


def packed_nbytes(rows: int, width: int, n_planes: int = 2) -> int:
    """Size of a packed tile buffer in bytes (``n_planes`` int32 planes)."""
    return rows * (width + 4 * n_planes)


def pack_tile(
    tok: np.ndarray,
    lens: np.ndarray,
    owners: np.ndarray,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """``uint8[rows*(width+8)]`` single-buffer form of the dedup
    ``(tokens, lengths, owners)`` tile, written into ``out`` when given
    (the engine passes a pinned host buffer, saving one copy)."""
    rows, width = tok.shape
    n = packed_nbytes(rows, width)
    if out is None:
        out = np.empty(n, np.uint8)
    elif out.shape != (n,) or out.dtype != np.uint8:
        raise ValueError(f"out must be uint8[{n}], got {out.dtype}{out.shape}")
    out[: rows * width] = tok.reshape(-1)
    off = rows * width
    for plane in (lens, owners):
        out[off : off + 4 * rows] = np.ascontiguousarray(plane, dtype="<i4").view(
            np.uint8
        )
        off += 4 * rows
    return out


def unpack_tile(
    packed: torch.Tensor, rows: int, width: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_tile` on a ``uint8`` tensor: ``(tokens
    uint8[rows, width], lengths int32[rows], owners int32[rows])``.  The
    planes are rebuilt from their little-endian bytes arithmetically, so
    the result does not depend on the host's byte order or alignment."""
    if packed.dtype != torch.uint8 or packed.numel() != packed_nbytes(rows, width):
        raise ValueError(
            f"packed must be uint8[{packed_nbytes(rows, width)}], got "
            f"{packed.dtype}[{packed.numel()}]"
        )
    tok = packed[: rows * width].reshape(rows, width)
    words = packed[rows * width :].to(torch.int64).reshape(2, rows, 4)
    vals = (
        words[..., 0]
        | (words[..., 1] << 8)
        | (words[..., 2] << 16)
        | (words[..., 3] << 24)
    )
    vals = vals - ((vals & 0x80000000) << 1)  # two's complement int32
    return tok, vals[0].to(torch.int32), vals[1].to(torch.int32)
