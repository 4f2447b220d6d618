"""Wrappers of the hand-written CUDA Myers kernels (``csrc/editdist.cu``).

:func:`myers_bound` runs, in one launch, the matcher's alignment bound over
the ragged rows of a chunk on the card and ORs the prune bit (bit 1) into
the screen's mask at the refine columns; it replaces the reference's jnp
``ops/editdist.py:semiglobal_dist_shared`` and the compare its fused
screen step applies.  It checks device, dtype, shape and contiguity,
launches on PyTorch's current stream, raises if the launch returns a CUDA
error, and counts its launches in a plain integer attribute
(``myers_bound.launches``).  The plain version is
``ops.editdist.myers_bound_plain``; this wrapper never falls back to it.

:func:`myers_pairs` runs, in one launch, the per-pair distance of the
legacy screen's refine (one pattern per pair, the reference's jnp
``ops/editdist.py:semiglobal_dist``) over texts joined in one buffer on
the card, a block a pair with the block's lanes over the pair's tiles;
its plain version is ``ops.editdist.semiglobal_dist_plain``, and it counts
its launches in ``myers_pairs.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops import _build
from advanced_scrapper_tpu_torch.ops.editdist import check_pairs, check_patterns
from advanced_scrapper_tpu_torch.ops.match import check_rows

_ptr = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("editdist")
    lib.astt_myers_bound.argtypes = [
        _ptr, _ptr, _ptr, _ptr, _ptr, ctypes.c_longlong, _ptr, _ptr, _ptr, _ptr,
        ctypes.c_int, ctypes.c_float, _ptr, ctypes.c_int, _ptr, _ptr,
    ]
    lib.astt_myers_bound.restype = ctypes.c_int
    lib.astt_myers_pairs.argtypes = [
        _ptr, ctypes.c_longlong, _ptr, _ptr, ctypes.c_int, _ptr, _ptr, ctypes.c_int, _ptr, _ptr,
        ctypes.c_int, _ptr, _ptr,
    ]
    lib.astt_myers_pairs.restype = ctypes.c_int
    lib.astt_myers_chains.argtypes = []
    lib.astt_myers_chains.restype = ctypes.c_int
    lib.astt_myers_error_string.argtypes = [ctypes.c_int]
    lib.astt_myers_error_string.restype = ctypes.c_char_p
    return lib


def myers_bound(
    text: torch.Tensor,
    row_off: torch.Tensor,
    row_len: torch.Tensor,
    text_len: torch.Tensor,
    flags: torch.Tensor,
    masks: torch.Tensor,
    plens: torch.Tensor,
    ok: torch.Tensor,
    cols: torch.Tensor,
    threshold: float,
    mask: torch.Tensor,
    *,
    dist: torch.Tensor | None = None,
) -> torch.Tensor:
    """OR bit 1 into ``mask uint8[R, N]`` (in place) at ``cols[k]`` for
    every row where pattern ``k`` is ``ok``, the row's text is longer than
    the pattern, its flag bit 0 is set and the Myers bound proves the
    text-side score ≤ ``threshold``.  ``masks uint32[K, 256]``, ``plens
    int32[K]``, ``ok bool[K]``, ``cols int64[K]`` on the card.  ``dist
    int32[R, K]``, where given, receives every pair's distance (every pair
    is then computed).  Returns ``mask``."""
    if text.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {text.device}; the plain "
            "version ops.editdist.myers_bound_plain runs on the CPU"
        )
    dev = text.device
    check_rows(text, row_off, row_len, text_len, flags)
    rows, k = row_off.numel(), masks.shape[0]
    if mask.dtype != torch.uint8 or mask.ndim != 2 or mask.shape[0] != rows:
        raise TypeError(f"mask must be uint8[{rows}, N], got {mask.dtype} {tuple(mask.shape)}")
    if masks.device != dev or mask.device != dev:
        raise ValueError(f"masks and mask must lie on {dev}")
    check_patterns(masks, plens, ok, cols, mask.shape[1])
    if dist is not None and (dist.dtype != torch.int32 or dist.shape != (rows, k)
                             or dist.device != dev):
        raise TypeError(f"dist must be int32[{rows}, {k}] on {dev}")
    for t in (text, row_off, row_len, text_len, flags, masks, plens, ok, cols, mask,
              *(() if dist is None else (dist,))):
        if not t.is_contiguous():
            raise ValueError("every tensor must be contiguous")
    if rows and k:
        hundred_minus_t = np.float32(100.0) - np.float32(threshold)
        err = _lib().astt_myers_bound(
            text.data_ptr(), row_off.data_ptr(), row_len.data_ptr(), text_len.data_ptr(),
            flags.data_ptr(), rows, masks.data_ptr(), plens.data_ptr(), ok.data_ptr(),
            cols.data_ptr(), k, float(hundred_minus_t), mask.data_ptr(), mask.shape[1],
            None if dist is None else dist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            msg = _lib().astt_myers_error_string(err).decode()
            raise RuntimeError(f"myers_bound launch failed: CUDA error {err} ({msg})")
        myers_bound.launches += 1
    return mask


myers_bound.launches = 0


def myers_chains() -> int:
    """The Myers chains each thread of the built kernel runs (tiles in
    flight per thread)."""
    return _lib().astt_myers_chains()


def myers_pairs(
    masks: torch.Tensor,
    plens: torch.Tensor,
    text: torch.Tensor,
    row_off: torch.Tensor,
    tlens: torch.Tensor,
    pair_text: torch.Tensor,
    pair_pat: torch.Tensor,
) -> torch.Tensor:
    """``int32[P]``: the Myers distance of pattern ``pair_pat[p]``
    (``masks uint32[K, 256]``, ``plens int32[K]``) against text
    ``pair_text[p]`` (``tlens[i]`` bytes of ``text uint8[N]`` at
    ``row_off[i]``), blocked as the reference's ``semiglobal_dist``; -1
    where the pair's indices, its text's bounds or its pattern's length lie
    out of range.  Every tensor on one card."""
    if text.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {text.device}; the plain "
            "version ops.editdist.semiglobal_dist_plain runs on the CPU"
        )
    check_pairs(masks, plens, text, row_off, tlens, pair_text, pair_pat)
    for t in (masks, plens, text, row_off, tlens, pair_text, pair_pat):
        if not t.is_contiguous():
            raise ValueError("every tensor must be contiguous")
    n = pair_text.numel()
    out = torch.empty((n,), dtype=torch.int32, device=text.device)
    if n:
        if max(n, row_off.numel(), masks.shape[0]) > 0x7FFFFFFF:
            raise ValueError("pairs, texts and patterns must each number below 2**31")
        err = _lib().astt_myers_pairs(
            text.data_ptr(), text.numel(), row_off.data_ptr(), tlens.data_ptr(),
            row_off.numel(), masks.data_ptr(), plens.data_ptr(), masks.shape[0],
            pair_text.data_ptr(), pair_pat.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream(text.device).cuda_stream,
        )
        if err:
            msg = _lib().astt_myers_error_string(err).decode()
            raise RuntimeError(f"myers_pairs launch failed: CUDA error {err} ({msg})")
        myers_pairs.launches += 1
    return out


myers_pairs.launches = 0
