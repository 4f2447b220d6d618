"""Wrapper of the hand-written CUDA q-gram screen (``csrc/match.cu``).

:func:`match_screen` computes, in one launch, the matcher's screen mask
``uint8[rows, N]`` (1 where the (row, name) pair survives) over the ragged
rows of a chunk on the card; it replaces the reference's jnp
``ops/match.py:_screen_core``.  It checks device, dtype, shape and
contiguity, launches on PyTorch's current stream, raises if the launch
returns a CUDA error, and counts its launches in a plain integer attribute
(``match_screen.launches``).  It reads the names in the layout of
``ops.match.screen_layout`` (sorted by gram count, a warp's names
interleaved), and writes the mask in the index's column order.  The plain version is
``ops.match.screen_plain``; this wrapper never falls back to it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops import _build
from advanced_scrapper_tpu_torch.ops.match import GROUP, SCREEN_TILE_COLS, check_rows

_ptr = ctypes.c_void_p

#: the name tables the kernel reads (``ops.match.screen_tensors``), with
#: their dtypes: the names' own and the layout of ``ops.match.screen_layout``
TABLES = {
    "kept": torch.int32, "total": torch.int32, "name_len": torch.int32, "fuzzy": torch.uint8,
    "slot_col": torch.int32, "group_off": torch.int32, "grams_il": torch.int16,
    "tile_groups": torch.int32,
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("match")
    lib.astt_match_screen.argtypes = [
        _ptr, _ptr, _ptr, _ptr, _ptr, ctypes.c_longlong, _ptr, _ptr, _ptr, _ptr, ctypes.c_int,
        _ptr, _ptr, _ptr, _ptr, ctypes.c_int, ctypes.c_float, _ptr, _ptr,
    ]
    lib.astt_match_screen.restype = ctypes.c_int
    lib.astt_match_rows_per_block.argtypes = []
    lib.astt_match_rows_per_block.restype = ctypes.c_int
    lib.astt_match_error_string.argtypes = [ctypes.c_int]
    lib.astt_match_error_string.restype = ctypes.c_char_p
    return lib


def check_tables(tables: dict, device: torch.device) -> int:
    """Raise unless ``tables`` holds the screen's name tables, contiguous,
    on ``device``, of consistent lengths; returns the name count N."""
    for name, dt in TABLES.items():
        t = tables.get(name)
        if t is None:
            raise ValueError(f"the name tables lack {name!r}")
        if t.dtype != dt or t.ndim != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D {dt}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the rows on {device}")
    n = tables["kept"].numel()
    if any(tables[k].numel() != n for k in ("total", "name_len", "fuzzy")):
        raise ValueError("the name tables disagree on the name count")
    slots = tables["slot_col"].numel()
    if (slots % GROUP or tables["group_off"].numel() != slots // GROUP + 1
            or tables["grams_il"].numel() % GROUP
            or tables["tile_groups"].numel() != -(-n // SCREEN_TILE_COLS) + 1
            or not n <= slots <= n + (GROUP - 1) * (tables["tile_groups"].numel() - 1)):
        raise ValueError("the kernel's name layout does not fit the name tables "
                         "(ops.match.screen_layout)")
    return n


def match_screen(
    text: torch.Tensor,
    row_off: torch.Tensor,
    row_len: torch.Tensor,
    text_len: torch.Tensor,
    title_len: torch.Tensor,
    tables: dict,
    frac: float | np.float32,
) -> torch.Tensor:
    """``uint8[R, N]`` screen mask of the ``R`` ragged rows (``row_len``
    bytes of ``text uint8`` at ``row_off int64``) against the ``N`` names
    of ``tables`` (``ops.match.screen_tensors`` on the card); ``frac`` is
    ``ops.match.screen_frac(threshold)``, passed as float32."""
    if text.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {text.device}; the plain "
            "version ops.match.screen_plain runs on the CPU"
        )
    dev = text.device
    check_rows(text, row_off, row_len, text_len, title_len)
    for t in (text, row_off, row_len, text_len, title_len):
        if not t.is_contiguous():
            raise ValueError("the text and row arrays must be contiguous")
    n = check_tables(tables, dev)
    rows = row_off.numel()
    out = torch.empty((rows, n), dtype=torch.uint8, device=dev)
    if rows and n:
        err = _lib().astt_match_screen(
            text.data_ptr(), row_off.data_ptr(), row_len.data_ptr(), text_len.data_ptr(),
            title_len.data_ptr(), rows, tables["slot_col"].data_ptr(),
            tables["group_off"].data_ptr(), tables["grams_il"].data_ptr(),
            tables["tile_groups"].data_ptr(), SCREEN_TILE_COLS, tables["kept"].data_ptr(),
            tables["total"].data_ptr(), tables["name_len"].data_ptr(),
            tables["fuzzy"].data_ptr(), n, float(np.float32(frac)), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            msg = _lib().astt_match_error_string(err).decode()
            raise RuntimeError(f"match_screen launch failed: CUDA error {err} ({msg})")
        match_screen.launches += 1
    return out


match_screen.launches = 0


def rows_per_block() -> int:
    """The rows each block of the built kernel screens over one bitmap."""
    return _lib().astt_match_rows_per_block()
