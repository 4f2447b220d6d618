"""Wrappers of the hand-written CUDA OPH kernels (``csrc/oph.cu``).

Counterpart of the reference's jnp ``ops/oph.py`` on the device: the
reference sorts each padded tile of shingle hashes (``_raw_impl``) and
densifies by pointer doubling (``densify``); here three addressing modes
of one fold kernel take each bin's minimum directly, and one kernel
densifies:

- :func:`oph_fold_segments` — segments given by ``(start, shingles,
  owner)`` descriptors into one flat text, folded into the running raw
  ``uint32[N, P]`` accumulator in place: the engine's main path;
- :func:`oph_fold` — one packed tile (``ops.pack``) folded into the
  accumulator, one owner per row: the reference's fused tile step under
  ``backend="oph"``;
- :func:`oph_sig` — ``(tokens uint8[B, W], lengths int32[B]) →
  uint32[B, P]`` raw signatures: the unpacked tile transport;
- :func:`oph_densify` — ``uint32[B, P]`` raw → densified.

``P`` is the number of bins, a power of two in ``[2, MAX_BINS]``.  Each
wrapper checks device, dtype, shape and contiguity, launches on PyTorch's
current stream inside a profiler range of its own name, raises if the
launch returns a CUDA error, and counts its launches in a plain integer
attribute (``oph_fold.launches``).  The plain
PyTorch versions are in ``ops.oph``; these wrappers never fall back to
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advanced_scrapper_tpu_torch.ops import _build
from advanced_scrapper_tpu_torch.ops.minhash_cuda import (
    MAX_K,
    MAX_SEGMENT_SHINGLES,
    _check,
    _check_cuda,
    check_segments,
    named,
)
from advanced_scrapper_tpu_torch.ops.pack import packed_nbytes

MAX_BINS = 1024  # kMaxBins in csrc/oph.cu
#: the fold's walk (``csrc/oph.cu``; the CPU tests model it): consecutive
#: shingles a lane hashes at a time, ranges of units per resident warp,
#: fewest shingles in a tile piece
LANE_SHINGLES = 8  # kLaneShingles
RANGES_PER_WARP = 4  # kRangesPerWarp
MIN_TILE_PIECE = 256  # kMinPiece

_ptr = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = _build.load("oph")
    lib.astt_oph_sig.argtypes = [_ptr, _ptr, _int, _int, _int, _int, _ptr, _ptr]
    lib.astt_oph_fold.argtypes = [_ptr, _int, _int, _int, _int, _ptr, _int, _ptr]
    lib.astt_oph_fold_segments.argtypes = [
        _ptr, _i64, _ptr, _ptr, _ptr, _i64, _int, _int, _ptr, _int, _ptr
    ]
    lib.astt_oph_densify.argtypes = [_ptr, _int, _int, _ptr, _ptr]
    for fn in (lib.astt_oph_sig, lib.astt_oph_fold, lib.astt_oph_fold_segments,
               lib.astt_oph_densify, lib.astt_oph_max_segment_shingles,
               lib.astt_oph_max_bins, lib.astt_oph_lane_shingles,
               lib.astt_oph_ranges_per_warp, lib.astt_oph_min_tile_piece):
        fn.restype = _int
    if (lib.astt_oph_max_segment_shingles(), lib.astt_oph_max_bins(),
            lib.astt_oph_lane_shingles(), lib.astt_oph_ranges_per_warp(),
            lib.astt_oph_min_tile_piece()) != (
        MAX_SEGMENT_SHINGLES, MAX_BINS, LANE_SHINGLES, RANGES_PER_WARP, MIN_TILE_PIECE
    ):
        raise RuntimeError("csrc/oph.cu and ops/oph_cuda.py disagree on their limits")
    lib.astt_oph_error_string.argtypes = [_int]
    lib.astt_oph_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = _lib().astt_oph_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def check_bins(bins: int) -> None:
    """Raise unless ``bins`` is a power of two in ``[2, MAX_BINS]``."""
    if bins < 2 or bins > MAX_BINS or bins & (bins - 1):
        raise ValueError(
            f"the CUDA OPH kernels take a power-of-two bin count in [2, {MAX_BINS}], "
            f"got {bins}"
        )


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"shingle width {k} outside [1, {MAX_K}]")


def _check_running(running: torch.Tensor, dev: torch.device) -> int:
    _check(running, "running", (torch.uint32, torch.int32), dev)
    if running.ndim != 2:
        raise ValueError(f"running must be [N, P], got {tuple(running.shape)}")
    check_bins(running.shape[1])
    return running.shape[1]


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def oph_sig(tokens: torch.Tensor, lengths: torch.Tensor, bins: int, k: int) -> torch.Tensor:
    """Raw ``uint32[B, bins]`` OPH signatures of ``tokens uint8[B, W]``
    rows with ``lengths int32[B]`` valid bytes; empty bins ``U32_MAX``."""
    check_bins(bins)
    _check_k(k)
    dev = _check_cuda(tokens)
    _check(tokens, "tokens", (torch.uint8,), dev)
    _check(lengths, "lengths", (torch.int32,), dev)
    if tokens.ndim != 2 or lengths.shape != (tokens.shape[0],):
        raise ValueError(
            f"tokens must be [B, W] and lengths [B], got {tuple(tokens.shape)} "
            f"and {tuple(lengths.shape)}"
        )
    rows, width = tokens.shape
    if width < k:
        raise ValueError(f"block length {width} < shingle width {k}")
    out = torch.full((rows, bins), -1, dtype=torch.int32, device=dev)
    if rows:
        with named("oph_sig"):
            err = _lib().astt_oph_sig(
                tokens.data_ptr(), lengths.data_ptr(), rows, width, k, bins,
                out.data_ptr(), _stream(dev),
            )
        _raise_on(err, "oph_sig")
        oph_sig.launches += 1
    return out.view(torch.uint32)


oph_sig.launches = 0


def oph_fold(
    running: torch.Tensor, packed: torch.Tensor, *, rows: int, width: int, k: int
) -> torch.Tensor:
    """Fold one packed tile into the raw ``running uint32[N, P]`` in place
    (and return it): ``running[owner[r]] = min(running[owner[r]], raw(r))``."""
    _check_k(k)
    dev = _check_cuda(running)
    bins = _check_running(running, dev)
    _check(packed, "packed", (torch.uint8,), dev)
    if packed.numel() != packed_nbytes(rows, width):
        raise ValueError(
            f"packed holds {packed.numel()} bytes, a {rows}x{width} tile "
            f"needs {packed_nbytes(rows, width)}"
        )
    if width < k:
        raise ValueError(f"block length {width} < shingle width {k}")
    if (rows * width) % 4 or packed.data_ptr() % 4:
        raise ValueError("the packed lengths/owners planes must be 4-byte aligned")
    if rows:
        with named("oph_fold"):
            err = _lib().astt_oph_fold(
                packed.data_ptr(), rows, width, k, bins, running.data_ptr(),
                running.shape[0], _stream(dev),
            )
        _raise_on(err, "oph_fold")
        oph_fold.launches += 1
    return running


oph_fold.launches = 0


def oph_fold_segments(
    running: torch.Tensor,
    text: torch.Tensor,
    seg_start: torch.Tensor,
    seg_shingles: torch.Tensor,
    seg_owner: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Fold segments of ``text uint8[T]`` into the raw ``running
    uint32[N, P]`` in place (and return it): each shingle's hash ``h``
    mins into ``running[owner, h >> (32 - log2 P)]``.  Segments with an
    owner outside ``[0, N)`` are dropped.  The descriptors may lie on the
    CPU (pinned) or on the card; they are checked where they lie
    (``ops.minhash_cuda.check_segments``), then moved to the card."""
    _check_k(k)
    check_segments(text.numel(), seg_start, seg_shingles, seg_owner, k)
    dev = _check_cuda(running)
    bins = _check_running(running, dev)
    _check(text, "text", (torch.uint8,), dev)
    if text.ndim != 1:
        raise ValueError(f"text must be 1-D, got {tuple(text.shape)}")
    n_seg = seg_start.numel()
    if n_seg and running.shape[0]:
        start, shingles, owner = (
            t.to(dev, non_blocking=True) for t in (seg_start, seg_shingles, seg_owner)
        )
        with named("oph_fold_segments"):
            err = _lib().astt_oph_fold_segments(
                text.data_ptr(), text.numel(), start.data_ptr(), shingles.data_ptr(),
                owner.data_ptr(), n_seg, k, bins, running.data_ptr(), running.shape[0],
                _stream(dev),
            )
        _raise_on(err, "oph_fold_segments")
        oph_fold_segments.launches += 1
    return running


oph_fold_segments.launches = 0


def oph_densify(sig: torch.Tensor) -> torch.Tensor:
    """Densified copy of raw ``sig uint32[B, P]``: each empty bin takes
    the nearest filled bin to its right (circularly) at distance ``d`` as
    ``v + d·0x9E3779B1 mod 2³²``; all-empty rows stay all-``U32_MAX``."""
    dev = _check_cuda(sig)
    _check(sig, "sig", (torch.uint32, torch.int32), dev)
    if sig.ndim != 2:
        raise ValueError(f"sig must be [B, P], got {tuple(sig.shape)}")
    rows, bins = sig.shape
    check_bins(bins)
    out = torch.empty((rows, bins), dtype=torch.int32, device=dev)
    if rows:
        with named("oph_densify"):
            err = _lib().astt_oph_densify(
                sig.data_ptr(), rows, bins, out.data_ptr(), _stream(dev)
            )
        _raise_on(err, "oph_densify")
        oph_densify.launches += 1
    return out.view(torch.uint32)


oph_densify.launches = 0
