"""Wrappers of the hand-written CUDA MinHash kernel (``csrc/minhash.cu``).

Counterpart of the reference's ``ops/pallas_minhash.py``: the kernel
replaces ``_minhash_kernel`` there.  Three entry points are addressing
modes of one kernel template, which folds segments of at most
:data:`MAX_SEGMENT_SHINGLES` shingles into an accumulator by owner:

- :func:`minhash_fold_segments` — segments given by ``(start, shingles,
  owner)`` descriptors into one flat text, folded into the running
  ``uint32[N, 128]`` accumulator in place: the engine's main path;
- :func:`minhash_fold` — one packed tile (``ops.pack``) folded into the
  accumulator, one owner per row: the body of the reference's fused tile
  step;
- :func:`minhash_sig` — ``(tokens uint8[B, W], lengths int32[B]) →
  uint32[B, 128]``, the function of ``minhash_signatures_pallas`` without
  its padding requirements.

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream inside a profiler range of its own name (so a
``torch.profiler`` trace names the entry point beside the kernel's
symbol), raises if the launch returns a CUDA error, and counts its
launches in a plain integer attribute (``minhash_fold.launches``).
The plain PyTorch versions are in ``ops.minhash``; these wrappers never
fall back to them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advanced_scrapper_tpu_torch.ops import _build
from advanced_scrapper_tpu_torch.ops.pack import packed_nbytes

NUM_PERM = 128
MAX_K = 64  # kMaxK in csrc/minhash.cu
MAX_SEGMENT_SHINGLES = 2048  # kMaxSeg in csrc/minhash.cu

_ptr = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared
    (pointers as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("minhash")
    lib.astt_minhash_sig.argtypes = [_ptr, _ptr, _int, _int, _int, _ptr, _ptr, _ptr, _ptr]
    lib.astt_minhash_sig.restype = _int
    lib.astt_minhash_fold.argtypes = [_ptr, _int, _int, _int, _ptr, _ptr, _ptr, _int, _ptr]
    lib.astt_minhash_fold.restype = _int
    lib.astt_minhash_fold_segments.argtypes = [
        _ptr, _i64, _ptr, _ptr, _ptr, _i64, _int, _ptr, _ptr, _ptr, _int, _ptr
    ]
    lib.astt_minhash_fold_segments.restype = _int
    lib.astt_max_segment_shingles.restype = _int
    if lib.astt_max_segment_shingles() != MAX_SEGMENT_SHINGLES:
        raise RuntimeError("csrc/minhash.cu and MAX_SEGMENT_SHINGLES disagree")
    lib.astt_cuda_error_string.argtypes = [_int]
    lib.astt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtypes, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_perm(a: torch.Tensor, b: torch.Tensor, k: int) -> None:
    if a.numel() != NUM_PERM or b.numel() != NUM_PERM:
        raise ValueError(
            f"the CUDA MinHash kernel is specialised to {NUM_PERM} perms, "
            f"got {a.numel()}"
        )
    if not 1 <= k <= MAX_K:
        raise ValueError(f"shingle width {k} outside [1, {MAX_K}]")


def _check_cuda(x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {x.device}; the plain "
            "versions in ops.minhash run on the CPU"
        )
    return x.device


def named(entry: str):
    """A ``torch.profiler`` range named after the entry point, around
    its launch (a cheap no-op when no profiler runs)."""
    return torch.autograd.profiler.record_function(entry)


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = _lib().astt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def minhash_sig(
    tokens: torch.Tensor, lengths: torch.Tensor, a: torch.Tensor, b: torch.Tensor, k: int
) -> torch.Tensor:
    """``uint32[B, 128]`` signatures of ``tokens uint8[B, W]`` rows with
    ``lengths int32[B]`` valid bytes; ``a``/``b`` are the permutation
    family, ``uint32[128]`` on the same card."""
    _check_perm(a, b, k)
    dev = _check_cuda(tokens)
    _check(tokens, "tokens", (torch.uint8,), dev)
    _check(lengths, "lengths", (torch.int32,), dev)
    _check(a, "a", (torch.uint32, torch.int32), dev)
    _check(b, "b", (torch.uint32, torch.int32), dev)
    if tokens.ndim != 2 or lengths.shape != (tokens.shape[0],):
        raise ValueError(
            f"tokens must be [B, W] and lengths [B], got {tuple(tokens.shape)} "
            f"and {tuple(lengths.shape)}"
        )
    rows, width = tokens.shape
    if width < k:
        raise ValueError(f"block length {width} < shingle width {k}")
    out = torch.full((rows, NUM_PERM), -1, dtype=torch.int32, device=dev)
    if rows:
        with named("minhash_sig"):
            err = _lib().astt_minhash_sig(
                tokens.data_ptr(), lengths.data_ptr(), rows, width, k,
                a.data_ptr(), b.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(err, "minhash_sig")
        minhash_sig.launches += 1
    return out.view(torch.uint32)


minhash_sig.launches = 0


def minhash_fold(
    running: torch.Tensor,
    packed: torch.Tensor,
    *,
    rows: int,
    width: int,
    a: torch.Tensor,
    b: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Fold one packed tile into ``running uint32[N, 128]`` in place (and
    return it): ``running[owner[r]] = min(running[owner[r]], sig(r))``."""
    _check_perm(a, b, k)
    dev = _check_cuda(running)
    _check(running, "running", (torch.uint32, torch.int32), dev)
    _check(packed, "packed", (torch.uint8,), dev)
    _check(a, "a", (torch.uint32, torch.int32), dev)
    _check(b, "b", (torch.uint32, torch.int32), dev)
    if running.ndim != 2 or running.shape[1] != NUM_PERM:
        raise ValueError(f"running must be [N, {NUM_PERM}], got {tuple(running.shape)}")
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
        with named("minhash_fold"):
            err = _lib().astt_minhash_fold(
                packed.data_ptr(), rows, width, k, a.data_ptr(), b.data_ptr(),
                running.data_ptr(), running.shape[0],
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(err, "minhash_fold")
        minhash_fold.launches += 1
    return running


minhash_fold.launches = 0


def check_segments(
    text_len: int,
    seg_start: torch.Tensor,
    seg_shingles: torch.Tensor,
    seg_owner: torch.Tensor,
    k: int,
) -> None:
    """Raise unless the descriptors are 1-D ``int64``/``int32``/``int32``
    tensors of one length, contiguous, on one device, and every segment
    holds ``0..MAX_SEGMENT_SHINGLES`` shingles whose bytes lie inside a
    text of ``text_len`` bytes.  Reads the descriptors on the host: for
    tensors on the card that is one synchronisation."""
    for t, name, dtype in (
        (seg_start, "seg_start", torch.int64),
        (seg_shingles, "seg_shingles", torch.int32),
        (seg_owner, "seg_owner", torch.int32),
    ):
        _check(t, name, (dtype,), seg_start.device)
        if t.shape != (seg_start.numel(),):
            raise ValueError(
                f"the descriptors must be 1-D of one length, got "
                f"{tuple(seg_start.shape)}, {tuple(seg_shingles.shape)} and "
                f"{tuple(seg_owner.shape)}"
            )
    if not seg_start.numel():
        return
    n = seg_shingles.to(torch.int64)
    end = torch.where(n > 0, seg_start + n + (k - 1), 0)
    lo_start, lo_n, hi_n, hi_end = torch.stack(
        [seg_start.min(), n.min(), n.max(), end.max()]
    ).tolist()
    if lo_start < 0 or lo_n < 0 or hi_n > MAX_SEGMENT_SHINGLES:
        raise ValueError(
            f"segment starts must be >= 0 and shingle counts in [0, "
            f"{MAX_SEGMENT_SHINGLES}], got start {lo_start}, counts {lo_n}..{hi_n}"
        )
    if hi_end > text_len:
        raise ValueError(
            f"a segment runs past the text: byte {hi_end} of {text_len}"
        )


def minhash_fold_segments(
    running: torch.Tensor,
    text: torch.Tensor,
    seg_start: torch.Tensor,
    seg_shingles: torch.Tensor,
    seg_owner: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Fold segments of ``text uint8[T]`` into ``running uint32[N, 128]``
    in place (and return it)::

        running[owner[g]] = min(running[owner[g]],
                                min_{i < shingles[g]} sig(text[start[g] + i :][:k]))

    Segments with an owner outside ``[0, N)`` are dropped.  The descriptors
    may lie on the CPU (pinned, for an asynchronous copy) or on the card;
    they are checked where they lie (:func:`check_segments`) before the
    device checks, then moved to the card."""
    _check_perm(a, b, k)
    check_segments(text.numel(), seg_start, seg_shingles, seg_owner, k)
    dev = _check_cuda(running)
    _check(running, "running", (torch.uint32, torch.int32), dev)
    _check(text, "text", (torch.uint8,), dev)
    _check(a, "a", (torch.uint32, torch.int32), dev)
    _check(b, "b", (torch.uint32, torch.int32), dev)
    if running.ndim != 2 or running.shape[1] != NUM_PERM:
        raise ValueError(f"running must be [N, {NUM_PERM}], got {tuple(running.shape)}")
    if text.ndim != 1:
        raise ValueError(f"text must be 1-D, got {tuple(text.shape)}")
    n_seg = seg_start.numel()
    if n_seg and running.shape[0]:
        start, shingles, owner = (
            t.to(dev, non_blocking=True) for t in (seg_start, seg_shingles, seg_owner)
        )
        with named("minhash_fold_segments"):
            err = _lib().astt_minhash_fold_segments(
                text.data_ptr(), text.numel(), start.data_ptr(), shingles.data_ptr(),
                owner.data_ptr(), n_seg, k, a.data_ptr(), b.data_ptr(),
                running.data_ptr(), running.shape[0],
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(err, "minhash_fold_segments")
        minhash_fold_segments.launches += 1
    return running


minhash_fold_segments.launches = 0
