"""Wrappers of the hand-written CUDA MinHash kernel (``csrc/minhash.cu``).

Counterpart of the reference's ``ops/pallas_minhash.py``: the kernel
replaces ``_minhash_kernel`` there.  Two entry points share one kernel:

- :func:`minhash_sig` — ``(tokens uint8[B, W], lengths int32[B]) →
  uint32[B, 128]``, the function of ``minhash_signatures_pallas`` without
  its padding requirements;
- :func:`minhash_fold` — one packed tile (``ops.pack``) folded into the
  running ``uint32[N, 128]`` accumulator in place, by owner, with
  ``atomicMin``: the body of the reference's fused tile step.

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises if the launch returns a CUDA error, and
counts its launches in a plain integer attribute (``minhash_fold.launches``).
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

_ptr = ctypes.c_void_p
_int = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared
    (pointers as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("minhash")
    lib.astt_minhash_sig.argtypes = [_ptr, _ptr, _int, _int, _int, _ptr, _ptr, _ptr, _ptr]
    lib.astt_minhash_sig.restype = _int
    lib.astt_minhash_fold.argtypes = [_ptr, _int, _int, _int, _ptr, _ptr, _ptr, _int, _ptr]
    lib.astt_minhash_fold.restype = _int
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
    out = torch.empty((rows, NUM_PERM), dtype=torch.int32, device=dev)
    if rows:
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
        err = _lib().astt_minhash_fold(
            packed.data_ptr(), rows, width, k, a.data_ptr(), b.data_ptr(),
            running.data_ptr(), running.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(err, "minhash_fold")
        minhash_fold.launches += 1
    return running


minhash_fold.launches = 0
