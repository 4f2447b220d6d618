"""Wrapper of the hand-written CUDA settle kernel (``csrc/rerank.cu``).

:func:`rerank_settle` computes, in one launch, the rerank tier's
quantized bottom-sketch Jaccard of row pairs of a sketch matrix on the
card and its verdict against the margin band; it replaces the reference's
jnp settle step (``ops/rerank.py:_pair_jq`` under ``vmap``) and finalize
(``make_rerank_finalize``).  It checks device, dtype, shape, contiguity,
the index range and the band, launches on PyTorch's current stream,
raises if the launch returns a CUDA error, and counts its launches in a
plain integer attribute (``rerank_settle.launches``).  The plain version
is ``ops.rerank.settle_plain``; this wrapper never falls back to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advanced_scrapper_tpu_torch.ops import _build

_ptr = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("rerank")
    lib.astt_rerank_settle.argtypes = [
        _ptr, ctypes.c_int, _ptr, _ptr, ctypes.c_int, ctypes.c_int, _ptr, ctypes.c_longlong,
        _ptr,
    ]
    lib.astt_rerank_settle.restype = ctypes.c_int
    lib.astt_rerank_max_sketch.restype = ctypes.c_int
    lib.astt_rerank_error_string.argtypes = [ctypes.c_int]
    lib.astt_rerank_error_string.restype = ctypes.c_char_p
    return lib


def max_sketch() -> int:
    """The widest sketch the kernel takes (builds the library if needed)."""
    return _lib().astt_rerank_max_sketch()


def check_pairs(sk: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor) -> None:
    """Raise unless ``sk`` is a 2-D ``uint32``/``int32`` sketch matrix and
    ``ia``/``ib`` are 1-D ``int32`` tensors of one length, on one device,
    whose values index its rows.  Reads the indices where they lie: for
    tensors on the card that is one synchronisation."""
    if sk.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"sk must be torch.uint32 or torch.int32, got {sk.dtype}")
    if sk.ndim != 2:
        raise ValueError(f"sk must be [n_sk, S], got {tuple(sk.shape)}")
    for t, name in ((ia, "ia"), (ib, "ib")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    if ia.ndim != 1 or ia.shape != ib.shape:
        raise ValueError(
            f"ia and ib must be 1-D of one length, got {tuple(ia.shape)} and "
            f"{tuple(ib.shape)}"
        )
    if ia.device != ib.device:
        raise ValueError(f"ia is on {ia.device} and ib on {ib.device}")
    if not ia.numel():
        return
    lo, hi = torch.stack([torch.minimum(ia.min(), ib.min()),
                          torch.maximum(ia.max(), ib.max())]).tolist()
    if lo < 0 or hi >= sk.shape[0]:
        raise ValueError(
            f"pair indices must lie in [0, {sk.shape[0]}), got {lo}..{hi}"
        )


def check_band(lo: int, hi: int) -> None:
    """Raise unless ``lo`` and ``hi`` are ints in the int32 range with
    ``lo <= hi``: the margin band ``[lo, hi)`` of quantized Jaccard."""
    for v, name in ((lo, "lo"), (hi, "hi")):
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(f"{name} must be an int, got {type(v).__name__}")
        if not -(1 << 31) <= v < 1 << 31:
            raise ValueError(f"{name} must fit int32, got {v}")
    if lo > hi:
        raise ValueError(f"the margin band [lo, hi) needs lo <= hi, got [{lo}, {hi})")


def check_settle(sk, ia, ib, lo, hi, out=None) -> None:
    """:func:`check_band` and :func:`check_pairs`, and raise unless
    ``out``, where given, is a contiguous ``int32[2, m]`` on ``sk``'s
    device.  Reads the indices where they lie (see :func:`check_pairs`)."""
    check_band(lo, hi)
    if out is not None:
        if out.dtype != torch.int32:
            raise TypeError(f"out must be torch.int32, got {out.dtype}")
        if out.shape != (2, ia.numel()) or not out.is_contiguous():
            raise ValueError(
                f"out must be a contiguous [2, {ia.numel()}], got {tuple(out.shape)}"
            )
        if out.device != sk.device:
            raise ValueError(f"out is on {out.device}, the sketches on {sk.device}")
    check_pairs(sk, ia, ib)


def rerank_settle(
    sk: torch.Tensor,
    ia: torch.Tensor,
    ib: torch.Tensor,
    size: int,
    lo: int,
    hi: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``int32[2, m]``: row 0 the quantized bottom-sketch Jaccard ``jq`` of
    the pairs ``(sk[ia], sk[ib])``, row 1 its verdict (1 keep, ``jq >=
    hi``; 0 kill, ``jq < lo``; -1 borderline), in one launch.  ``sk
    uint32[n_sk, size]`` on the card, each row ascending with unique live
    hashes and then ``PAD``; ``ia``/``ib`` ``int32[m]`` on the card, or on
    the host (pinned, for an asynchronous copy), checked where they lie;
    ``out``, where given, receives the result.  Launches nothing for
    ``m = 0``."""
    if sk.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {sk.device}; the plain "
            "version ops.rerank.settle_plain runs on the CPU"
        )
    check_settle(sk, ia, ib, lo, hi, out)
    dev = sk.device
    if not sk.is_contiguous():
        raise ValueError("sk must be contiguous")
    if sk.shape[1] != size:
        raise ValueError(f"sketch width {sk.shape[1]} must equal size {size}")
    widest = max_sketch()
    if not 1 <= size <= widest:
        raise ValueError(f"sketch width {size} must lie in [1, {widest}]")
    if ia.device not in (dev, torch.device("cpu")):
        raise ValueError(f"the indices are on {ia.device}, the sketches on {dev}")
    if not (ia.is_contiguous() and ib.is_contiguous()):
        raise ValueError("ia and ib must be contiguous")
    m = ia.numel()
    if out is None:
        out = torch.empty((2, m), dtype=torch.int32, device=dev)
    if m:
        ia_d, ib_d = (t.to(dev, non_blocking=True) for t in (ia, ib))
        err = _lib().astt_rerank_settle(
            sk.data_ptr(), size, ia_d.data_ptr(), ib_d.data_ptr(), lo, hi, out.data_ptr(),
            m, torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            msg = _lib().astt_rerank_error_string(err).decode()
            raise RuntimeError(f"rerank_settle launch failed: CUDA error {err} ({msg})")
        rerank_settle.launches += 1
    return out


rerank_settle.launches = 0
