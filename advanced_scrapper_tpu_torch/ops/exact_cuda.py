"""Wrapper of the hand-written CUDA exact hash (``csrc/exact.cu``).

:func:`exact_hash` computes, in one launch, the 128-bit linear hash of
ragged documents read in place from one joined byte buffer; it replaces the
reference's jnp ``ops/exact.py:_block_hash_impl`` and ``_row_hash_impl``.
It checks device, dtype, shape and contiguity, launches on PyTorch's
current stream, raises if the launch returns a CUDA error, and counts its
launches in a plain integer attribute (``exact_hash.launches``).  The plain
version is ``ops.exact.exact_hash_plain``; this wrapper never falls back to
it, and a CPU tensor raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advanced_scrapper_tpu_torch.ops import _build

_ptr = ctypes.c_void_p
_ll = ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("exact")
    lib.astt_exact_hash.argtypes = [
        _ptr, _ll, _ptr, _ptr, _ptr, _ptr, _ll, _ll, ctypes.c_int, _ptr, _ptr,
    ]
    lib.astt_exact_hash.restype = ctypes.c_int
    lib.astt_exact_error_string.argtypes = [ctypes.c_int]
    lib.astt_exact_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtypes: tuple, ndim: int, dev: torch.device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_exact(text, starts, span, mixlen, coef) -> None:
    """Raise unless ``text`` is ``uint8[T]``, ``starts`` ``int64[n]``,
    ``span`` and ``mixlen`` ``int32[n]`` and ``coef`` ``int32``/``uint32[C,
    4]``, all contiguous on one CUDA device.  Reads no values."""
    if text.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got text on {text.device}; the plain "
            "version ops.exact.exact_hash_plain runs on the CPU"
        )
    dev = text.device
    _check(text, "text", (torch.uint8,), 1, dev)
    _check(starts, "starts", (torch.int64,), 1, dev)
    n = starts.shape[0]
    for t, name in ((span, "span"), (mixlen, "mixlen")):
        _check(t, name, (torch.int32,), 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, starts {n}")
    _check(coef, "coef", (torch.int32, torch.uint32), 2, dev)
    if coef.shape[1] != 4:
        raise ValueError(f"coef must be [C, 4], got {tuple(coef.shape)}")


def exact_hash(
    text: torch.Tensor,
    starts: torch.Tensor,
    span: torch.Tensor,
    mixlen: torch.Tensor,
    coef: torch.Tensor,
    *,
    max_span: int,
) -> torch.Tensor:
    """``int32[n, 4]``, the bits of the ``uint32`` hash lanes of each
    document ``text[starts[d] : starts[d] + span[d]]``: its bytes dotted
    with the stream ``coef[:span[d]]`` mod 2³² a lane, then mixed with
    ``mixlen[d]`` (see ``ops.exact``), in one launch.

    ``max_span`` is the longest span, which the caller knows from building
    the descriptors (it sizes the stream's prefix in shared memory); the
    wrapper raises when it passes ``C`` and reads no values.  The kernel
    clamps every read to ``text`` and ``coef``."""
    _check_exact(text, starts, span, mixlen, coef)
    dev = text.device
    n, cols = starts.shape[0], coef.shape[0]
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    if not n:
        return out
    if max_span > cols:
        raise ValueError(f"a span of {max_span} bytes needs as many coefficients, coef has {cols}")
    err = _lib().astt_exact_hash(
        text.data_ptr(), text.numel(), starts.data_ptr(), span.data_ptr(), mixlen.data_ptr(),
        coef.data_ptr(), cols, max(int(max_span), 0), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        msg = _lib().astt_exact_error_string(err).decode()
        raise RuntimeError(f"exact_hash launch failed: CUDA error {err} ({msg})")
    exact_hash.launches += 1
    return out


exact_hash.launches = 0
