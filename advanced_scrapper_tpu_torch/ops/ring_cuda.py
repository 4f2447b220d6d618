"""Wrapper of the hand-written CUDA ring join (``csrc/ring.cu``).

:func:`ring_join` does, in two launches (:func:`join_launches`), one hop of
the mesh's ring dedup for one shard: every local row's band lookups in the
transit block's presorted keys, merged with the shard's own presort, each
candidate's signature agreement, and ``rep = min(rep, cand)``;
it replaces the reference's jnp ``parallel/ring.py:_best_match_against_sorted``
(its ``band_body`` under ``lax.scan``).  It checks device, dtype, shape and
contiguity, launches on PyTorch's current stream, raises if the launch
returns a CUDA error, and counts its launches in a plain integer attribute
(``ring_join.launches``).  The plain version is
``parallel.ring.join_plain``; this wrapper never falls back to it, and a
CPU tensor raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops import _build

_ptr = ctypes.c_void_p
_int = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("ring")
    lib.astt_ring_join.argtypes = [
        _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _int,
        ctypes.c_float, _ptr, _ptr, _ptr,
    ]
    lib.astt_ring_join.restype = ctypes.c_int
    lib.astt_ring_join_launches.argtypes = []
    lib.astt_ring_join_launches.restype = ctypes.c_int
    lib.astt_ring_error_string.argtypes = [ctypes.c_int]
    lib.astt_ring_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtypes: tuple, shape: tuple, dev: torch.device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_join(keys_l, sig_l, gidx_l, sorted_keys, perm, gidx_eff, sig_b, rep, bits, sorted_l,
                order_l) -> None:
    """Raise unless the local block (``keys_l int64[Bl, nb]``, ``sig_l
    uint32/int32[Bl, P]``, ``gidx_l int32[Bl]``, ``rep int32[Bl]``, its
    presort ``sorted_l int64[nb, Bl]`` and ``order_l int32[Bl]``) and the
    transit block (``sorted_keys int64[nb, Bt]``, ``perm`` and ``gidx_eff``
    ``int32[Bt]``, ``sig_b uint32/int32[Bt, P]``) are contiguous on one
    CUDA device with ``Bt >= 1`` and both blocks' rows fitting ``bits``
    row bits.  Reads no values."""
    if keys_l.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got keys_l on {keys_l.device}; the plain "
            "version parallel.ring.join_plain runs on the CPU"
        )
    dev = keys_l.device
    if keys_l.ndim != 2 or sig_l.ndim != 2 or sorted_keys.ndim != 2:
        raise ValueError("keys_l, sig_l and sorted_keys must be 2-D")
    (Bl, nb), P, Bt = keys_l.shape, sig_l.shape[1], sorted_keys.shape[1]
    sig_types = (torch.uint32, torch.int32)
    _check(keys_l, "keys_l", (torch.int64,), (Bl, nb), dev)
    _check(sig_l, "sig_l", sig_types, (Bl, P), dev)
    _check(gidx_l, "gidx_l", (torch.int32,), (Bl,), dev)
    _check(rep, "rep", (torch.int32,), (Bl,), dev)
    _check(sorted_keys, "sorted_keys", (torch.int64,), (nb, Bt), dev)
    _check(perm, "perm", (torch.int32,), (Bt,), dev)
    _check(gidx_eff, "gidx_eff", (torch.int32,), (Bt,), dev)
    _check(sig_b, "sig_b", sig_types, (Bt, P), dev)
    _check(sorted_l, "sorted_l", (torch.int64,), (nb, Bl), dev)
    _check(order_l, "order_l", (torch.int32,), (Bl,), dev)
    if nb < 1 or P < 1 or Bt < 1:
        raise ValueError(f"the join needs bands, words and transit rows, got {nb}, {P}, {Bt}")
    if not 0 <= bits <= 31 or (max(Bt, Bl) - 1) >> bits:
        raise ValueError(f"{max(Bt, Bl)} rows do not fit {bits} row bits (at most 31)")


def join_launches() -> int:
    """Kernel launches of one :func:`ring_join` call with local rows
    (builds the library if needed)."""
    return _lib().astt_ring_join_launches()


def ring_join(
    keys_l: torch.Tensor,
    sig_l: torch.Tensor,
    gidx_l: torch.Tensor,
    sorted_keys: torch.Tensor,
    perm: torch.Tensor,
    gidx_eff: torch.Tensor,
    sig_b: torch.Tensor,
    rep: torch.Tensor,
    *,
    threshold: float,
    bits: int,
    sorted_l: torch.Tensor,
    order_l: torch.Tensor,
) -> torch.Tensor:
    """``rep``, updated in place to ``min(rep, cand)``: ``cand[r]`` is the
    smallest transit global row ``gidx_eff[perm[i]]`` that heads local row
    ``r``'s key run in some band (``sorted_keys``' packed ``(key << bits) |
    i``, each band ascending), comes before it (``< gidx_l[r]``) and agrees
    with its signature on ``count / P >= threshold`` (float32, the bar
    rounded to float32); ``gidx_l[r]`` where none does.

    The kernel reads the local keys through their presort (``sorted_l``,
    ``order_l``: ``parallel.ring._presort_bands`` of ``keys_l``, packed with
    the same ``bits``), which the caller keeps for every hop; ``keys_l``
    itself is checked, not read."""
    _check_join(keys_l, sig_l, gidx_l, sorted_keys, perm, gidx_eff, sig_b, rep, bits, sorted_l,
                order_l)
    (Bl, nb), P, Bt = keys_l.shape, sig_l.shape[1], sorted_keys.shape[1]
    if Bl:
        table = torch.empty((Bl, nb, 2), dtype=torch.int32, device=keys_l.device)
        err = _lib().astt_ring_join(
            sig_l.data_ptr(), gidx_l.data_ptr(), sorted_l.data_ptr(), order_l.data_ptr(),
            sorted_keys.data_ptr(), perm.data_ptr(), gidx_eff.data_ptr(), sig_b.data_ptr(), Bl,
            Bt, nb, P, bits, float(np.float32(threshold)), table.data_ptr(), rep.data_ptr(),
            torch.cuda.current_stream(keys_l.device).cuda_stream,
        )
        if err:
            msg = _lib().astt_ring_error_string(err).decode()
            raise RuntimeError(f"ring_join launch failed: CUDA error {err} ({msg})")
        ring_join.launches += join_launches()
    return rep


ring_join.launches = 0
