"""Carry the reference package's state into the port.

The system has no weights: its parameters are the hash-family arrays of
``MinHashParams``, and its resumable state is the per-article signature
accumulator.  Both cross as numpy arrays, so a corpus begun under the JAX
package can be finished here.  The stream backend's npz checkpoint and the
persistent index's directory need no converter: both packages write and
read the same npz members, dtypes and fingerprint
(``extractors/tpu_batch.py``), and the same manifest, WAL, segment and
docmap bytes (``index/``).
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_scrapper_tpu_torch import resolve_device
from advanced_scrapper_tpu_torch.core.hashing import MinHashParams


def _as(x, dtype, shape: tuple[int, ...], name: str) -> np.ndarray:
    arr = np.asarray(x)
    if arr.dtype != dtype or arr.shape != shape:
        raise ValueError(f"{name} must be {np.dtype(dtype).name}{list(shape)}, "
                         f"got {arr.dtype.name}{list(arr.shape)}")
    return arr.copy()


def params_from_reference(
    num_perm: int,
    num_bands: int,
    shingle_k: int,
    seed: int,
    a32,
    b32,
    band_salt,
    a61,
    b61,
) -> MinHashParams:
    """The port's :class:`MinHashParams` from the arrays of a reference
    ``MinHashParams`` (``uint32`` a32/b32/band_salt, ``uint64`` a61/b61)."""
    if num_perm % num_bands:
        raise ValueError(f"num_perm {num_perm} not divisible by bands {num_bands}")
    return MinHashParams(
        num_perm=int(num_perm),
        num_bands=int(num_bands),
        shingle_k=int(shingle_k),
        seed=int(seed),
        a32=_as(a32, np.uint32, (num_perm,), "a32"),
        b32=_as(b32, np.uint32, (num_perm,), "b32"),
        band_salt=_as(band_salt, np.uint32, (num_bands,), "band_salt"),
        a61=_as(a61, np.uint64, (num_perm,), "a61"),
        b61=_as(b61, np.uint64, (num_perm,), "b61"),
    )


def accumulator_from_numpy(
    sig_u32: np.ndarray, device: str | torch.device | None = None
) -> torch.Tensor:
    """A reference signature accumulator ``uint32[N, P]`` as the port's
    device tensor (``torch.uint32``), ready for the tile step to fold more
    tiles into and for the resolve epilogue."""
    arr = np.asarray(sig_u32)
    if arr.dtype != np.uint32 or arr.ndim != 2:
        raise ValueError(f"expected uint32[N, P], got {arr.dtype.name}{list(arr.shape)}")
    t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32).copy())
    return t.to(resolve_device(device)).view(torch.uint32)
