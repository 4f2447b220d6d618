"""A multi-process world: its initialisation and the global-mesh dedup.

Counterpart of the reference's ``parallel/dist.py``, on
``torch.distributed`` where the reference has ``jax.distributed``: one
process a rank, each bringing its local shards; the global mesh lists
every rank's shards, rank-major, so rank ``r``'s local batch holds global
rows ``[r*B_local, (r+1)*B_local)``, the index space the representatives
refer to.  The cross-rank candidate resolution rides the same
``all_gather`` and ``psum`` as the one-process path
(``parallel.sharded``), and the replicated outputs are on every rank.

The world is configured by arguments or the reference's environment
variables ``ASTPU_COORDINATOR`` (``host:port`` of rank 0), and
``ASTPU_NUM_PROCESSES`` and ``ASTPU_PROCESS_ID``; the caller picks the
backend (``nccl`` when each rank owns a card, ``gloo`` on the CPU or for
ranks that share one card).  A failed initialisation raises.
"""

from __future__ import annotations

import os

import numpy as np

from advanced_scrapper_tpu_torch.core.hashing import MinHashParams
from advanced_scrapper_tpu_torch.core.mesh import (
    Mesh,
    ShardedArray,
    as_tensor,
    build_mesh,
    host_numpy,
    put_piece,
)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "nccl",
) -> bool:
    """Initialise the ``torch.distributed`` world when one is configured
    (an address given or ``ASTPU_COORDINATOR`` set), with the
    ``tcp://host:port`` init method; returns True if it did, False for
    the one-process default.  Under ``nccl`` each rank takes the card of
    its rank modulo the cards it sees."""
    import torch
    import torch.distributed as dist

    addr = coordinator_address or os.environ.get("ASTPU_COORDINATOR")
    if addr is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("ASTPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("ASTPU_PROCESS_ID", "0"))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use nccl or gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the nccl backend needs a card")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=addr if addr.startswith("tcp://") else f"tcp://{addr}",
        world_size=num_processes,
        rank=process_id,
    )
    return True


def world_info(mesh: Mesh | None = None) -> dict:
    """``process_index``, ``process_count``, and the shards of ``mesh`` (by
    default the cards: this rank's, and every rank's)."""
    from advanced_scrapper_tpu_torch.core.mesh import local_device_count, rank_and_world

    rank, world = rank_and_world()
    local = len(mesh.local) if mesh is not None else local_device_count()
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": local,
        "global_devices": mesh.size if mesh is not None else local * world,
    }


def global_mesh(n_seq: int = 1, *, devices=None) -> Mesh:
    """The mesh over every rank's shards (``devices``: this rank's, by
    default its cards), data × seq, rank-major."""
    return build_mesh(-1, n_seq, devices=devices)


def distribute_global_batch(tokens, lengths, mesh: Mesh) -> tuple[ShardedArray, ShardedArray]:
    """This rank's local ``uint8[B_local, L]`` rows → the global batch
    (``B_local × ranks`` rows, rank-major) split over the data axis, no
    rank ever holding it whole: the rank's shards cover whole rows of the
    grid, and each takes its row's part of the local batch."""
    data, seq = mesh.axis_names
    sp = mesh.shape[seq]
    rows = len(mesh.local) // sp  # grid rows on this rank
    if not rows or len(mesh.local) % sp:
        raise ValueError(f"{len(mesh.local)} local shards do not cover whole rows of {sp}")
    tok, lens = as_tensor(np.asarray(tokens)), as_tensor(np.asarray(lengths))
    per = tok.shape[0]
    if per % rows:
        raise ValueError(f"{per} local rows do not split over {rows} data shards")
    step = per // rows
    first = mesh.coords(mesh.local[0])[0]
    pt, pl = [], []
    for g in mesh.local:
        lo = (mesh.coords(g)[0] - first) * step
        dev = mesh.shards[g].device
        pt.append(put_piece(tok[lo : lo + step], dev))
        pl.append(put_piece(lens[lo : lo + step], dev))
    n = per * mesh.world
    return (ShardedArray(mesh, (data, None), pt, (n,) + tuple(tok.shape[1:])),
            ShardedArray(mesh, (data,), pl, (n,)))


#: step cache: keyed on the mesh, the params' four ints and the keyword
#: arguments; bounded, first in first out, as the reference's
_DEDUP_STEP_CACHE: dict = {}
_DEDUP_STEP_CACHE_MAX = 16


def multihost_dedup(local_tokens, local_lengths, params: MinHashParams, mesh: Mesh | None = None,
                    **kw) -> tuple[np.ndarray, np.ndarray]:
    """Global first-seen dedup across every rank's local batch:
    ``parallel.sharded.make_sharded_dedup`` over the global mesh.  Returns
    host ``(rep, hist)``, equal on every rank; ``rep[i]`` indexes the
    rank-major global batch (:func:`global_mesh`)."""
    from advanced_scrapper_tpu_torch.parallel.sharded import make_sharded_dedup

    if mesh is None:
        mesh = global_mesh()
    t, ln = distribute_global_batch(local_tokens, local_lengths, mesh)
    key = (
        mesh,
        params.num_perm, params.num_bands, params.shingle_k, params.seed,
        tuple(sorted(kw.items())),
    )
    step = _DEDUP_STEP_CACHE.pop(key, None)
    if step is None:
        while len(_DEDUP_STEP_CACHE) >= _DEDUP_STEP_CACHE_MAX:
            _DEDUP_STEP_CACHE.pop(next(iter(_DEDUP_STEP_CACHE)))
        step = make_sharded_dedup(mesh, params, **kw)
    _DEDUP_STEP_CACHE[key] = step  # (re-)insert at the back: LRU eviction
    rep, hist = step(t, ln)
    return host_numpy(rep), host_numpy(hist)
