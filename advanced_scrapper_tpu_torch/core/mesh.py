"""Device mesh: a ``(data, seq)`` grid of shards over one process or a
``torch.distributed`` world.

Counterpart of the reference's ``core/mesh.py``.  A shard is one
``(rank, device)`` pair and holds one accumulator (or one slice of a
batch); the grid's axes are the reference's:

- ``data`` — batch data parallelism: rows are split over this axis;
- ``seq`` — sequence parallelism for long articles: the byte axis is split
  over it and partial MinHash minima combine with a min collective.

Global shard order is row-major over the grid and rank-major across
ranks, as ``jax.devices()`` orders the reference's devices: rank 0's
shards come first.  A rank owns its *local* shards; in a world of one
process every shard is local, so ``build_mesh(4, 2, devices=["cpu"] * 8)``
is the counterpart of the reference tests' 8-device virtual CPU mesh and
``build_mesh(4, 2, devices=["cuda:0"] * 8)`` the same mesh on one card.
Several shards may share a device; each keeps its own tensors.

In a ``torch.distributed`` world every rank builds the same mesh (the
call is collective): ranks exchange their local shard counts, and the
process groups that the axis collectives cross ranks on
(``parallel.collectives``) are made here, once per distinct set of ranks
(the whole world uses the default group).

:class:`ShardedArray` is a global array as this rank holds it: one piece
per local shard, split along the dimensions its ``spec`` names (the
reference's ``PartitionSpec``); :func:`place` splits a host array.

The reference's ``shard_map_compat`` (a jax API shim) and
``maybe_enable_compile_cache`` (XLA's persistent compilation cache) have
no counterpart: the port runs no tracer, and the kernel build cache
(``ops/_build.py``, ``build/kernels/`` keyed by a hash of the source)
already keeps compiled code across processes.  ``auto_h2d_workers`` lives
in ``pipeline/dispatch.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


def local_device_count() -> int:
    """The cards this process sees (the reference counts ``jax.devices()``,
    every device of its world)."""
    return torch.cuda.device_count()


@dataclass(frozen=True)
class Shard:
    """One shard of a mesh: the rank that owns it and its device there."""

    rank: int
    device: torch.device


def rank_and_world() -> tuple[int, int]:
    """``(rank, world size)`` of the initialised ``torch.distributed``
    world, ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device(d) -> torch.device:
    """A shard's device: ``cpu``, or a card with its index (``cuda`` alone
    names the current card)."""
    d = torch.device(d)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}; use cuda or cpu")
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass devices=['cpu'] * n")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def _default_devices() -> list[torch.device]:
    n = local_device_count()
    if n == 0:
        raise RuntimeError(
            "CUDA is not available: a mesh takes every card of the rank by default; "
            "pass devices=['cpu'] * n to run the plain PyTorch versions"
        )
    return [torch.device("cuda", i) for i in range(n)]


#: process groups by their ranks, made once in a process: every rank of a
#: world builds its meshes in the same order, so each ``new_group`` call
#: (collective over the whole world) is made on every rank or on none
_GROUPS: dict[tuple[int, ...], object] = {}


class Mesh:
    """A ``(data, seq)`` grid of :class:`Shard` s.

    ``shape`` maps each axis name to its size and ``axis_names`` orders
    them, as a ``jax.sharding.Mesh`` does; ``shards`` is the global shard
    order, ``local`` the global indices of this rank's shards.  Equal
    meshes (same axes, shape and shards) compare and hash equal.
    ``stats`` counts the collectives this rank ran on the mesh
    (``parallel.collectives``)."""

    def __init__(self, shards: Sequence[Shard], shape: tuple[int, int],
                 axis_names: tuple[str, str], rank: int, world: int):
        self.shards = tuple(shards)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = rank
        self.world = world
        self.local = [g for g, s in enumerate(self.shards) if s.rank == rank]
        self._groups: dict[tuple[int, ...], object] = {}
        self.stats = new_stats()

    @property
    def size(self) -> int:
        return len(self.shards)

    def coords(self, g: int) -> tuple[int, int]:
        """Grid coordinates of global shard ``g``."""
        sp = self.shape[self.axis_names[1]]
        return g // sp, g % sp

    def index(self, coords: Sequence[int]) -> int:
        return coords[0] * self.shape[self.axis_names[1]] + coords[1]

    def group(self, ranks: tuple[int, ...]):
        """The process group of ``ranks`` (``None``, the default group,
        for the whole world)."""
        if len(ranks) == self.world:
            return None
        return self._groups[ranks]

    def _key(self) -> tuple:
        return self.axis_names, tuple(self.shape.values()), self.shards

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        dims = "x".join(str(v) for v in self.shape.values())
        return f"Mesh({dims}, ranks={self.world}, local={len(self.local)})"


def new_stats() -> dict:
    """Zeroed collective counters (:attr:`Mesh.stats`): cross-rank calls
    by op, the bytes they sent, their host-clock ms, the gloo staging
    copies (device → pinned host → device) with their bytes and ms, and
    the local combines (torch ops across a rank's shards)."""
    return {"calls": {}, "wire_bytes": 0, "ms": 0.0, "staging_copies": 0,
            "staging_bytes": 0, "staging_ms": 0.0, "local_combines": 0}


def _axis_rank_sets(shards: Sequence[Shard], shape: tuple[int, int]) -> list[tuple[int, ...]]:
    """Every distinct set of ranks that one axis group of the grid spans
    (the data columns, the seq rows, the whole grid), in a fixed order."""
    dp, sp = shape
    sets = set()
    for j in range(sp):  # data axis: one group per seq coordinate
        sets.add(tuple(sorted({shards[i * sp + j].rank for i in range(dp)})))
    for i in range(dp):  # seq axis: one group per data coordinate
        sets.add(tuple(sorted({shards[i * sp + j].rank for j in range(sp)})))
    sets.add(tuple(sorted({s.rank for s in shards})))
    return sorted(sets)


def build_mesh(
    data_parallel: int = -1,
    seq_parallel: int = 1,
    *,
    data_axis: str = "data",
    seq_axis: str = "seq",
    devices=None,
) -> Mesh:
    """Build a ``(data, seq)`` mesh.

    ``devices`` are this rank's shards' devices (strings or
    ``torch.device``), by default every card of the rank (raises without
    one).  In a ``torch.distributed`` world the global shard list is every
    rank's, rank-major; each rank must bring as many shards, and the
    grid's rows must fall on ranks evenly (a rank's shard count a
    multiple or a divisor of ``seq_parallel``).  ``data_parallel == -1``
    consumes all remaining shards.
    """
    local_devs = [_device(d) for d in (devices if devices is not None
                                       else _default_devices())]
    rank, world = rank_and_world()
    counts = [len(local_devs)]
    if world > 1:
        import torch.distributed as dist

        counts = [None] * world
        dist.all_gather_object(counts, len(local_devs))
        if len(set(counts)) != 1:
            raise ValueError(f"ranks bring unequal shard counts {counts}")
    n = sum(counts)
    if seq_parallel < 1 or n % seq_parallel:
        raise ValueError(f"seq_parallel {seq_parallel} must divide device count {n}")
    if data_parallel == -1:
        data_parallel = n // seq_parallel
    if data_parallel * seq_parallel != n:
        raise ValueError(
            f"mesh {data_parallel}x{seq_parallel} != {n} devices available"
        )
    per = counts[0]
    if world > 1 and per % seq_parallel and seq_parallel % per:
        raise ValueError(
            f"{per} shards a rank do not tile rows of {seq_parallel}: the "
            "axis collectives need every rank to hold whole rows or whole parts of one"
        )
    # a remote shard's device is not known here: it reads as this rank's
    # device type, with no index
    shards = [Shard(r, local_devs[i] if r == rank else torch.device(local_devs[i].type))
              for r in range(world) for i in range(per)]
    mesh = Mesh(shards, (data_parallel, seq_parallel), (data_axis, seq_axis), rank, world)
    if world > 1:
        import torch.distributed as dist

        for ranks in _axis_rank_sets(shards, (data_parallel, seq_parallel)):
            if 1 < len(ranks) < world:
                if ranks not in _GROUPS:
                    _GROUPS[ranks] = dist.new_group(list(ranks))
                mesh._groups[ranks] = _GROUPS[ranks]
    return mesh


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """``"2x4"`` → ``(2, 4)``: the (data, seq) shape of a mesh."""
    parts = spec.lower().strip().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh shape {spec!r} is not of the form DxS")
    try:
        dp, sp = int(parts[0]), int(parts[1])
    except ValueError as e:
        raise ValueError(f"mesh shape {spec!r} is not of the form DxS") from e
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh shape {spec!r} must be positive")
    return dp, sp


# -- sharded arrays ---------------------------------------------------------


def _spec_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def piece_slices(mesh: Mesh, spec: Sequence, shape: Sequence[int], g: int) -> tuple[slice, ...]:
    """The slice of a global array of ``shape`` that global shard ``g``
    holds under ``spec`` (one entry a dimension: ``None``, an axis name
    or a tuple of axis names; missing trailing entries are ``None``)."""
    coords = dict(zip(mesh.axis_names, mesh.coords(g)))
    out = []
    for d, size in enumerate(shape):
        axes = _spec_axes(spec[d] if d < len(spec) else None)
        parts, pos = 1, 0
        for a in axes:
            parts, pos = parts * mesh.shape[a], pos * mesh.shape[a] + coords[a]
        if size % parts:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split into {parts}")
        step = size // parts
        out.append(slice(pos * step, (pos + 1) * step))
    return tuple(out)


def as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (``uint32`` through its ``int32``
    view)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).cpu().numpy().view(np.uint32)
    return t.cpu().numpy()


class ShardedArray:
    """A global array of ``shape`` as this rank holds it: ``pieces[i]`` is
    local shard ``mesh.local[i]``'s part, on its device, under ``spec``."""

    def __init__(self, mesh: Mesh, spec: Sequence, pieces: list[torch.Tensor],
                 shape: Sequence[int]):
        if len(pieces) != len(mesh.local):
            raise ValueError(f"{len(pieces)} pieces for {len(mesh.local)} local shards")
        self.mesh, self.spec, self.pieces, self.shape = mesh, tuple(spec), pieces, tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def numpy(self) -> np.ndarray:
        """The global array on the host: assembled from the pieces when
        every shard is local, else the first piece of a replicated array
        (raises for a split one)."""
        mesh = self.mesh
        if not any(_spec_axes(e) for e in self.spec):
            return host_numpy(self.pieces[0])
        if len(mesh.local) != mesh.size:
            raise ValueError("a split array spans other ranks' shards")
        first = host_numpy(self.pieces[0])
        out = np.empty(self.shape, dtype=first.dtype)
        for i, g in enumerate(mesh.local):
            out[piece_slices(mesh, self.spec, self.shape, g)] = host_numpy(self.pieces[i])
        return out


def place(mesh: Mesh, x, spec: Sequence) -> ShardedArray:
    """Split the global host array ``x`` (numpy or a CPU tensor) under
    ``spec`` and copy each local shard's part to its device."""
    t = as_tensor(x)
    pieces = [put_piece(t[piece_slices(mesh, spec, t.shape, g)], mesh.shards[g].device)
              for g in mesh.local]
    return ShardedArray(mesh, spec, pieces, t.shape)


def put_piece(part: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of host ``part`` on ``dev``."""
    return part.contiguous().to(dev)
