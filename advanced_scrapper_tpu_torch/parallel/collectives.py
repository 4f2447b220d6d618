"""Axis collectives over a mesh's shards: the port's ``lax.pmin``,
``pmax``, ``psum``, ``all_gather(tiled=True)``, ``ppermute`` and
``axis_index`` inside ``shard_map``.

Each function takes one tensor per local shard of ``mesh``
(``mesh.local`` order, each on its shard's device, the same shape and
dtype on every shard) and returns one per local shard.  A collective over
some axes runs on each *axis group*: the shards that differ only along
those axes.  It combines the rank's members of a group on the first
member's device with torch ops first, then, when the group spans several
ranks, crosses ranks through ``torch.distributed`` on the group's process
group (made once, by ``core.mesh.build_mesh``).  The groups of this rank
that span the same ranks go in one call, stacked.

The backend is the caller's choice, made when the world was initialised
(``parallel.dist.initialize_multihost``), never by catching an error:

- ``nccl``: each rank's shards on its own card; tensors cross as they are;
- ``gloo``: on the CPU, and for ranks that share one card.  A card's
  tensor is copied to pinned host memory, the gloo collective runs on the
  copy, and the result is copied back, each copy explicit and counted in
  ``mesh.stats`` (``staging_copies``, ``staging_bytes``, ``staging_ms``).

``uint32`` never reaches the wire: gloo refuses it.  Minima and maxima
carry it in sign-flip order (``x ^ 0x80000000`` as ``int32``, which
orders as the unsigned values), gathers and permutes its ``int32`` bit
pattern; ``bool`` travels as ``uint8``.  The local combines use the same
forms, since PyTorch has no ``uint32`` minimum on the CPU.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from advanced_scrapper_tpu_torch.core.mesh import Mesh

_FLIP = -(1 << 31)  # int32 0x80000000


def _axes(mesh: Mesh, axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"mesh has no axis {a!r}; its axes are {mesh.axis_names}")
    return axes


def _groups(mesh: Mesh, axes: tuple[str, ...]) -> dict[tuple, list[int]]:
    """``key → global shards in axis order`` for every axis group; the key
    is the coordinates along the other axes.  Axis order is row-major over
    ``axes`` in the mesh's order, which is global shard order."""
    out: dict[tuple, list[int]] = {}
    for g in range(mesh.size):
        c = dict(zip(mesh.axis_names, mesh.coords(g)))
        out.setdefault(tuple(c[a] for a in mesh.axis_names if a not in axes), []).append(g)
    return out


def _local_groups(mesh: Mesh, axes) -> list[tuple[tuple[int, ...], list[int]]]:
    """This rank's axis groups: ``(ranks the group spans, local positions
    of its members here in axis order)``."""
    pos = {g: i for i, g in enumerate(mesh.local)}
    out = []
    for members in _groups(mesh, _axes(mesh, axes)).values():
        mine = [pos[g] for g in members if g in pos]
        if mine:
            out.append((tuple(sorted({mesh.shards[g].rank for g in members})), mine))
    return out


def _encode(x: torch.Tensor, order: bool) -> torch.Tensor:
    """The wire and combine form: ``uint32`` as ``int32`` (sign-flipped
    when ``order``), ``bool`` as ``uint8``."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
        return x ^ _FLIP if order else x
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def _decode(x: torch.Tensor, dtype: torch.dtype, order: bool) -> torch.Tensor:
    if dtype == torch.uint32:
        return (x ^ _FLIP if order else x).view(torch.uint32)
    if dtype == torch.bool:
        return x.to(torch.bool)
    return x


def _staged(mesh: Mesh, t: torch.Tensor, copy_in: bool = True):
    """``(tensor for the wire, copy back)``: under gloo a card's tensor is
    copied to pinned host memory (a receive buffer, ``copy_in=False``,
    only allocated there), and the second callable copies a host result
    back to the card; each copy lands in ``mesh.stats``."""
    import torch.distributed as dist

    if t.device.type != "cuda" or dist.get_backend() != "gloo":
        return t, lambda r: r
    st = mesh.stats
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy_in:
        t0 = time.perf_counter()
        host.copy_(t)  # waits for the card's stream: the partial is final
        st["staging_ms"] += 1e3 * (time.perf_counter() - t0)
        st["staging_copies"] += 1
        st["staging_bytes"] += host.numel() * host.element_size()
    dev = t.device

    def back(r: torch.Tensor) -> torch.Tensor:
        t1 = time.perf_counter()
        out = r.to(dev, non_blocking=True)
        st["staging_ms"] += 1e3 * (time.perf_counter() - t1)
        st["staging_copies"] += 1
        st["staging_bytes"] += r.numel() * r.element_size()
        return out

    return host, back


def _count(mesh: Mesh, op: str, nbytes: int, t0: float) -> None:
    st = mesh.stats
    st["calls"][op] = st["calls"].get(op, 0) + 1
    st["wire_bytes"] += nbytes
    st["ms"] += 1e3 * (time.perf_counter() - t0)


def world_reduce(mesh: Mesh, t: torch.Tensor, op: str, ranks: tuple[int, ...]) -> torch.Tensor:
    """All-reduce ``t`` (already in wire form) over the process group of
    ``ranks``; ``op`` is ``min``, ``max`` or ``sum``."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    wire, back = _staged(mesh, t.contiguous())
    red = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
    dist.all_reduce(wire, op=red, group=mesh.group(ranks))
    _count(mesh, f"all_reduce_{op}", wire.numel() * wire.element_size(), t0)
    return back(wire)


def _world_gather(mesh: Mesh, t: torch.Tensor, ranks: tuple[int, ...]) -> list[torch.Tensor]:
    """All-gather ``t`` over the group of ``ranks``, in rank order."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    wire, back = _staged(mesh, t.contiguous())
    parts = [torch.empty_like(wire) for _ in ranks]
    dist.all_gather(parts, wire, group=mesh.group(ranks))
    _count(mesh, "all_gather", wire.numel() * wire.element_size() * len(ranks), t0)
    return [back(p) for p in parts]


_COMBINE = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def _reduce(mesh: Mesh, xs: Sequence[torch.Tensor], axes, op: str) -> list[torch.Tensor]:
    dtype = xs[0].dtype
    order = op != "sum"
    if dtype == torch.uint32 and op == "sum":
        raise TypeError("psum of uint32 is not defined here; sum in int32 or int64")
    enc = [_encode(x, order) for x in xs]
    groups = _local_groups(mesh, axes)
    partial = []
    for _ranks, mine in groups:
        acc = enc[mine[0]]
        for m in mine[1:]:
            acc = _COMBINE[op](acc, enc[m].to(acc.device))
            mesh.stats["local_combines"] += 1
        partial.append(acc)
    for ranks in sorted({r for r, _ in groups}):
        if len(ranks) < 2:
            continue
        idx = [i for i, (r, _) in enumerate(groups) if r == ranks]
        red = world_reduce(mesh, torch.stack([partial[i] for i in idx]), op, ranks)
        for j, i in enumerate(idx):
            partial[i] = red[j]
    out: list = [None] * len(xs)
    for (_ranks, mine), p in zip(groups, partial):
        p = _decode(p, dtype, order)
        for m in mine:
            out[m] = p.to(xs[m].device)
    return out


def pmin(mesh: Mesh, xs: Sequence[torch.Tensor], axes) -> list[torch.Tensor]:
    """Elementwise minimum over each axis group of ``axes``."""
    return _reduce(mesh, xs, axes, "min")


def pmax(mesh: Mesh, xs: Sequence[torch.Tensor], axes) -> list[torch.Tensor]:
    """Elementwise maximum over each axis group of ``axes``."""
    return _reduce(mesh, xs, axes, "max")


def psum(mesh: Mesh, xs: Sequence[torch.Tensor], axes) -> list[torch.Tensor]:
    """Elementwise sum over each axis group of ``axes`` (integer sums wrap
    as the reference's ``int32`` does)."""
    return _reduce(mesh, xs, axes, "sum")


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor], axes) -> list[torch.Tensor]:
    """Each axis group's members concatenated along dim 0, in axis order
    (``all_gather(tiled=True)``)."""
    dtype = xs[0].dtype
    enc = [_encode(x, False) for x in xs]
    groups = _local_groups(mesh, axes)
    pieces = []
    for _ranks, mine in groups:
        dev = enc[mine[0]].device
        pieces.append(torch.cat([enc[m].to(dev) for m in mine]) if len(mine) > 1
                      else enc[mine[0]])
        mesh.stats["local_combines"] += len(mine) - 1
    for ranks in sorted({r for r, _ in groups}):
        if len(ranks) < 2:
            continue
        idx = [i for i, (r, _) in enumerate(groups) if r == ranks]
        parts = _world_gather(mesh, torch.stack([pieces[i] for i in idx]), ranks)
        for j, i in enumerate(idx):
            pieces[i] = torch.cat([p[j] for p in parts])
    out: list = [None] * len(xs)
    for (_ranks, mine), p in zip(groups, pieces):
        p = _decode(p, dtype, False)
        for m in mine:
            out[m] = p.to(xs[m].device)
    return out


def axis_index(mesh: Mesh, axis: str) -> list[int]:
    """Each local shard's coordinate along ``axis``."""
    a = mesh.axis_names.index(_axes(mesh, axis)[0])
    return [mesh.coords(g)[a] for g in mesh.local]


def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor], axis: str,
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """Send each shard's tensor along ``axis`` by ``perm``'s ``(source,
    destination)`` coordinate pairs; a shard that no pair names as a
    destination gets zeros.  A pair within the rank is a device copy; a
    pair across ranks is a point-to-point send and receive, all of one
    call posted together."""
    import torch.distributed as dist

    a = mesh.axis_names.index(_axes(mesh, axis)[0])
    dst_of = dict(perm)
    src_of = {d: s for s, d in perm}
    pos = {g: i for i, g in enumerate(mesh.local)}
    dtype = xs[0].dtype
    enc = [_encode(x, False) for x in xs]
    out: list = [None] * len(xs)
    ops, backs = [], []

    def moved(g: int, coord: int) -> int:
        c = list(mesh.coords(g))
        c[a] = coord
        return mesh.index(c)

    t0 = time.perf_counter()
    nbytes = 0
    for g in range(mesh.size):  # one fixed order on every rank
        c = mesh.coords(g)[a]
        if c not in dst_of:
            continue
        h = moved(g, dst_of[c])
        src_local, dst_local = g in pos, h in pos
        if src_local and dst_local:
            out[pos[h]] = enc[pos[g]].to(xs[pos[h]].device)
        elif src_local:
            wire, _ = _staged(mesh, enc[pos[g]].contiguous())
            ops.append(dist.P2POp(dist.isend, wire, mesh.shards[h].rank, tag=h))
            nbytes += wire.numel() * wire.element_size()
        elif dst_local:
            tmpl = enc[pos[h]]
            buf = torch.empty(tmpl.shape, dtype=tmpl.dtype, device=tmpl.device)
            wire, back = _staged(mesh, buf, copy_in=False)
            ops.append(dist.P2POp(dist.irecv, wire, mesh.shards[g].rank, tag=h))
            backs.append((pos[h], wire, back))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for i, wire, back in backs:
            out[i] = back(wire)
        _count(mesh, "ppermute", nbytes, t0)
    for i, g in enumerate(mesh.local):
        if out[i] is None:
            if mesh.coords(g)[a] in src_of:
                raise RuntimeError(f"shard {g} received nothing")
            out[i] = torch.zeros_like(enc[i])
        out[i] = _decode(out[i], dtype, False)
    return out
