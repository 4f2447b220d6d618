"""The packed tile plane over a mesh: one accumulator a shard, one
packed copy and one fold launch a shard a tile group, one combine a
corpus.

Counterpart of the reference's ``parallel/sharded_packed.py``.  The
running accumulator is a global ``uint32[n_shards, num_articles, P]``
array, one row a shard: each shard's ``uint32[num_articles, P]`` on its
device.  A tile group is a global ``uint8[n_shards, rows*(width+8)]``
packed buffer (``ops.pack``), one tile a shard, each copied to its
shard's device by the rank that owns it.  The tile step folds each
shard's own tile into its own accumulator in place with the port's tile
fold (``minhash_fold``, or ``oph_fold`` under ``backend="oph"``; the
plain versions on the CPU), and no collective runs per tile.

At the end of the corpus the epilogues ``pmin`` the shards' partials
over every axis (MinHash's min-algebra makes the blockwise and sharded
combine exact), densify once under OPH (``oph_densify``), and run the
one-device resolution (``ops.lsh.fused_resolve_epilogue``) or the wide
keys (``band_keys_wide``) on the combined signatures, once a rank.

Layering: this module is device math only (``core`` and ``ops``); the
host pipeline around it (the chunker, the dispatcher, the device ledger)
is ``pipeline/dedup.py``, and ``parallel`` never imports ``pipeline``,
``net``, ``index`` or ``runtime``.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_scrapper_tpu_torch.core.hashing import MinHashParams
from advanced_scrapper_tpu_torch.core.mesh import Mesh, Shard, ShardedArray
from advanced_scrapper_tpu_torch.ops.lsh import band_keys_wide, fused_resolve_epilogue
from advanced_scrapper_tpu_torch.ops.minhash import make_fused_tile_step
from advanced_scrapper_tpu_torch.ops.oph import densify
from advanced_scrapper_tpu_torch.parallel import collectives as C

__all__ = [
    "assemble_packed_tiles",
    "local_shard_rows",
    "make_sharded_accumulator_init",
    "make_sharded_fused_tile_step",
    "make_sharded_keys_epilogue",
    "make_sharded_resolve_epilogue",
    "mesh_num_shards",
    "shard_row_devices",
]


def _shard_axes(mesh: Mesh) -> tuple:
    """Every mesh axis: a shard is a device slot (data × seq both count),
    so an 8-shard mesh runs 8 accumulators whatever its factorisation."""
    return tuple(mesh.axis_names)


def mesh_num_shards(mesh: Mesh) -> int:
    """Shards of the mesh = accumulators."""
    return mesh.size


def shard_row_devices(mesh: Mesh) -> list[Shard]:
    """The shard owning each row of a row-sharded global array, in row
    order: its rank and its device (another rank's device reads as the
    device type alone)."""
    return list(mesh.shards)


def local_shard_rows(mesh: Mesh) -> list[int]:
    """The rows this rank owns (packs and copies tiles for): all of them
    in a world of one process."""
    return list(mesh.local)


def assemble_packed_tiles(mesh: Mesh, shards: list[torch.Tensor], nbytes: int) -> ShardedArray:
    """Bind the local shards' packed ``uint8[nbytes]`` (or ``[1, nbytes]``)
    buffers, already on their shards' devices, into one global
    ``uint8[n_shards, nbytes]`` array.  No copy."""
    pieces = []
    for t, g in zip(shards, mesh.local):
        if t.dtype != torch.uint8 or t.numel() != nbytes:
            raise ValueError(f"shard {g}'s tile is {t.dtype}[{t.numel()}], expected uint8[{nbytes}]")
        if t.device != mesh.shards[g].device:
            raise ValueError(f"shard {g}'s tile is on {t.device}, not {mesh.shards[g].device}")
        pieces.append(t.reshape(1, nbytes))
    return ShardedArray(mesh, (_shard_axes(mesh), None), pieces, (mesh.size, nbytes))


def make_sharded_accumulator_init(mesh: Mesh, num_perm: int):
    """``init(num_articles=...)`` → the all-``U32_MAX`` (min identity)
    accumulator ``uint32[n_shards, num_articles, num_perm]``, filled on
    each shard's device (no copy from the host)."""
    axes = _shard_axes(mesh)

    def init(*, num_articles: int) -> ShardedArray:
        pieces = [
            torch.full((1, num_articles, num_perm), -1, dtype=torch.int32,
                       device=mesh.shards[g].device).view(torch.uint32)
            for g in mesh.local
        ]
        return ShardedArray(mesh, (axes, None, None), pieces, (mesh.size, num_articles, num_perm))

    return init


def make_sharded_fused_tile_step(mesh: Mesh, params: MinHashParams, backend: str):
    """The tile step over the mesh: ``step(running, packed, *, rows,
    width, num_articles) -> running``, folding each local shard's tile
    into its own accumulator row in place, one launch a shard
    (``ops.minhash.make_fused_tile_step`` for its device).  ``backend ==
    "oph"`` folds the raw OPH form; the epilogues densify after the
    combine."""
    steps = {d: make_fused_tile_step(params, backend, d)
             for d in {mesh.shards[g].device for g in mesh.local}}

    def sharded_tile_step(running: ShardedArray, packed: ShardedArray, *, rows: int,
                          width: int, num_articles: int) -> ShardedArray:
        if running.shape[1] != num_articles:
            raise ValueError(f"accumulator holds {running.shape[1]} articles, not {num_articles}")
        for run, tile in zip(running.pieces, packed.pieces):
            steps[run.device](run[0], tile[0], rows=rows, width=width)
        return running

    return sharded_tile_step


def _combined(mesh: Mesh, running: ShardedArray, use_oph: bool) -> torch.Tensor:
    """The shards' partials ``pmin``-combined over every axis (densified
    under OPH), on the rank's first local shard's device."""
    sig = C.pmin(mesh, [r[0] for r in running.pieces], _shard_axes(mesh))[0]
    return densify(sig) if use_oph else sig


def make_sharded_resolve_epilogue(
    mesh: Mesh,
    params: MinHashParams,
    *,
    threshold: float,
    fine_margin: float,
    fine_salt: np.ndarray,
    backend: str,
):
    """``epilogue(running, valid, *, jump_rounds) -> int32[N]``: the
    end-of-corpus combine of the packed plane, then the one-device
    estimator-only resolution (coarse + fine candidate keys, per-band
    candidates, the fine-only bars when ``fine_margin`` is set, verified
    component labels), so the result is bit-equal to the one-device
    path's.  ``valid`` is the replicated ``bool[N]`` eligibility mask."""
    use_oph = backend == "oph"
    use_fine_margin = bool(fine_salt.shape[0] and fine_margin)

    def sharded_resolve(running: ShardedArray, valid: ShardedArray, *,
                        jump_rounds: int) -> torch.Tensor:
        sig = _combined(mesh, running, use_oph)
        return fused_resolve_epilogue(
            sig, valid.pieces[0].to(sig.device), params.band_salt, fine_salt, threshold,
            fine_margin, num_coarse=params.num_bands, jump_rounds=jump_rounds,
            use_fine_margin=use_fine_margin,
        )

    return sharded_resolve


def make_sharded_keys_epilogue(mesh: Mesh, params: MinHashParams, backend: str):
    """``keys_epilogue(running) -> int64[N, nb, 2]``: the wide two-lane
    band keys (``ops.lsh.band_keys_wide``) off the combined accumulator.
    They feed the persistent index, whose own shards take them on the
    host (``index.fleet``): a mesh's shard count and an index fleet's
    never have to agree."""
    use_oph = backend == "oph"

    def sharded_keys(running: ShardedArray) -> torch.Tensor:
        return band_keys_wide(_combined(mesh, running, use_oph), params.band_salt)

    return sharded_keys
