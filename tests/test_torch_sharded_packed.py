"""The port's packed plane over a mesh (``NearDupEngine.dedup_reps_sharded``,
``parallel/sharded_packed.py``) on CPU meshes, against the JAX package's
on its 8-device virtual mesh and against the port's one-device engine:
the representatives on 4×2, 8×1 and 1×1 meshes (MinHash, OPH, a fine
margin, the blockwise plane with ``packed_h2d=False``), each shard's
ledger (tiles + 1 copies and tiles + 1 dispatches), the per-shard fold,
``prewarm_sharded`` and ``dedup_against_index(mesh=...)`` on a local index
and through the port's fleet."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.core.mesh import build_mesh as ref_build_mesh
from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.core.mesh import ShardedArray, build_mesh
from advanced_scrapper_tpu_torch.obs import stages
from advanced_scrapper_tpu_torch.ops.minhash import (
    accumulate_block_signatures,
    minhash_signatures,
)
from advanced_scrapper_tpu_torch.ops.pack import pack_tile
from advanced_scrapper_tpu_torch.ops.shingle import U32_MAX, to_u32
from advanced_scrapper_tpu_torch.parallel import collectives as C
from advanced_scrapper_tpu_torch.parallel.sharded_packed import (
    assemble_packed_tiles,
    local_shard_rows,
    make_sharded_accumulator_init,
    make_sharded_fused_tile_step,
    make_sharded_resolve_epilogue,
    mesh_num_shards,
    shard_row_devices,
)
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

BASE = dict(rerank=False, exact_verify_band=0.0)
SHAPES = [(4, 2), (8, 1), (1, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this module's torch work: the suite runs
    several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def balanced_reference_ledger():
    """The JAX reference runs here on 1×1 meshes, which raise shard 0's
    process-wide put counters alone; reset its registry after the module
    (the reset hooks drop the cached shard counters) so a later test in the
    same process reads the shard ledger as balanced as this module found
    it."""
    yield
    ref_telemetry.REGISTRY.reset()


def _corpus(rng: np.random.RandomState, n: int) -> list[bytes]:
    """The reference tests' ragged mix: empties, sub-shingle documents,
    bucket-edge lengths, blockwise documents (past the 4,096-byte block)
    and planted copies; the rest up to 2,000 bytes."""
    docs: list[bytes] = []
    specials = [0, 1, 4, 63, 64, 65, 128, 4096, 4097, 9001]
    for i in range(n):
        if i < len(specials):
            ln = specials[i]
        elif i >= 8 and rng.rand() < 0.25:
            docs.append(docs[rng.randint(0, i)])
            continue
        else:
            ln = int(rng.randint(5, 2000))
        docs.append(rng.randint(32, 127, size=ln, dtype=np.uint8).tobytes())
    return docs


def cpu_mesh(shape):
    return build_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.fixture(scope="module")
def docs():
    return _corpus(np.random.RandomState(3), 64)


@pytest.fixture(scope="module")
def reference(devices8, docs):
    """The JAX package's packed plane on its 4×2 mesh and its one-device
    estimator-only representatives (which its own tests hold equal to the
    packed plane on every mesh)."""
    ref = RefEngine(RefConfig(**BASE))
    return (np.asarray(ref.dedup_reps_sharded(docs, ref_build_mesh(4, 2))),
            np.asarray(ref.dedup_reps_async(docs))[: len(docs)])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_packed_plane_matches_the_reference_and_both_oracles(reference, docs, shape):
    """The packed plane equals the JAX package's (its plane on 4×2, its
    one-device reps everywhere) and the port's one-device
    ``dedup_reps_async``; on 4×2 the blockwise plane too (the reference's
    test runs it on one mesh)."""
    ref_sharded, ref_async = reference
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    want = eng.dedup_reps_async(docs)[: len(docs)].numpy()
    got = eng.dedup_reps_sharded(docs, cpu_mesh(shape))
    assert got.dtype == np.int32 and np.array_equal(got, ref_async)
    assert np.array_equal(got, want) and np.array_equal(ref_sharded, ref_async)
    assert (got != np.arange(len(docs))).sum() > 5
    if shape == (4, 2):
        legacy = NearDupEngine(DedupConfig(**BASE, packed_h2d=False), device="cpu")
        assert np.array_equal(legacy.dedup_reps_sharded(docs, cpu_mesh(shape)), want)


@pytest.mark.parametrize("overrides", [dict(fine_margin=0.05), dict(backend="oph"),
                                       dict(backend="oph", packed_h2d=False)],
                         ids=["fine-margin", "oph", "oph-blockwise"])
def test_knobs_match_the_reference(devices8, overrides):
    """A fine margin and the OPH backend (raw folds, densified after the
    combine) resolve as the JAX package's sharded engine (on a 1×1 mesh)
    and the port's one-device engine do."""
    docs = _corpus(np.random.RandomState(7), 48)
    ref = RefEngine(RefConfig(**BASE, **overrides)).dedup_reps_sharded(
        docs, ref_build_mesh(1, 1, devices=devices8[:1]))
    eng = NearDupEngine(DedupConfig(**BASE, **overrides), device="cpu")
    got = eng.dedup_reps_sharded(docs, cpu_mesh((4, 2)))
    assert np.array_equal(got, np.asarray(ref))
    one = NearDupEngine(DedupConfig(**BASE, backend=overrides.get("backend", "scan"),
                                    fine_margin=overrides.get("fine_margin", 0.0)), device="cpu")
    assert np.array_equal(got, one.dedup_reps_async(docs)[: len(docs)].numpy())


def test_default_config_matches_the_reference(devices8):
    """The default configuration on the mesh (its estimator-only
    resolution, the rerank tier is not on this path) as the reference's."""
    docs = _corpus(np.random.RandomState(5), 32)
    ref = RefEngine(RefConfig()).dedup_reps_sharded(docs, ref_build_mesh(1, 1,
                                                                         devices=devices8[:1]))
    got = NearDupEngine(DedupConfig(), device="cpu").dedup_reps_sharded(docs, cpu_mesh((8, 1)))
    assert np.array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("knobs", [(3, 1), (4, 6)])
def test_window_and_worker_knobs_do_not_show(knobs):
    docs = _corpus(np.random.RandomState(13), 40)
    mesh = cpu_mesh((8, 1))
    want = NearDupEngine(DedupConfig(**BASE), device="cpu").dedup_reps_sharded(docs, mesh)
    pw, win = knobs
    cfg = DedupConfig(**BASE, put_workers=pw, dispatch_window=win)
    assert np.array_equal(NearDupEngine(cfg, device="cpu").dedup_reps_sharded(docs, mesh), want)


def test_empty_corpus_and_the_blockwise_route():
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    mesh = cpu_mesh((8, 1))
    out = eng.dedup_reps_sharded([], mesh)
    assert out.shape == (0,) and out.dtype == np.int32
    legacy = NearDupEngine(DedupConfig(**BASE, packed_h2d=False), device="cpu")
    before = stages.sharded_device_counters()
    docs = _corpus(np.random.RandomState(5), 48)
    got = legacy.dedup_reps_sharded(docs, mesh)
    assert stages.sharded_device_counters() == before  # no shard-labelled traffic
    assert np.array_equal(got, eng.dedup_reps_async(docs)[: len(docs)].numpy())
    assert legacy.dedup_reps_sharded([], mesh).shape == (0,)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_shard_ledger_is_tiles_plus_one(docs, shape):
    """Each shard's counter delta is tiles + 1 copies (its tiles and the
    valid mask) and tiles + 1 dispatches (its folds and the epilogue),
    equal bytes on every shard, and the put skew reads 0."""
    mesh = cpu_mesh(shape)
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    before = stages.sharded_device_counters()
    rep = eng.dedup_reps_sharded(docs, mesh)
    after = stages.sharded_device_counters()
    tiles = eng.last_tiles
    assert tiles > 1 and rep.shape == (len(docs),)
    deltas = {s: {k: after[s][k] - before.get(s, {}).get(k, 0.0) for k in after[s]}
              for s in after}
    assert sorted(deltas, key=int) == [str(s) for s in range(mesh_num_shards(mesh))]
    for s, d in deltas.items():
        assert d["device_puts"] == tiles + 1 and d["device_dispatches"] == tiles + 1, (s, d)
    assert len({d["h2d_bytes"] for d in deltas.values()}) == 1
    assert stages.record_sharded_put_skew(before) == 0.0


def test_sharded_step_folds_each_shard_in_place():
    """Each shard's accumulator row after one step is the one-device fold
    of its own tile; the step updates the accumulator in place; the
    epilogue's combine is the elementwise minimum of the rows."""
    mesh = cpu_mesh((4, 2))
    params = make_params()
    step = make_sharded_fused_tile_step(mesh, params, "scan")
    init = make_sharded_accumulator_init(mesh, params.num_perm)
    nsh = mesh_num_shards(mesh)
    assert local_shard_rows(mesh) == list(range(nsh))
    assert [s.device.type for s in shard_row_devices(mesh)] == ["cpu"] * nsh
    rng = np.random.RandomState(0)
    rows, width, n_bucket = 64, 128, 64
    tiles, pieces = [], []
    for _ in range(nsh):
        tok = rng.randint(32, 127, size=(rows, width)).astype(np.uint8)
        lens = rng.randint(0, width + 1, size=(rows,)).astype(np.int32)
        owners = (np.arange(rows) % n_bucket).astype(np.int32)
        tiles.append((tok, lens, owners))
        pieces.append(torch.from_numpy(pack_tile(tok, lens, owners)))
    packed = assemble_packed_tiles(mesh, pieces, pieces[0].numel())
    running = init(num_articles=n_bucket)
    first = running.pieces[0]
    out = step(running, packed, rows=rows, width=width, num_articles=n_bucket)
    assert out is running and out.pieces[0] is first
    rows_min = None
    for s, (tok, lens, owners) in enumerate(tiles):
        want = accumulate_block_signatures(
            to_u32(torch.full((n_bucket, params.num_perm), U32_MAX, dtype=torch.int64)),
            minhash_signatures(torch.from_numpy(tok), torch.from_numpy(lens), params),
            torch.from_numpy(owners))
        assert torch.equal(out.pieces[s][0].view(torch.int32), want.view(torch.int32)), s
        w = want.view(torch.int32).numpy().view(np.uint32)
        rows_min = w if rows_min is None else np.minimum(rows_min, w)
    epi = make_sharded_resolve_epilogue(mesh, params, threshold=0.7, fine_margin=0.0,
                                        fine_salt=np.zeros((0,), np.uint32), backend="scan")
    valid = ShardedArray(mesh, (None,), [torch.ones(n_bucket, dtype=torch.bool)] * nsh,
                         (n_bucket,))
    rep = epi(out, valid, jump_rounds=6)
    assert rep.shape == (n_bucket,) and rep.dtype == torch.int32
    with pytest.raises(ValueError, match="articles"):
        step(running, packed, rows=rows, width=width, num_articles=2 * n_bucket)
    with pytest.raises(ValueError, match="expected uint8"):
        assemble_packed_tiles(mesh, pieces, pieces[0].numel() + 1)
    combined = C.pmin(mesh, [r[0] for r in out.pieces], mesh.axis_names)[0]
    assert np.array_equal(combined.view(torch.int32).numpy().view(np.uint32), rows_min)


@pytest.mark.parametrize("backend", ["scan", "oph"])
def test_prewarm_sharded_makes_the_steps_a_corpus_uses(backend):
    """``prewarm_sharded`` launches one fold a shard and the epilogue
    (with OPH's densify) and makes every step a corpus then takes: the
    corpus adds no cache entry."""
    cfg = DedupConfig(**BASE, block_len=256, batch_size=64, backend=backend)
    eng = NearDupEngine(cfg, device="cpu")
    mesh = cpu_mesh((8, 1))
    assert eng.prewarm_sharded(mesh, n_articles=40) == 8 + (backend == "oph")
    n_entries = len(eng._sharded_steps)
    docs = _corpus(np.random.RandomState(17), 40)
    rep = eng.dedup_reps_sharded(docs, mesh)
    assert rep.shape == (40,) and len(eng._sharded_steps) == n_entries
    assert (mesh, "keys") in eng._sharded_steps  # dedup_against_index's epilogue


def test_step_cache_is_reused_across_corpora():
    docs = _corpus(np.random.RandomState(29), 40)
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    mesh = cpu_mesh((8, 1))
    first = eng.dedup_reps_sharded(docs, mesh)
    n_entries = len(eng._sharded_steps)
    eng.dedup_reps_sharded(docs[::-1], cpu_mesh((8, 1)))  # an equal mesh
    assert len(eng._sharded_steps) == n_entries
    assert np.array_equal(eng.dedup_reps_sharded(docs, mesh), first)


def test_dedup_against_index_on_a_mesh_matches_one_device_and_the_reference(tmp_path, devices8):
    """``dedup_against_index(mesh=...)`` takes its wide keys off the mesh:
    the attributions over a two-batch stream equal the one-device call's
    and the JAX package's on its mesh."""
    from advanced_scrapper_tpu.index import PersistentIndex as RefIndex
    from advanced_scrapper_tpu_torch.index import PersistentIndex

    rng = np.random.RandomState(19)
    half_a = _corpus(rng, 32)
    half_b = _corpus(rng, 32) + half_a[:8]  # cross-batch dups
    ids_a = np.arange(0, len(half_a), dtype=np.uint64)
    ids_b = np.arange(1000, 1000 + len(half_b), dtype=np.uint64)

    def run(d, make_index, eng, mesh):
        idx = make_index(str(tmp_path / d))
        try:
            return (eng.dedup_against_index(half_a, idx, ids_a, mesh=mesh).tolist(),
                    eng.dedup_against_index(half_b, idx, ids_b, mesh=mesh).tolist())
        finally:
            idx.close()

    eng = NearDupEngine(DedupConfig(), device="cpu")
    sharded = run("sharded", PersistentIndex, eng, cpu_mesh((4, 2)))
    assert sharded == run("single", PersistentIndex, eng, None)
    ref = run("ref", RefIndex, RefEngine(RefConfig()), ref_build_mesh(1, 1, devices=devices8[:1]))
    assert sharded == ref
    assert sum(x >= 0 for x in sharded[1]) >= 8
    legacy = NearDupEngine(DedupConfig(packed_h2d=False), device="cpu")
    assert run("legacy", PersistentIndex, legacy, cpu_mesh((4, 2))) == sharded


def test_dedup_against_index_on_a_mesh_through_the_fleet(tmp_path):
    """The mesh's keys fanned out per index shard through a 2-shard
    loopback fleet of the port's servers: attributions equal a local
    index's with one-device keys."""
    from advanced_scrapper_tpu_torch.index import PersistentIndex
    from advanced_scrapper_tpu_torch.index.fleet import ShardedIndexClient
    from advanced_scrapper_tpu_torch.index.remote import IndexShardServer

    rng = np.random.RandomState(23)
    half_a = _corpus(rng, 24)
    half_b = _corpus(rng, 24) + half_a[:6]
    ids_a = np.arange(0, len(half_a), dtype=np.uint64)
    ids_b = np.arange(500, 500 + len(half_b), dtype=np.uint64)
    eng = NearDupEngine(DedupConfig(), device="cpu")
    oracle = PersistentIndex(str(tmp_path / "oracle"))
    try:
        want_a = eng.dedup_against_index(half_a, oracle, ids_a)
        want_b = eng.dedup_against_index(half_b, oracle, ids_b)
    finally:
        oracle.close()
    servers = [IndexShardServer(str(tmp_path / f"s{s}"), spaces=("bands",), name=f"s{s}").start()
               for s in range(2)]
    client = None
    try:
        client = ShardedIndexClient(";".join(f"127.0.0.1:{srv.port}" for srv in servers),
                                    space="bands", spill_dir=str(tmp_path / "spill"),
                                    timeout=30.0)
        mesh = cpu_mesh((8, 1))
        got_a = eng.dedup_against_index(half_a, client, ids_a, mesh=mesh)
        got_b = eng.dedup_against_index(half_b, client, ids_b, mesh=mesh)
    finally:
        if client is not None:
            client.close()
        for srv in servers:
            srv.stop()
    assert got_a.tolist() == want_a.tolist() and got_b.tolist() == want_b.tolist()
