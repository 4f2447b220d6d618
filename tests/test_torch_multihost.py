"""The port's mesh across processes: 2- and 4-rank ``torch.distributed``
gloo worlds on one host (``torch_multihost_worker.py``), 8 CPU shards in
all, against the JAX package's single-process 8-device results.

As in the reference's ``tests/test_multihost.py``, a duplicate whose two
members sit on different ranks must resolve through the cross-rank
``all_gather`` and ``psum``; beyond it every mesh path runs across the
ranks (the batch, block and ring steps, the sequence-parallel signatures
with their cross-rank halo and the sub-group ``pmin`` of a 2×4 mesh, the
packed and blockwise planes), and each rank's outputs equal the
reference's and every other rank's."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import mesh_inputs
from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.core import build_mesh as ref_build_mesh
from advanced_scrapper_tpu.core import make_params as ref_make_params
from advanced_scrapper_tpu.parallel.ring import make_ring_dedup as ref_ring
from advanced_scrapper_tpu.parallel.sharded import make_sharded_block_dedup as ref_block
from advanced_scrapper_tpu.parallel.sharded import make_sharded_dedup as ref_dedup
from advanced_scrapper_tpu.parallel.sharded import seq_sharded_signatures as ref_seq
from advanced_scrapper_tpu.parallel.sharded import shard_batch as ref_shard_batch
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")
SHAPES = ((4, 2), (8, 1), (2, 4))



@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this module's torch work: the suite runs
    several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(n: int) -> list[dict]:
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(port), str(n)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def reference(devices8):
    """The JAX package's single-process results on its 8-device mesh."""
    params = ref_make_params()
    out = {}
    tok, lens = mesh_inputs.batch()
    btok, blens, bown, n_art = mesh_inputs.blocks()
    rtok, rlens = mesh_inputs.ring_batch()
    docs = mesh_inputs.corpus()
    cfg = RefConfig(rerank=False, exact_verify_band=0.0)
    for shape in SHAPES:
        mesh = ref_build_mesh(*shape)
        name = f"{shape[0]}x{shape[1]}"
        rep, hist = ref_dedup(mesh, params)(*ref_shard_batch(tok, lens, mesh))
        out[f"dedup_{name}"] = [np.asarray(rep).tolist(), np.asarray(hist).tolist()]
        rep, hist = ref_block(mesh, params, n_art, jump_rounds=5)(btok, blens, bown)
        out[f"block_{name}"] = [np.asarray(rep).tolist(), np.asarray(hist).tolist()]
        out[f"ring_{name}"] = np.asarray(ref_ring(mesh, params, jump_rounds=8)(
            *ref_shard_batch(rtok, rlens, mesh))).tolist()
        out[f"seq_{name}"] = np.asarray(ref_seq(tok, lens, params, mesh))
    # the planes on every mesh equal the one-device estimator-only reps
    # (the reference's tests/test_sharded_packed.py holds that)
    out["packed"] = np.asarray(RefEngine(cfg).dedup_reps_async(docs))[: len(docs)].tolist()
    return out


@pytest.mark.parametrize("n_procs", [2, 4])
def test_gloo_world_equals_the_reference(reference, n_procs):
    outs = run_world(n_procs)
    by_rank = {o["rank"]: o for o in outs}
    assert set(by_rank) == set(range(n_procs))
    corpus, dup_row = mesh_inputs.multihost_batch(n_procs)
    mesh = ref_build_mesh(8, 1)
    rep, hist = ref_dedup(mesh, ref_make_params())(*ref_shard_batch(
        corpus, np.full((corpus.shape[0],), corpus.shape[1], np.int32), mesh))
    want_rep, want_hist = np.asarray(rep).tolist(), int(np.asarray(hist).sum())
    for o in outs:
        assert o["world"] == {"process_index": o["rank"], "process_count": n_procs,
                              "local_devices": 8 // n_procs, "global_devices": 8}
        # the cross-rank duplicate: the last rank's row is rank 0's row 3
        assert o["dup_row"] == dup_row and o["rep"][dup_row] == 3
        assert o["rep"] == want_rep and o["hist_sum"] == want_hist == 16 * len(want_rep)
        for shape in SHAPES:
            name = f"{shape[0]}x{shape[1]}"
            for what in ("dedup", "block", "ring"):
                assert o[f"{what}_{name}"] == reference[f"{what}_{name}"], (what, name)
            assert o[f"packed_{name}"] == o[f"blockwise_{name}"] == reference["packed"], name
            stats = o[f"stats_{name}"]
            assert stats["wire_bytes"] > 0 and stats["staging_copies"] == 0, (name, stats)
            assert stats["calls"].get("ppermute", 0) > 0, (name, stats)
    for shape in SHAPES:
        name = f"{shape[0]}x{shape[1]}"
        want = reference[f"seq_{name}"]
        rows = want.shape[0] // shape[0]
        seen = set()
        for o in outs:
            for g, piece in o[f"seq_{name}"]:
                i = g // shape[1]
                assert np.array_equal(np.asarray(piece, np.uint32), want[i * rows:(i + 1) * rows])
                seen.add(g)
        assert seen == set(range(8))


def test_one_process_world_and_its_guards(monkeypatch):
    """Without a coordinator there is no world to join; an unknown backend
    raises before any connection; in one process ``multihost_dedup`` is
    the batch step over the local rows, its step cache bounded."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.core.mesh import build_mesh
    from advanced_scrapper_tpu_torch.parallel import dist

    monkeypatch.delenv("ASTPU_COORDINATOR", raising=False)
    assert dist.initialize_multihost() is False
    with pytest.raises(ValueError, match="unknown backend"):
        dist.initialize_multihost("localhost:1", 1, 0, backend="mpi")
    mesh = build_mesh(8, 1, devices=["cpu"] * 8)
    assert dist.world_info(mesh) == {"process_index": 0, "process_count": 1,
                                     "local_devices": 8, "global_devices": 8}
    corpus, dup_row = mesh_inputs.multihost_batch(1)
    lengths = np.full((corpus.shape[0],), corpus.shape[1], np.int32)
    params = make_params()
    monkeypatch.setattr(dist, "_DEDUP_STEP_CACHE", {})
    monkeypatch.setattr(dist, "_DEDUP_STEP_CACHE_MAX", 2)
    rep, hist = dist.multihost_dedup(corpus, lengths, params, mesh=mesh)
    assert rep[dup_row] == 3 and int(hist.sum()) == 16 * corpus.shape[0]
    for threshold in (0.5, 0.6, 0.8):
        again, _ = dist.multihost_dedup(corpus, lengths, params, mesh=mesh, threshold=threshold)
        assert np.array_equal(again, rep)
    assert len(dist._DEDUP_STEP_CACHE) == 2
    tok, ln = dist.distribute_global_batch(corpus, lengths, build_mesh(4, 2, devices=["cpu"] * 8))
    assert np.array_equal(tok.numpy(), corpus) and np.array_equal(ln.numpy(), lengths)
