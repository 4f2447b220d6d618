"""One rank of a ``torch.distributed`` gloo world on the CPU, for
``tests/test_torch_multihost.py``.

Usage: ``python torch_multihost_worker.py <rank> <port> <ranks>``.  The
rank brings ``8 / ranks`` CPU shards to 8-shard meshes and runs the
port's mesh paths on inputs made from fixed seeds (every rank makes the
same global inputs, and each keeps or packs only its own shards' part):
``multihost_dedup`` over its local rows of the reference worker's batch,
the batch, block and ring steps and the sequence-parallel signatures on
4×2, 8×1 and 2×4 meshes, and the packed and blockwise planes of
``NearDupEngine.dedup_reps_sharded``.  It prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from advanced_scrapper_tpu_torch.config import DedupConfig  # noqa: E402
from advanced_scrapper_tpu_torch.core.hashing import make_params  # noqa: E402
from advanced_scrapper_tpu_torch.core.mesh import build_mesh, host_numpy  # noqa: E402
from advanced_scrapper_tpu_torch.parallel.dist import (  # noqa: E402
    global_mesh,
    initialize_multihost,
    multihost_dedup,
    world_info,
)
from advanced_scrapper_tpu_torch.parallel.ring import make_ring_dedup  # noqa: E402
from advanced_scrapper_tpu_torch.parallel.sharded import (  # noqa: E402
    make_sharded_block_dedup,
    make_sharded_dedup,
    seq_sharded_signatures,
)
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine  # noqa: E402

import mesh_inputs  # noqa: E402  (beside this file)


def main() -> None:
    rank, port, n = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    if not initialize_multihost(f"localhost:{port}", n, rank, backend="gloo"):
        raise RuntimeError("the world was not initialised")
    cpus = ["cpu"] * (8 // n)
    params = make_params()
    out = {"rank": rank}
    mesh = global_mesh(devices=cpus)
    out["world"] = world_info(mesh)
    # the reference worker's batch: a row on the last rank copies rank 0's row 3
    corpus, dup_row = mesh_inputs.multihost_batch(n)
    b_local = corpus.shape[0] // n
    lengths = np.full((b_local,), corpus.shape[1], np.int32)
    rep, hist = multihost_dedup(corpus[rank * b_local : (rank + 1) * b_local], lengths, params,
                                mesh=mesh)
    out.update(dup_row=dup_row, rep=rep.tolist(), hist_sum=int(hist.sum()))

    tok, lens = mesh_inputs.batch()
    btok, blens, bown, n_art = mesh_inputs.blocks()
    rtok, rlens = mesh_inputs.ring_batch()
    docs = mesh_inputs.corpus()
    for shape in ((4, 2), (8, 1), (2, 4)):
        m = build_mesh(*shape, devices=cpus)
        name = f"{shape[0]}x{shape[1]}"
        r, h = make_sharded_dedup(m, params)(tok, lens)
        out[f"dedup_{name}"] = [r.tolist(), h.tolist()]
        r, h = make_sharded_block_dedup(m, params, n_art, jump_rounds=5)(btok, blens, bown)
        out[f"block_{name}"] = [r.tolist(), h.tolist()]
        out[f"ring_{name}"] = make_ring_dedup(m, params, jump_rounds=8)(rtok, rlens).tolist()
        sig = seq_sharded_signatures(tok, lens, params, m)
        out[f"seq_{name}"] = [[g, host_numpy(p).tolist()] for g, p in zip(m.local, sig.pieces)]
        eng = NearDupEngine(DedupConfig(rerank=False, exact_verify_band=0.0), device="cpu")
        out[f"packed_{name}"] = eng.dedup_reps_sharded(docs, m).tolist()
        legacy = NearDupEngine(DedupConfig(rerank=False, exact_verify_band=0.0,
                                           packed_h2d=False), device="cpu")
        out[f"blockwise_{name}"] = legacy.dedup_reps_sharded(docs, m).tolist()
        out[f"stats_{name}"] = m.stats
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
