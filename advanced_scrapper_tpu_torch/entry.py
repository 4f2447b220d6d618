"""The port's entry point, the counterpart of the reference's
``__graft_entry__.py``.

:func:`entry` returns ``(fn, example_args)``: the flagship dedup step of
one batch (MinHash signatures → coarse + fine candidate keys → per-band
candidate representatives → verified union-find labels) and a batch of
256 rows of 1,024 bytes from ``RandomState(0)``, row 128 a copy of row 0.
On the card the signatures are one launch of the CUDA kernel
``minhash_sig`` (``csrc/minhash.cu``); the epilogue is plain PyTorch, as
the engine runs it.  ``device="cpu"`` runs every stage's plain version.

:func:`dryrun_multichip` runs the sharded step and the packed plane over
an ``n``-shard mesh of the visible cards on tiny shapes.
"""

from __future__ import annotations

import numpy as np


def _example_batch(batch: int, block: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``uint8[batch, block]`` printable bytes and ``int32[batch]`` lengths
    in ``[block/2, block)``, row ``batch // 2`` a copy of row 0."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(32, 127, size=(batch, block)).astype(np.uint8)
    lengths = rng.randint(block // 2, block, size=(batch,)).astype(np.int32)
    tok[batch // 2] = tok[0]
    lengths[batch // 2] = lengths[0]
    return tok, lengths


def entry(device=None):
    """``(fn, (tokens, lengths))``: ``fn(tokens, lengths)`` gives each
    row's representative, ``int32[256]``, the planted copy's its source's.
    ``device`` None means ``cuda`` (and raises without a card)."""
    import torch

    from advanced_scrapper_tpu_torch import resolve_device
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.ops.lsh import (
        candidate_keys,
        duplicate_rep_bands,
        resolve_rep_bands,
    )
    from advanced_scrapper_tpu_torch.ops.minhash import minhash_signatures

    dev = resolve_device(device)
    params = make_params()
    n_subbands = DedupConfig().cand_subbands  # in lockstep with the engine

    def dedup_step(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        sig = minhash_signatures(tokens, lengths, params)
        keys = candidate_keys(sig, params.band_salt, n_subbands)
        valid = lengths >= params.shingle_k
        rep_bands = duplicate_rep_bands(keys, valid)
        return resolve_rep_bands(rep_bands, sig, valid, 0.7, jump_rounds=8)

    tok, lengths = _example_batch(batch=256, block=1024)
    return dedup_step, (torch.from_numpy(tok).to(dev), torch.from_numpy(lengths).to(dev))


def _family_batch(batch: int, block: int, n_families: int = 16, seed: int = 0):
    """``uint8[batch, block]`` rows with planted dup families across data
    shards: family f's 4 members sit at rows ``f + q·batch/4`` (q = 0..3);
    even families are exact copies, odd ones near copies (a ~2% span
    redrawn).  Returns ``(tokens, lengths, families)``."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(32, 127, size=(batch, block)).astype(np.uint8)
    lengths = np.full((batch,), block, dtype=np.int32)
    families = []
    q = batch // 4
    for f in range(n_families):
        members = [f + j * q for j in range(4)]
        for m in members[1:]:
            tok[m] = tok[members[0]]
            if f % 2 == 1:
                span = max(1, block // 50)
                pos = int(rng.randint(0, block - span))
                tok[m, pos : pos + span] = rng.randint(32, 127, size=span, dtype=np.uint8)
        families.append(members)
    return tok, lengths, families


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The sharded step (``make_sharded_dedup``) and the packed plane
    (``NearDupEngine.dedup_reps_sharded``) over an ``n_devices``-shard
    mesh (``n_devices × 1``) on tiny shapes, each held equal to the same
    call on a one-shard mesh of the first device.  The mesh takes the
    visible cards in turn (``cuda:i mod cards``) when ``n_devices`` is
    larger than their number; ``device="cpu"`` builds it of CPU shards.
    Returns the shards, the distinct devices used, and the checks; a
    disagreement raises."""
    import torch

    from advanced_scrapper_tpu_torch import resolve_device
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.core.mesh import build_mesh
    from advanced_scrapper_tpu_torch.parallel.sharded import make_sharded_dedup
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    mesh = build_mesh(n_devices, 1, devices=devices)
    one = build_mesh(1, 1, devices=devices[:1])
    params = make_params()
    batch = 256
    tok, lengths, families = _family_batch(batch, 256)
    rep, hist = make_sharded_dedup(mesh, params)(tok, lengths)
    rep1, hist1 = make_sharded_dedup(one, params)(tok, lengths)
    rep, rep1 = rep.cpu().numpy(), rep1.cpu().numpy()
    if not (np.array_equal(rep, rep1) and torch.equal(hist.cpu(), hist1.cpu())):
        raise AssertionError("the sharded step differs from the one-shard step")
    for members in families:
        if any(rep[m] != members[0] for m in members):
            raise AssertionError(f"family {members} did not resolve to its first row")
    docs = [tok[i, : lengths[i]].tobytes() for i in range(batch)]
    engine = NearDupEngine(DedupConfig(rerank=False, exact_verify_band=0.0), device=devices[0])
    packed = engine.dedup_reps_sharded(docs, mesh)
    groups = engine.last_tiles
    packed1 = engine.dedup_reps_sharded(docs, one)
    if not np.array_equal(packed, packed1):
        raise AssertionError("the packed plane differs from the one-shard plane")
    return {
        "shards": n_devices,
        "distinct_devices": len(set(devices)),
        "devices": sorted({str(d) for d in devices}),
        "families": len(families),
        "dups": int((rep != np.arange(batch)).sum()),
        "tile_groups": groups,
        "hist_sum": int(hist.sum()),
    }
