"""Recall and precision of the port's default engine against the oracle.

    python3 quality_probe.py [--device cuda|cpu] [--workers N]

Runs the 5-seed distribution of the reference's recall suite on the
port's default engine, ``NearDupEngine(DedupConfig(), device=...)
.dedup_reps`` (the rerank tier, exact verify at 0.72): seeds 101, 211,
307, 401 and 503 of both certification mixes
(``cpu/oracle.py:build_certification_corpus``, 160 bases, 8 long
documents: 640 ragged documents a corpus), the knee-heavy mix
(``knee_frac=0.4``) and the representative one (``knee_frac=0.2``).  Each
corpus is scored against the datasketch-algorithm oracle
(``oracle_near_dup_pairs``), its pair sets computed in ``--workers``
processes while the engine runs.  The bars:

- every seed: at least 250 oracle pairs, recall at least 0.92, no
  unchained merge; on the knee-heavy mix, precision at least the oracle's
  own comparator (``oracle_reps``) less 0.02;
- pooled recall at least 0.95 on both mixes; pooled precision at least
  0.90 on the knee-heavy mix and at least 0.95 on the representative one.

Prints one JSON line a corpus, one a mix, the card's name and power limit
(nvidia-smi), and last ``{"ok": ...}``; exits non-zero when a bar fails.
Imports nothing of JAX or of the JAX package.  ``chip_smoke.py``'s
``quality_path`` phase uses :func:`certification_corpus`,
:func:`oracle_truth` and :func:`score` on seed 101 of both mixes.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

SEEDS = (101, 211, 307, 401, 503)
#: the two certification mixes: name -> knee_frac
MIXES = {"knee_heavy": 0.4, "representative": 0.2}
BASES = 160
N_LONG = 8
THRESHOLD = 0.7
SEED_RECALL_MIN = 0.92
POOLED_RECALL_MIN = 0.95
POOLED_PRECISION_MIN = {"knee_heavy": 0.90, "representative": 0.95}
COMPARATOR_SLACK = 0.02
MIN_PAIRS = 250


def certification_corpus(seed: int, knee_frac: float) -> list[bytes]:
    from advanced_scrapper_tpu_torch.cpu.oracle import build_certification_corpus

    return build_certification_corpus(np.random.RandomState(seed), BASES, n_long=N_LONG,
                                      knee_frac=knee_frac)


def oracle_truth(seed: int, knee_frac: float) -> tuple[set, tuple]:
    """The oracle's near-dup pairs of a corpus and its own comparator
    precision ``(precision, pairs, unchained)``: the expensive, engine-free
    half of a score, run in a worker process."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.cpu.oracle import (
        measured_precision,
        oracle_near_dup_pairs,
        oracle_reps,
    )

    texts = certification_corpus(seed, knee_frac)
    params = make_params()
    pairs = oracle_near_dup_pairs(texts, params, THRESHOLD, fast=True)
    comparator = measured_precision(
        texts, oracle_reps(texts, params, THRESHOLD, pairs=pairs), params.shingle_k, THRESHOLD)
    return pairs, comparator


def score(texts: list[bytes], reps: np.ndarray, pairs: set) -> dict:
    """Recall against the oracle's pairs, precision and unchained merges
    by true shingle Jaccard."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.cpu.oracle import measured_precision, measured_recall

    params = make_params()
    recall, n = measured_recall(texts, reps, params, THRESHOLD, pairs=pairs)
    precision, merged, unchained = measured_precision(texts, reps, params.shingle_k, THRESHOLD)
    return {"recall": recall, "oracle_pairs": n, "hits": round(recall * n),
            "precision": precision, "merged_pairs": merged, "unchained": unchained}


def oracle_pool(workers: int) -> ProcessPoolExecutor:
    """Worker processes for :func:`oracle_truth`, spawned, so that no worker
    inherits the caller's CUDA state or threads (the caller's main script
    needs an ``if __name__ == "__main__"`` guard)."""
    return ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn"))


def nvidia_smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "not measured: nvidia-smi unavailable"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1))
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("quality_probe: torch.cuda.is_available() is false; this runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    t_all = time.perf_counter()
    engine = NearDupEngine(DedupConfig(), device=args.device)
    jobs = [(mix, kf, seed) for mix, kf in MIXES.items() for seed in SEEDS]
    failures: list[str] = []
    with oracle_pool(args.workers) as pool:
        truths = {(mix, seed): pool.submit(oracle_truth, seed, kf) for mix, kf, seed in jobs}
        engine.dedup_reps(certification_corpus(SEEDS[0], MIXES["knee_heavy"])[:64])  # warm
        per_mix: dict[str, list[dict]] = {mix: [] for mix in MIXES}
        for mix, kf, seed in jobs:
            texts = certification_corpus(seed, kf)
            t0 = time.perf_counter()
            reps = engine.dedup_reps(texts)
            engine_s = time.perf_counter() - t0
            pairs, comparator = truths[mix, seed].result()
            row = {"mix": mix, "seed": seed, "docs": len(texts),
                   "text_bytes": sum(map(len, texts)), "engine_seconds": engine_s,
                   **score(texts, reps, pairs), "oracle_precision": comparator[0],
                   "oracle_unchained": comparator[2], "tier_stats": {
                       k: engine.rerank_tier.stats.get(k) for k in (
                           "pairs", "exact_checks", "evicted", "launches")}}
            per_mix[mix].append(row)
            print(json.dumps(row), flush=True)
            if row["oracle_pairs"] < MIN_PAIRS:
                failures.append(f"{mix} seed {seed}: {row['oracle_pairs']} oracle pairs")
            if row["recall"] < SEED_RECALL_MIN:
                failures.append(f"{mix} seed {seed}: recall {row['recall']:.4f}")
            if row["unchained"]:
                failures.append(f"{mix} seed {seed}: {row['unchained']} unchained merges")
            if mix == "knee_heavy" and row["precision"] < comparator[0] - COMPARATOR_SLACK:
                failures.append(f"{mix} seed {seed}: precision {row['precision']:.4f} below "
                                f"the comparator {comparator[0]:.4f} less {COMPARATOR_SLACK}")
    for mix, rows in per_mix.items():
        pairs_total = sum(r["oracle_pairs"] for r in rows)
        pooled_recall = sum(r["hits"] for r in rows) / pairs_total
        pooled_precision = float(np.mean([r["precision"] for r in rows]))
        ok = (pooled_recall >= POOLED_RECALL_MIN
              and pooled_precision >= POOLED_PRECISION_MIN[mix])
        print(json.dumps({"mix": mix, "pooled_recall": pooled_recall,
                          "pooled_precision": pooled_precision, "oracle_pairs": pairs_total,
                          "worst_seed_recall": min(r["recall"] for r in rows),
                          "worst_seed_precision": min(r["precision"] for r in rows),
                          "recall_bar": POOLED_RECALL_MIN,
                          "precision_bar": POOLED_PRECISION_MIN[mix], "ok": ok}), flush=True)
        if not ok:
            failures.append(f"{mix}: pooled recall {pooled_recall:.4f}, "
                            f"precision {pooled_precision:.4f}")
    card = nvidia_smi("name,power.limit") if args.device == "cuda" else "cpu"
    print(json.dumps({"device": args.device, "card": card,
                      "seconds": time.perf_counter() - t_all, "failures": failures}))
    print(card)
    print(json.dumps({"ok": not failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
