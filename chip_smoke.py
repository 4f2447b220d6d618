"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernel from ``advanced_scrapper_tpu_torch/csrc`` into
``build/kernels/``, holds it bit-equal against its plain PyTorch version
at every width bucket, drives the port's main path —
``NearDupEngine(...).dedup_reps_async`` at the default widths (4096-byte
blocks, 128 permutations, 16 + 32 bands) over 65,536 ragged articles — and
checks that every planted duplicate resolves to its source and that the
kernel ran once per tile.  Last, the card engine and the CPU engine must
agree on 2,048 articles.  Any failed check exits non-zero.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the card's name and power limit from nvidia-smi,
and before that one JSON line of per-kernel numbers.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_ARTICLES = 65536
WARM_ARTICLES = 4096
PARITY_ARTICLES = 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# INT32 lane-operations per SM per clock on Hopper: IMAD issues on the FMA
# pipe at 64 lanes and IMNMX on the ALU pipe at another 64, side by side
INT32_OPS_PER_SM = 128
CARD_SMS = 132


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ragged_corpus(rng: np.random.RandomState, n: int) -> tuple[list[bytes], dict[int, int]]:
    """``bench.py``'s ragged recipe: log-normal body (median ~700 B), a 25%
    mid tail of 4-20 kB, a 5% long tail of 20-100 kB, 20% planted exact
    duplicates.  Also returns ``{dup index: source index}``."""
    u = rng.rand(n)
    body = rng.lognormal(mean=6.55, sigma=0.8, size=n)
    lens = np.clip(body, 100, 4000).astype(np.int64)
    mid = u > 0.70
    lens[mid] = rng.randint(4000, 20000, size=int(mid.sum()))
    long = u > 0.95
    lens[long] = rng.randint(20000, 100000, size=int(long.sum()))
    docs: list[bytes] = []
    planted: dict[int, int] = {}
    for i in range(n):
        if i >= 8 and rng.rand() < 0.20:
            planted[i] = rng.randint(0, i)
            docs.append(docs[planted[i]])
        else:
            docs.append(rng.randint(32, 127, size=int(lens[i]), dtype=np.uint8).tobytes())
    return docs, planted


def cuda_ms(fn, reps: int = 1) -> float:
    """Device time of ``fn()`` per call, from CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernels_vs_plain(params, cfg, dev) -> dict:
    """Phase 3: both entry points bit-equal to the plain versions at every
    width bucket, on odd row counts and on every tile shape of the main
    path; every tile has an empty row, a row below k, a full row and a
    one-shingle row."""
    from advanced_scrapper_tpu_torch.ops import minhash_cuda
    from advanced_scrapper_tpu_torch.ops.minhash import (
        fused_tile_step_plain,
        minhash_signatures_plain,
        perm_tensors,
    )
    from advanced_scrapper_tpu_torch.ops.pack import pack_tile
    from advanced_scrapper_tpu_torch.pipeline.dedup import (
        _prewarm_widths,
        _tile_bs,
        _tile_rows_options,
    )

    k = params.shingle_k
    a, b = perm_tensors(params, dev)
    rng = np.random.RandomState(0)
    sig0, fold0 = minhash_cuda.minhash_sig.launches, minhash_cuda.minhash_fold.launches
    cases = 0
    for w in _prewarm_widths(cfg):
        # odd row counts, then every tile shape the engine's chunker emits
        for rows in (67, 193, *_tile_rows_options(_tile_bs(cfg, w))):
            tok = rng.randint(0, 256, size=(rows, w)).astype(np.uint8)
            lens = rng.randint(0, w + 1, size=rows).astype(np.int32)
            lens[:4] = [0, k - 1, w, k]  # empty, below k, full width, one shingle
            tok_d = torch.from_numpy(tok).to(dev)
            lens_d = torch.from_numpy(lens).to(dev)
            got = minhash_cuda.minhash_sig(tok_d, lens_d, a, b, k)
            want = minhash_signatures_plain(tok_d, lens_d, params)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
                f"minhash_sig differs from plain at {rows}x{w}"
            )
            n_art = max(rows // 3, 1)
            owners = rng.randint(0, n_art, size=rows).astype(np.int32)
            packed = torch.from_numpy(pack_tile(tok, lens, owners)).to(dev)
            start = rng.randint(0, 1 << 32, size=(n_art, 128), dtype=np.uint64)
            start = torch.from_numpy(start.astype(np.uint32).view(np.int32)).to(dev)
            run_k = start.clone().view(torch.uint32)
            run_p = start.clone().view(torch.uint32)
            minhash_cuda.minhash_fold(run_k, packed, rows=rows, width=w, a=a, b=b, k=k)
            fused_tile_step_plain(run_p, packed, rows=rows, width=w, params=params)
            torch.cuda.synchronize()
            assert torch.equal(run_k.view(torch.int32), run_p.view(torch.int32)), (
                f"minhash_fold differs from plain at {rows}x{w}"
            )
            cases += 1
    sig_n = minhash_cuda.minhash_sig.launches - sig0
    fold_n = minhash_cuda.minhash_fold.launches - fold0
    assert sig_n == cases and fold_n == cases, (sig_n, fold_n, cases)
    return {"cases": cases, "widths": _prewarm_widths(cfg), "max_abs_err": 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.ops import _build, minhash_cuda
    from advanced_scrapper_tpu_torch.ops.lsh import fused_resolve_epilogue
    from advanced_scrapper_tpu_torch.ops.minhash import fused_tile_step_plain, perm_tensors
    from advanced_scrapper_tpu_torch.ops.pack import pack_tile
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine, _jump_rounds

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log("device", card=card, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    out = _build.build("minhash")
    log("build", seconds=time.perf_counter() - t0, built=bool(out),
        ptxas=[ln.strip() for ln in out.splitlines() if "registers" in ln or "smem" in ln])

    cfg = DedupConfig(rerank=False, exact_verify_band=0.0)
    engine = NearDupEngine(cfg, device=dev)
    params = engine.params
    log("kernel_vs_plain", **check_kernels_vs_plain(params, cfg, dev))

    # -- phase 4: the main path at full width ------------------------------
    docs, planted = ragged_corpus(np.random.RandomState(7), MAIN_ARTICLES)
    warm, _ = ragged_corpus(np.random.RandomState(8), WARM_ARTICLES)
    torch.cuda.synchronize()
    engine.dedup_reps_async(warm)[:WARM_ARTICLES].cpu()
    minhash_cuda.minhash_fold.launches = 0
    minhash_cuda.minhash_sig.launches = 0
    t0 = time.perf_counter()
    reps = engine.dedup_reps_async(docs)[:MAIN_ARTICLES].cpu().numpy()
    seconds = time.perf_counter() - t0
    launches = minhash_cuda.minhash_fold.launches
    tiles, h2d = engine.last_tiles, engine.last_h2d_bytes
    assert launches == tiles > 0, f"{launches} kernel launches for {tiles} tiles"
    assert reps.shape == (MAIN_ARTICLES,)
    idx = np.arange(MAIN_ARTICLES)
    assert (reps <= idx).all() and (reps >= 0).all(), "a representative after its row"
    assert (reps[reps] == reps).all(), "representatives are not roots"
    missed = [i for i, s in planted.items() if reps[i] != reps[s]]
    assert not missed, f"{len(missed)} planted dups unresolved, first {missed[:5]}"
    text_bytes = sum(map(len, docs))
    log("main_path", articles=MAIN_ARTICLES, text_bytes=text_bytes, seconds=seconds,
        articles_per_s=MAIN_ARTICLES / seconds, tiles=tiles, h2d_bytes=h2d,
        fold_launches=launches, planted=len(planted),
        dups=int((reps != idx).sum()), card=card)

    # where the main path's time goes: host encode alone, the whole tile
    # loop (encode, pack, copy, kernel) to a synchronise, the resolve epilogue
    t0 = time.perf_counter()
    raw_tiles = list(engine._host_tiles(docs))
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    running, n_bucket = engine._accumulate_device(docs)
    torch.cuda.synchronize()
    tile_loop_s = time.perf_counter() - t0
    valid = engine._valid_device(docs, n_bucket)
    epilogue_ms = cuda_ms(lambda: fused_resolve_epilogue(
        running, valid, params.band_salt, engine._fine_salt(), cfg.sim_threshold,
        cfg.fine_margin, num_coarse=params.num_bands, jump_rounds=_jump_rounds(n_bucket),
        use_fine_margin=False,
    ))
    log("main_path_breakdown", host_encode_s=encode_s, tile_loop_s=tile_loop_s,
        epilogue_ms=epilogue_ms, card=card)
    del running, valid

    # the same tiles again, resident on the card: kernel vs plain, timed
    packed = [torch.from_numpy(pack_tile(t, l, o)).to(dev) for t, l, o in raw_tiles]
    shapes = [t.shape for t, _l, _o in raw_tiles]
    shingles = sum(int(np.maximum(l.astype(np.int64) - (params.shingle_k - 1), 0).sum())
                   for _t, l, _o in raw_tiles)
    a, b = perm_tensors(params, dev)

    def fresh():
        return torch.full((n_bucket, 128), -1, dtype=torch.int32, device=dev).view(torch.uint32)

    run_k, run_p = fresh(), fresh()

    def kernel_pass():
        for p, (rows, w) in zip(packed, shapes):
            minhash_cuda.minhash_fold(run_k, p, rows=rows, width=w, a=a, b=b, k=params.shingle_k)

    def plain_pass():
        for p, (rows, w) in zip(packed, shapes):
            fused_tile_step_plain(run_p, p, rows=rows, width=w, params=params)

    kernel_pass()  # warm
    run_k = fresh()
    ms = cuda_ms(kernel_pass, reps=5)
    plain_ms = cuda_ms(plain_pass)
    assert torch.equal(run_k.view(torch.int32), run_p.view(torch.int32)), (
        "kernel and plain accumulators differ"
    )
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_ops = 2 * 128 * shingles  # multiply-add + min per (shingle, permutation)
    moved = sum(p.numel() for p in packed) + n_bucket * 128 * 4
    ops_ms = int_ops / (INT32_OPS_PER_SM * CARD_SMS * clock_mhz * 1e6) * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    kernels = [{
        "name": "minhash_fold",
        "route": "cuda",
        "source": "advanced_scrapper_tpu_torch/csrc/minhash.cu",
        "replaces": "advanced_scrapper_tpu/ops/pallas_minhash.py:71",
        "launches": launches,
        "max_abs_err": 0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    log("kernel_timing", tiles=len(packed), shingles=shingles, int_ops=int_ops,
        bytes=moved, clock_max_sm_mhz=clock_mhz, ops_bound_ms=ops_ms,
        bytes_bound_ms=bytes_ms, ms=ms, plain_ms=plain_ms, card=card)
    del packed, raw_tiles, run_k, run_p

    # -- phase 5: card engine vs CPU engine ----------------------------------
    small, _ = ragged_corpus(np.random.RandomState(11), PARITY_ARTICLES)
    cpu = NearDupEngine(cfg, device="cpu")
    t0 = time.perf_counter()
    sig_equal = bool((engine.signatures(small) == cpu.signatures(small)).all())
    reps_equal = bool((engine.dedup_reps(small) == cpu.dedup_reps(small)).all())
    log("card_vs_cpu", articles=PARITY_ARTICLES, signatures_equal=sig_equal,
        reps_equal=reps_equal, seconds=time.perf_counter() - t0)
    assert sig_equal and reps_equal, "card and CPU engines disagree"

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
