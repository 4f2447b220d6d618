"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from ``advanced_scrapper_tpu_torch/csrc`` into
``build/kernels/`` (one ``nvcc`` per source, all at once) and holds every
entry point bit-equal against its plain PyTorch version: ``minhash_sig``
and ``minhash_fold`` at every width bucket and tile shape,
``minhash_fold_segments`` on ragged articles of edge lengths, at every
start residue, with several chunks and dropped owners, and the rerank
settle ``rerank_settle`` (its verdicts fused) at sketch widths 1,024, 256,
37, 6,140 and its widest on up to 65,536 pairs with its edge cases.  Then
it drives the port's paths, each with the launch counters set to 0 just
before and read just after:

- the estimator-only path, ``NearDupEngine(DedupConfig(rerank=False,
  exact_verify_band=0)).dedup_reps_async`` at the default widths (128
  permutations, 16 + 32 bands) over 65,536 ragged articles, timed on
  its second call (the first call's time beside it, and what a fresh
  64 MiB pinned buffer costs): every planted duplicate resolves to its
  source, the segment kernel ran once per chunk; its time broken down,
  each MinHash entry point timed on the same corpus beside its bound and
  plain version, the segment size swept;
- the default engine, ``NearDupEngine().dedup_reps`` (the rerank tier,
  exact verify at 0.72), over 3 corpora of 4,096 near-dup-heavy articles
  after a warm one: ``rerank_settle`` ran once per corpus; articles/s, the
  tier's stats and the engine's and tier's own per-stage host seconds and
  device times (``last_clock``); the settle kernel timed on the tier's
  last inputs (``last_settle_inputs``) beside its bound, its plain
  version and a one-element fill kernel (the launch floor);
- the certified path without the tier, ``DedupConfig(rerank=False)``, on
  the same corpora;
- the default engine once over the first 32,768 of the ragged articles
  (the run's time budget: the tier's host half takes most of it): every
  planted duplicate resolves to its source; the settle kernel timed on
  the tier's inputs there as well (the ``rerank_settle`` row's
  ``default_engine_main_corpus`` fields).

The estimator-only path runs its chunks through the pipelined dispatcher
(``pipeline/dispatch.py``): ``main_path`` at the default knobs, with the
staged chunks' lag and each stage's seconds per chunk; ``dispatch_path`` at (``put_workers``,
``dispatch_window``) (1, 0) and (2, 4), each equal to ``main_path``'s
representatives with one segment-kernel launch a chunk, then with
``ASTPU_CHAOS_DISPATCH_OOM=3``: equal again, 3 halvings, 3 more launches.
``legacy_transport_path``: ``packed_h2d=False`` over the same corpus,
equal, one ``minhash_sig`` launch a tile.  ``feed_path``:
``stream_signatures`` over the corpus truncated at 4,096 bytes, batches of
1,024, at ``feed_workers`` 1 and 2: every tag once, one ``minhash_sig``
launch a batch, signatures and band keys equal to the direct calls on the
same rows, ``sig_bits=16`` their low bits, a 2,048-document prefix equal
to the CPU feed, docs/s and the card's busy share.  ``prewarm_path`` (after
the card-vs-CPU phase): ``DedupConfig(prewarm=1)`` makes one warm launch
of the fold and one of the settle, the tier's prewarm one of the settle,
and the prewarmed engine equals the CPU engine on 2,048 articles.

Then the stream backend (``extractors/tpu_batch.py:TpuBatchBackend``) at
its defaults (batches of 1,024, ``bloom_bits`` 2²⁴, 4 hashes) over the
65,536 ragged articles as records with urls (10% repeating an earlier
url, 1% without), submitted one by one, in the exact and the bloom mode,
each timed after a warm batch (``stream_path``): one segment-kernel
launch per batch and no other launch, every planted copy with a fresh url
and an eligible source marked near-dup, the backend's and the engine's
stage times; card and CPU backends equal on 2,048 ``rerank_corpus``
records in batches of 512, and a checkpoint saved after batch 2 resumed
by a fresh card backend to the same annotations.  The persist mode over
the same records in two sessions (``persist_path``: half, ``checkpoint``
and ``close``, then a fresh backend on the same directory; cuts at 65,536
postings, compaction at 8 segments): one segment-kernel launch per batch
and no other, every planted copy with a fresh url and an eligible source
marked ``doc:<id>`` (across the restart too), every mark resolved by the
docmap; records/s, reopen seconds, segments, compactions, postings, disk
and resident bytes; card and CPU backends equal on 2,048 records over two
sessions (annotations, stats, postings, docmap), and
``dedup_against_index`` over 4,096 ragged articles equal on the card and
the CPU.  The persist mode on the index fleet (``fleet_path``): four shard
server processes (``python -m advanced_scrapper_tpu_torch.index.remote``,
2 shards of a primary and a replica) on loopback, the same records in the
same two sessions with ``index_fleet`` set, shard 1's primary SIGKILLed
after session 1's 16th batch: one segment-kernel launch per batch and no
other, annotations equal to ``persist_path``'s, a failover and a promotion
counted and no spill in each session, the killed node restarted after
session 2 and healed by ``repair_once`` (its shard's nodes then give equal
``bucket_digests``); card and CPU backends each over a fleet of its own
equal on 2,048 records (annotations, postings), ``dedup_against_index``
over a fleet equal to the local index's; records/s beside
``persist_path``'s, the clients' RPC latency by method, ``fleet_status()``
and the fan-out's share of each batch.  And ``ExactDedup`` over ``bench.py``'s 262,144 urls
(``exact_path``): the default tier (which one served), the blob tier and
the grouping path with its hash on the card, best of 5, each equal to a
first-seen dict.  Then ``cross_source_dedup`` (``cross_source_path``)
over three sources made from the ragged corpus: a success CSV of 32,768
articles, a second CSV and a sqlite store of 16,384 each, 10% of the last
two copies of first-source articles under other urls: every planted copy
of an eligible source is a dup in the manifest, one launch per batch;
card and CPU manifests byte-equal on a 2,048-article cut.  Then the scrape
plane (``scrape_path``): ``run_scraper`` over 1,024 generated yfin pages
(``scrape_pages``: ragged bodies, 10% near-dup copies, 2% without a title,
a rate-limit sentinel) from ``MockTransport`` at 8 fetch threads and 5,000
pages/s, its successes streamed into the card's stream backend: the rows
add up, every planted copy is annotated, one ``minhash_fold_segments``
launch a stream batch and no other, a resume adds no row, 256 pages at
one thread write the same CSV bytes on the card and on the CPU; pages/s,
the shares of the tree + extractor and of the backend (the scraper's own
stage series) and the card's busy share (``torch.profiler``).
``python3 chip_smoke.py --scrape`` runs that phase alone at its full
depth: 8,192 pages, 1,024 of them for the card-vs-CPU bytes.

``python3 chip_smoke.py --fleet`` runs the persist mode's two sessions,
``fleet_path`` and then the elastic fleet on one ``ShardFleet``
(``elastic_paths``): ``reshard_path``, a live 2→4→2 reshard of session
1's index under the stream, and ``gateway_path``, three tenants behind
the gateway process; the default run keeps ``fleet_path`` alone.

``python3 chip_smoke.py --hostplanes`` runs the harvest and lease planes:
``harvest_path`` (``run_harvest`` over all 1,521 CDX prefixes of about
256 rows each from ``MockTransport``, 10 workers, the merge's
``ExactDedup`` on the card; the merged CSV equal to a CPU merge and to the
planted first-seen urls, the async engine's shards equal to the threaded
engine's, a resume after 10% of the checkpoints are deleted fetching
exactly those), ``lease_path`` (8,192 scrape pages through a
``LeaseServer`` and 4 ``LeaseClient``s of 2 threads on loopback, one
client's link cut mid-run; every url answered once, ``process_results``
streaming its successes into the card's stream backend with one
``minhash_fold_segments`` launch a batch and no other, its CSVs and
annotations equal to a CPU replay), ``control_path`` (the control server:
``add_template``, 256 synchronous and 64 asynchronous extracts) and
``pipe_path`` (a ``PipePool`` of 3 workers over 1,024 urls, none of them
loading torch).

The OPH backend (``csrc/oph.cu``): ``oph_vs_plain`` holds each of its
entry points bit-equal to its plain version (``oph_fold_segments`` at
every start residue mod 16, k = 5, 9 and 1, P = 2, 64, 128 and 1,024,
dropped owners, two chunks into one accumulator, segments of 8 shingles
so that a warp's range cuts owner runs, each text ending at its last
shingle; ``oph_sig`` and ``oph_fold`` at every width bucket on tiles of
64 and 67 rows; ``oph_densify`` on all-empty, one-filled, all-filled,
alternating and wrap-around rows at P = 128 and 64); ``oph_path`` runs
``DedupConfig(backend="oph", rerank=False, exact_verify_band=0)`` over
the 65,536 ragged articles, timed on its second call (one
``oph_fold_segments`` a chunk, one ``oph_densify`` a corpus, no other
launch, every planted duplicate resolved), then on the unpacked
transport (one ``oph_sig`` a tile, equal), card against CPU on 2,048
articles, and times each OPH kernel at these shapes beside its bound, its
plain version and the reference's formulation (a sort and a
``searchsorted`` of each unpacked tile), the fold's rows with the SASS
instructions a shingle of its hash loop and the floor each pipe sets.
``obs_path`` turns telemetry on (``ASTPU_TELEMETRY=1``) for the
estimator-only engine on 2,048 articles:
no kernel build on its second call, one dispatch a launch, the stage,
dispatch-latency, device-put and dispatch series in the Prometheus text,
one fenced latency observation a launch under
``ASTPU_DISPATCH_TIMING=fenced``, and a ``device_trace`` that names
``minhash_fold_segments``.

``mesh_path`` runs the device mesh (``core/mesh.py``, ``parallel/*``):
``dedup_reps_sharded`` over the 65,536 ragged articles on 4×2 and 8×1
meshes of 8 shards on the card, with the estimator-only engine and with
``backend="oph"`` (each equal to the one-device representatives, each
shard's ledger tiles + 1 copies and tiles + 1 dispatches with put skew 0,
the fold once a shard a tile group, one ``oph_densify`` a corpus);
``dedup_against_index(mesh=...)`` on 4,096 articles (keys, attributions
and postings equal to the one-device call's); the batch, block, sequence
and ring steps on 2,048 × 1,024 bytes, card equal to CPU shards; then a
gloo world of 2 ranks sharing the card and an NCCL world of 1
(``chip_smoke.py --mesh-worker``, a process a rank), whose
``multihost_dedup`` and ``dedup_reps_sharded`` equal the one-process
results on every rank, with the collectives' bytes, ms and staging
copies.

Then the card engines and the CPU engines (estimator-only, default,
``rerank=False``) must agree on 2,048 articles.  ``quality_path`` runs the
quality plane through the default engine's certified one-shot on the
card: a ``CanaryProber`` round scored against its measured oracle (recall
at least 0.9, ``canary_recall`` compliant in the ``SloEngine``, the SLIs
equal to the CPU engine's), then the reference canary test's acceptance
configuration under a ``DegradationLadder`` (compliant; violated with
``skip_rerank`` armed and no ``rerank_settle`` launch; compliant again
with the healthy recall), then seed 101 of both certification mixes
(``quality_probe.py``) on the card and the CPU engine: equal
representatives and decision counts by tier, recall at least 0.92, no
unchained merge, on the knee-heavy mix precision at least the oracle's
comparator less 0.02; the oracle's pairs computed in two worker
processes meanwhile; under 90 s.

The port's entry points: ``entry()`` (``entry_path``: its dedup step on
the card equal to the CPU's, one ``minhash_sig`` launch, the planted row
resolved) and the CLI through ``cli.main`` (``cli_path``): ``dedup`` over
2,048 lines, whole and ``--stream``, ``xdedup`` over three 1,024-row
sources and ``match --workers 1`` over 256 S&P articles, each on the card
and with ``--device cpu``, outputs byte-equal, each card command's
kernels launched.

Last, the matcher (``pipeline/matcher.py``) at S&P scale, from a seed: 500
tickers, ~4,500 names, one chunk of 20,000 articles with planted mentions,
decoys, non-ASCII and overlong articles.  Its kernels ``match_screen`` and
``myers_bound`` are first held bit-equal to their plain versions on edge
cases (row lengths 0-65,536, a misaligned base, gram-less and truncated
names, thresholds 95, 90, 80, 97.5 and 50, patterns of 1 and 32 bytes and
``ok`` False, two chunks into one set of tables; ``myers_bound`` also on
300 patterns in three groups, one with a non-ASCII pattern, over rows of
0 to 2T + 1 tiles with every tail class and gated-out rows between;
``myers_pairs``, one pattern per pair, on texts of 0 to 200,000 bytes,
at the edges of its geometry (a block's second warp, a second and a third
round), on launches that share one text or one pattern, with the buffer
1 to 3 bytes off its alignment, and pairs out of range);
then ``match_chunk`` runs screen-only and with the bound forced (timed on a
later call: one launch of each kernel per chunk, every planted mention
found, both modes' matches equal), ``run_matcher`` runs end to end (the
"auto" race, the verify pool, the per-ticker CSVs), the kernels are timed
on the chunk beside their bounds and plain versions (``myers_bound`` with
its chains a thread, the SM clock before and after and its SASS
instructions per step, by pipe with the floor each pipe sets;
``match_screen`` with its rows a block and SASS instructions per (row,
gram) and per written pair), and card and CPU must agree on a
256-article subset (64 with the bound forced) and write byte-equal CSV
trees.  The legacy screen (``packed=False``, ``matcher_legacy``) takes
the same chunk in both modes: its matches equal the packed screen's, one
``match_screen`` launch a batch of 128 and one ``myers_pairs`` launch a
batch with pairs, card and CPU trees equal on 256 (64 forced), and
``myers_pairs`` timed on the chunk's batches beside its bounds, its
launch floor and its chain floor (a lone pair on a 543-byte and on a
1-byte text).  Any failed check exits non-zero.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the card's name and power limit from nvidia-smi,
and before that one JSON line of per-kernel numbers.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import html
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

MAIN_ARTICLES = 65536
WARM_ARTICLES = 4096
PARITY_ARTICLES = 2048
RERANK_ARTICLES = 4096  # bench.py's rerank regime: 4,096 articles x 3 corpora
RERANK_CORPORA = 3
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


def host_cpu() -> str:
    """The host's CPU model, from ``/proc/cpuinfo``: the tier's host half
    runs there."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")), "")
    except OSError:
        return ""


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


def rerank_corpus(rng: np.random.RandomState, n: int) -> list[bytes]:
    """``bench.py``'s rerank recipe: ~35% mutated copies of earlier
    articles at ~1% byte edits (pairs across the Jaccard knee), the rest
    random with the ragged length mix capped at 8 kB."""
    docs: list[bytes] = []
    for i in range(n):
        if i >= 8 and rng.rand() < 0.35:
            src = bytearray(docs[rng.randint(0, i)])
            for _ in range(max(1, len(src) // 100)):
                src[rng.randint(0, len(src))] = rng.randint(32, 127)
            docs.append(bytes(src))
        else:
            ln = int(np.clip(rng.lognormal(6.55, 0.8), 100, 8000))
            docs.append(rng.randint(32, 127, size=ln, dtype=np.uint8).tobytes())
    return docs


#: GPU clocks the card spins before a queued timing (~10 ms at 1980 MHz)
QUEUE_AHEAD_CYCLES = 20_000_000


def cuda_ms(fn, reps: int = 1, queued: bool = False, ahead: int = QUEUE_AHEAD_CYCLES) -> float:
    """Device time of ``fn()`` per call, from CUDA events.  With
    ``queued``, the card first spins ``ahead`` clocks (~10 ms by default,
    ``torch.cuda._sleep``) while the host enqueues the events and the
    ``reps`` calls, so the calls run back to back and the host's time per
    call (which, for a kernel of a fraction of a millisecond, can be longer
    than the kernel) does not count."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(ahead)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiler_device_ms(fn, want: tuple[str, ...], reps: int = 5,
                       windows: int = 6) -> dict[str, tuple[float, int]]:
    """Every event ``torch.profiler`` gave device time over ``reps`` calls
    of ``fn`` in one window, after one warm call, by name: its device ms in
    all and the launches recorded.  A window that lacks a kernel whose name
    holds one of ``want`` is taken again, up to ``windows`` times: on the
    card's machine the profiler now and then hands back a window with no
    device event at all, and late in a long process it can record fewer
    launches than were made (2 or 3 of 5), so a time per call is the time per
    recorded launch times the launches a call makes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_time_total > 0}
        if all(any(w in k for k in seen) for w in want):
            break
    return seen


def per_launch_ms(seen: dict[str, tuple[float, int]], kernel: str) -> tuple[float, int]:
    """``(ms per recorded launch, launches recorded)`` of the kernels in
    :func:`profiler_device_ms`'s ``seen`` whose name holds ``kernel``;
    ``(0.0, 0)`` if there are none."""
    ms = sum(v[0] for k, v in seen.items() if kernel in k)
    n = sum(v[1] for k, v in seen.items() if kernel in k)
    return (ms / n if n else 0.0), n


def profiled_ms(fn, *kernels: str, reps: int = 5, launches: int = 1) -> list[float]:
    """Device ms per call of ``fn`` of the kernels whose name holds each of
    ``kernels``, each launched ``launches`` times a call
    (:func:`profiler_device_ms`)."""
    seen = profiler_device_ms(fn, kernels, reps)
    out = []
    for kernel in kernels:
        ms, _n = per_launch_ms(seen, kernel)
        assert ms > 0, f"the profiler saw no {kernel} kernel, only {sorted(seen)}"
        out.append(ms * launches)
    return out


def timed(fn, kernel: str, reps: int = 5, launches: int = 1) -> tuple[float, float]:
    """``(event_ms, kernel_ms)`` per call of ``fn`` after one warm call:
    CUDA-event time of the calls as made (wrapper work, launches and any
    other device work included), and the device time of the kernels whose
    name holds ``kernel``, ``launches`` of them a call, by ``torch.profiler``."""
    fn()
    event_ms = cuda_ms(fn, reps)
    return event_ms, profiled_ms(fn, kernel, reps=reps, launches=launches)[0]


def check_kernels_vs_plain(params, cfg, dev) -> dict:
    """Phase 3: both tile entry points bit-equal to the plain versions at
    every width bucket, on odd row counts and on every tile shape of the
    reference chunker, and at shingle widths 9 and 1; every tile has an
    empty row, a row below k, a full row and a one-shingle row."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
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

    rng = np.random.RandomState(0)
    sig0, fold0 = minhash_cuda.minhash_sig.launches, minhash_cuda.minhash_fold.launches
    cases = 0
    # odd row counts, then every tile shape the engine's chunker emits; the
    # shingle widths 9 and 1 take the kernel's run-time-width instantiation
    shapes = [(params, w, rows) for w in _prewarm_widths(cfg)
              for rows in (67, 193, *_tile_rows_options(_tile_bs(cfg, w)))]
    shapes += [(make_params(shingle_k=kk), w, 67) for kk in (9, 1) for w in (64, 4096)]
    for p, w, rows in shapes:
        k = p.shingle_k
        a, b = perm_tensors(p, dev)
        tok = rng.randint(0, 256, size=(rows, w)).astype(np.uint8)
        lens = rng.randint(0, w + 1, size=rows).astype(np.int32)
        lens[:4] = [0, k - 1, w, k]  # empty, below k, full width, one shingle
        tok_d = torch.from_numpy(tok).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        got = minhash_cuda.minhash_sig(tok_d, lens_d, a, b, k)
        want = minhash_signatures_plain(tok_d, lens_d, p)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            f"minhash_sig differs from plain at {rows}x{w}, k={k}"
        )
        n_art = max(rows // 3, 1)
        owners = rng.randint(0, n_art, size=rows).astype(np.int32)
        packed = torch.from_numpy(pack_tile(tok, lens, owners)).to(dev)
        start = rng.randint(0, 1 << 32, size=(n_art, 128), dtype=np.uint64)
        start = torch.from_numpy(start.astype(np.uint32).view(np.int32)).to(dev)
        run_k = start.clone().view(torch.uint32)
        run_p = start.clone().view(torch.uint32)
        minhash_cuda.minhash_fold(run_k, packed, rows=rows, width=w, a=a, b=b, k=k)
        fused_tile_step_plain(run_p, packed, rows=rows, width=w, params=p)
        torch.cuda.synchronize()
        assert torch.equal(run_k.view(torch.int32), run_p.view(torch.int32)), (
            f"minhash_fold differs from plain at {rows}x{w}, k={k}"
        )
        cases += 1
    sig_n = minhash_cuda.minhash_sig.launches - sig0
    fold_n = minhash_cuda.minhash_fold.launches - fold0
    assert sig_n == cases and fold_n == cases, (sig_n, fold_n, cases)
    return {"cases": cases, "widths": _prewarm_widths(cfg), "max_abs_err": 0}


def flat_text(docs: list[bytes], lead: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(text uint8, doc_off int64, doc_len int64)`` of ``docs`` joined
    after ``lead`` filler bytes."""
    lens = np.fromiter(map(len, docs), np.int64, count=len(docs))
    off = lead + np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    text = np.frombuffer(b"\x7f" * lead + b"".join(docs), np.uint8)
    return text, off, lens


def check_segments_vs_plain(params, dev) -> dict:
    """Phase 3, segment path: ``minhash_fold_segments`` bit-equal to
    ``fold_segments_plain`` on articles of length 0, 1, k-1, k, S+k-2,
    S+k-1, S+k, 3S and 100 kB among random ones, at every start residue
    mod 16 (and from a text that starts off a 16-byte boundary), for the
    engine's segment size, the kernel's largest and an odd one; two chunks
    fold into one accumulator, several articles share an owner, and owners
    N-1 and N (dropped) occur.  Descriptors go on the card and pinned on
    the host.  Shingle widths 9 and 1 take the kernel's run-time-width
    instantiation."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.cpu.hostbatch import segment_ranges
    from advanced_scrapper_tpu_torch.ops import minhash_cuda
    from advanced_scrapper_tpu_torch.ops.minhash import (
        SEGMENT_SHINGLES,
        fold_segments_plain,
        perm_tensors,
    )

    rng = np.random.RandomState(3)
    cases = 0
    residues: set[int] = set()
    before = minhash_cuda.minhash_fold_segments.launches
    runs = [(params, SEGMENT_SHINGLES), (params, minhash_cuda.MAX_SEGMENT_SHINGLES),
            (params, 37), (make_params(shingle_k=9), SEGMENT_SHINGLES),
            (make_params(shingle_k=1), 37)]
    for p, S in runs:
        k = p.shingle_k
        a, b = perm_tensors(p, dev)
        edge = [0, 1, k - 1, k, S + k - 2, S + k - 1, S + k, 3 * S, 100_000]
        lens = np.r_[edge, rng.randint(0, 5000, size=300)]
        rng.shuffle(lens)
        docs = [rng.randint(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lens]
        n_docs = len(docs)
        owners = rng.randint(0, n_docs + 2, size=n_docs)  # shared and dropped owners
        owners[:2] = [n_docs - 1, n_docs]
        start = rng.randint(0, 1 << 32, size=(n_docs, 128), dtype=np.uint64)
        start = torch.from_numpy(start.astype(np.uint32).view(np.int32)).to(dev)
        run_k = start.clone().view(torch.uint32)
        run_p = start.clone().view(torch.uint32)
        half = n_docs // 2
        for lead, part in ((3, slice(0, half)), (0, slice(half, n_docs))):  # two chunks
            text, off, ln = flat_text(docs[part], lead)
            seg = segment_ranges(off, ln, owners[part], k, S)
            residues.update((seg[0] % 16).tolist())
            full = torch.from_numpy(np.r_[np.zeros(5, np.uint8), text]).to(dev)
            text_d = full[5:]  # starts off a 16-byte boundary
            host = [torch.from_numpy(x).pin_memory() for x in seg]
            card = [x.to(dev) for x in host]
            minhash_cuda.minhash_fold_segments(run_k, text_d, *(card if lead else host), a, b, k)
            fold_segments_plain(run_p, text_d, *card, p)
        torch.cuda.synchronize()
        assert torch.equal(run_k.view(torch.int32), run_p.view(torch.int32)), (
            f"minhash_fold_segments differs from plain at S={S}, k={k}"
        )
        cases += 1
    assert residues == set(range(16)), sorted(residues)
    launches = minhash_cuda.minhash_fold_segments.launches - before
    assert launches == 2 * cases, (launches, cases)
    return {"cases": cases, "residues_mod_16": len(residues), "max_abs_err": 0}


def check_rerank_vs_plain(dev) -> dict:
    """Phase 3, the settle: ``rerank_settle`` (jq and verdict in one
    launch) bit-equal to ``settle_plain`` (``pair_jq_plain``, then
    ``rerank_finalize``) at sketch widths 1,024, 256, 37 and 6,140 on 1, 7,
    1,000 and 65,536 pairs, at the kernel's widest sketch on 1 and 1,000,
    and at 1,024 from a base 4 bytes off a 16-byte boundary.  The sketches
    are ``bottom_sketches`` of mutated texts longer than the sketch and
    shorter, and of two texts below a shingle (empty sketches); every pair
    set starts with the edge cases (empty ∪ empty, ``i == j``, short beside
    full both ways, empty beside full, one row named twice), then half its
    pairs in runs that share ``ia`` (sorted, as the tier's list), half
    random.  Margin bands vary; indices go on the card and pinned on the
    host; no pairs launch nothing."""
    from advanced_scrapper_tpu_torch.ops import rerank_cuda
    from advanced_scrapper_tpu_torch.ops.rerank import bottom_sketches, settle_plain

    rng = np.random.RandomState(5)
    texts = []
    for length in (40000, 6000, 3000, 700, 120, 30):
        for _ in range(4 if length == 40000 else 40):
            base = bytearray(rng.randint(32, 127, size=length, dtype=np.uint8))
            texts.append(bytes(base))
            for _ in range(rng.randint(1, max(2, length // 20))):
                base[rng.randint(0, length)] = rng.randint(32, 127)
            texts.append(bytes(base))
    texts += [b"xy", b"ab"]
    n = len(texts)
    # empty ∪ empty, i == j, short beside full (both ways), empty beside
    # full (both ways), one row twice
    edge_i = np.array([n - 2, n - 1, 0, 9, 0, n - 3, n - 2, 0, 11, 11], np.int32)
    edge_j = np.array([n - 1, n - 1, 0, 9, n - 3, 0, 0, n - 2, 11, 12], np.int32)
    bands = [(6600, 7400), (0, 0), (5000, 10001), (-3, 20000)]
    widest = rerank_cuda.max_sketch()
    runs = [(1024, (1, 7, 1000, 65536)), (256, (1, 7, 1000, 65536)),
            (37, (1, 7, 1000, 65536)), (6140, (1, 7, 1000, 65536)), (widest, (1, 1000)),
            (1024, (1000,))]
    before = rerank_cuda.rerank_settle.launches
    cases = 0
    for r, (size, ms) in enumerate(runs):
        sk_np = bottom_sketches(texts, 5, size).view(np.int32)
        if r == len(runs) - 1:  # rows from a base 4 bytes past a 16-byte boundary
            flat = torch.empty((sk_np.size + 1,), dtype=torch.int32, device=dev)
            flat[1:] = torch.from_numpy(sk_np.ravel()).to(dev)
            sk = flat[1:].view(n, size)
            assert sk.data_ptr() % 16 == 4
        else:
            sk = torch.from_numpy(sk_np).to(dev)
        sk = sk.view(torch.uint32)
        for m in ms:
            half = m // 2
            ii = np.r_[edge_i, np.sort(rng.randint(0, n, half)), rng.randint(0, n, m)][:m]
            jj = np.r_[edge_j, rng.randint(0, n, half), rng.randint(0, n, m)][:m]
            lo, hi = bands[cases % len(bands)]
            host = m == 1000  # pinned host indices, copied by the wrapper
            ia, ib = (torch.from_numpy(x.astype(np.int32)) for x in (ii, jj))
            ia, ib = (t.pin_memory() if host else t.to(dev) for t in (ia, ib))
            got = rerank_cuda.rerank_settle(sk, ia, ib, size, lo, hi)
            want = settle_plain(sk, ia.to(dev), ib.to(dev), lo, hi)
            torch.cuda.synchronize()
            assert got.shape == (2, m) and torch.equal(got, want), (
                f"rerank_settle differs from plain at S={size}, m={m}, band=[{lo}, {hi})")
            cases += 1
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        assert rerank_cuda.rerank_settle(sk, empty, empty, size, 0, 1).shape == (2, 0)
    # into a given output
    out = torch.full((2, 7), 99, dtype=torch.int32, device=dev)
    ia = torch.from_numpy(edge_i[:7]).to(dev)
    ib = torch.from_numpy(edge_j[:7]).to(dev)
    assert rerank_cuda.rerank_settle(sk, ia, ib, 1024, 6600, 7400, out=out) is out
    assert torch.equal(out, settle_plain(sk, ia, ib, 6600, 7400))
    cases += 1
    launches = rerank_cuda.rerank_settle.launches - before
    assert launches == cases, (launches, cases)
    return {"cases": cases, "sketch_sizes": [size for size, _ in runs], "max_abs_err": 0}


def edit_bytes(rng: np.random.RandomState, raw: bytes, edits: int) -> bytes:
    """``raw`` with ``edits`` random byte substitutions, insertions or
    deletions (letters only)."""
    b = bytearray(raw)
    for _ in range(edits):
        op, at = rng.randint(3), rng.randint(0, max(len(b), 1))
        c = int(rng.randint(97, 123))
        if op == 0 and b:
            b[at] = c
        elif op == 1:
            b.insert(at, c)
        elif b:
            del b[at]
    return bytes(b)


def match_edge_case(rng: np.random.RandomState, n_rows: int):
    """Names and rows for the screen and bound checks.  Names: random
    words of 1-40 bytes, empty and 2-byte names (no gram), a 3-byte one (1
    gram), names of 98 bytes (96 grams, some repeated) and over 98 bytes
    (truncated at 96 grams), ALL-CAPS exact names, a non-ASCII name;
    patterns of length 1 and 32, an empty and a 40-byte one (``ok``
    False).  Rows (``title\\ntext``): lengths 0, 1, 2, 3, 4, 511, 512, 513,
    543, 1024 and 65,536 first, then random, with names planted exact and
    with 1-2 edits; text lengths of exactly ``m`` and ``m + 1`` for a short
    pattern; some texts non-ASCII (flag off), some titles non-ASCII (bytes
    over 127 inside flagged rows)."""
    from advanced_scrapper_tpu_torch.ops.match import FLAG_REFINE_OK

    def word(lo, hi, upper=False):
        base = 65 if upper else 97
        return bytes(rng.randint(base, base + 26, size=rng.randint(lo, hi + 1), dtype=np.uint8))

    names = [word(3, 40) for _ in range(120)] + [word(2, 5, upper=True) for _ in range(40)]
    names += [b"abcabc", b"z" * 98, b"ab" * 49, b"abc"]  # repeated grams; 96 and 1 kept
    names += [b"", b"ab", word(99, 140), word(120, 200), "Société Générale".encode(),
              b"q", word(32, 32), b"Tim Cook", b"International Business Machines Corporation"]
    fuzzy = np.array([not n.isupper() for n in names])
    pats = [n for n in names if 0 < len(n) <= 32][:100] + [b"", word(40, 40), b"x", word(32, 32)]
    cols = list(range(len(pats) - 4)) + [len(names) - 8, len(names) - 7, len(names) - 4,
                                          len(names) - 3]
    pat_cols = [names.index(p) if p in names else c for p, c in zip(pats, cols)]
    pat_cols = list(dict.fromkeys(pat_cols))  # distinct columns
    while len(pat_cols) < len(pats):
        pat_cols.append(next(c for c in range(len(names)) if c not in pat_cols))
    edge = [0, 1, 2, 3, 4, 511, 512, 513, 543, 1024, 65536]
    rows, text_len, title_len, flags = [], [], [], []
    for i in range(n_rows):
        total = edge[i] if i < len(edge) else int(rng.choice([40, 300, 900, 2100, 3000]))
        title = word(0, min(60, max(total - 1, 0)) if total else 0) if total else b""
        title = title[: max(total - 1, 0)]
        body_len = max(total - len(title) - 1, 0)
        body = bytearray(rng.randint(97, 123, size=body_len, dtype=np.uint8))
        if body_len > 60 and i % 3:
            for _ in range(rng.randint(1, 4)):
                nm = names[rng.randint(len(names))]
                nm = edit_bytes(rng, nm, rng.randint(0, 3)) if i % 2 else nm
                at = rng.randint(0, body_len - len(nm)) if body_len > len(nm) else 0
                body[at:at + len(nm)] = nm
        if i == len(edge):       # a text of exactly m, then m + 1, for a short pattern
            body = bytearray(pats[0])
        if i == len(edge) + 1:
            body = bytearray(pats[0] + b"z")
        if i % 17 == 5:          # non-ASCII text: flag off
            body[:2] = "é".encode()
        if i % 13 == 7:          # non-ASCII title inside a flagged row
            title = "Zürich ".encode() + title
        raw = bytes(title) + b"\n" + bytes(body) if total else b""
        if i < len(edge):
            raw = (raw + bytes(rng.randint(97, 123, size=total, dtype=np.uint8)))[:total]
        rows.append(raw)
        tl = len(raw) - len(title) - 1 if raw[len(title):len(title) + 1] == b"\n" else len(raw)
        text_len.append(max(tl, 0))
        title_len.append(len(title) if tl != len(raw) else 0)
        ascii_text = raw[len(raw) - text_len[-1]:].isascii() if text_len[-1] else False
        flags.append(FLAG_REFINE_OK if ascii_text else 0)
    return (names, fuzzy, pats, np.array(pat_cols, np.int64), rows,
            np.array(text_len, np.int32), np.array(title_len, np.int32),
            np.array(flags, np.int32))


MYERS_PATTERNS = 300  # three groups of 128 patterns, the last one partial
MYERS_TAILS = (1, 3, 4, 31, 32, 512, 542, 543)


def myers_edge_case(rng: np.random.RandomState, chains: int):
    """Patterns and rows the chain walk of ``myers_bound`` meets at its
    edges, for ``chains`` tiles a thread: 300 patterns of 1-32 bytes (an
    empty and a 40-byte one, ``ok`` False; one non-ASCII pattern in the
    middle group, whose block then reads such bytes' masks from global
    memory), in a mask of 320 columns; rows of ``(n - 1) * 512 + tail``
    bytes for n of 1, chains - 1, chains, chains + 1 and 2 * chains + 1
    tiles and every tail class of :data:`MYERS_TAILS` (a tail over 512 adds
    a tile), rows of no bytes, and rows with flag bit 0 clear between the
    rows that are gated in; patterns planted exact and with 1-2 edits,
    non-ASCII titles in some flagged rows.  Returns ``(patterns, cols,
    n_names, rows, text_len, flags)``."""
    from advanced_scrapper_tpu_torch.ops.match import FLAG_REFINE_OK

    pats = [bytes(rng.randint(97, 123, size=rng.randint(1, 33), dtype=np.uint8))
            for _ in range(MYERS_PATTERNS - 3)]
    pats[150] = "Zürich AG".encode()
    pats += [b"", b"y" * 40, b"q"]
    n_names = 320
    cols = rng.permutation(n_names)[:len(pats)].astype(np.int64)
    lens = [0]
    for n_tiles in sorted({1, max(chains - 1, 1), chains, chains + 1, 2 * chains + 1}):
        lens += [(n_tiles - 1) * 512 + tail for tail in MYERS_TAILS]
    lens = list(np.array(lens)[rng.permutation(len(lens))]) + [0]
    rows, text_len, flags = [], [], []
    for n in lens:
        for gated_in in ((True, False) if rng.rand() < 0.3 else (True,)):
            n_row = int(n) if gated_in else int(rng.choice([0, 40, 700, 1100]))
            title = bytes(rng.randint(65, 91, size=min(rng.randint(0, 30), max(n_row - 1, 0)),
                                      dtype=np.uint8))
            if n_row > 40 and rng.rand() < 0.2:
                title = ("É" + title.decode()).encode()[: max(n_row - 1, 0)]
                title = title.decode("utf-8", "ignore").encode()
            body = bytearray(rng.randint(97, 123, size=max(n_row - len(title) - 1, 0),
                                         dtype=np.uint8))
            for _ in range(rng.randint(0, 4) if len(body) > 40 else 0):
                nm = pats[rng.randint(len(pats))]
                nm = edit_bytes(rng, nm, rng.randint(0, 3)) if rng.rand() < 0.5 else nm
                at = rng.randint(0, max(len(body) - len(nm), 1))
                body[at:at + len(nm)] = nm
            raw = (title + b"\n" + bytes(body))[:n_row] if n_row > 1 else bytes(body)[:n_row]
            raw = raw.ljust(n_row, b"a")
            rows.append(raw)
            tl = n_row - len(title) - 1 if n_row > 1 else n_row
            text_len.append(tl)
            flags.append(FLAG_REFINE_OK if gated_in and tl > 0 and raw[n_row - tl:].isascii()
                         else 0)
    return pats, cols, n_names, rows, np.array(text_len, np.int32), np.array(flags, np.int32)


def check_myers_edges(dev) -> int:
    """``myers_bound`` at the edges of its chain walk (:func:`myers_edge_case`):
    bit-equal to ``myers_bound_plain`` in the gated mode at thresholds 95,
    90, 80, 97.5 and 50, over a mask whose bit-0 bits are random, and its
    ``dist=`` output equal to ``semiglobal_dist_shared_plain``.  Returns
    its launches (6)."""
    from advanced_scrapper_tpu_torch.ops import editdist_cuda
    from advanced_scrapper_tpu_torch.ops.editdist import (
        build_pattern_masks,
        myers_bound_plain,
        semiglobal_dist_shared_plain,
    )

    rng = np.random.RandomState(29)
    pats, cols, n_names, rows, tl, fl = myers_edge_case(rng, editdist_cuda.myers_chains())
    masks, plens, ok = build_pattern_masks(pats)
    assert (masks[:, 128:] != 0).any(axis=1)[128:256].any() and not (masks[:128, 128:]).any()
    pm = (torch.from_numpy(masks.view(np.int32)).to(dev).view(torch.uint32),
          torch.from_numpy(plens).to(dev), torch.from_numpy(ok).to(dev),
          torch.from_numpy(cols).to(dev))
    text, off, lens = flat_text(rows, lead=7)
    text_d = torch.from_numpy(text).to(dev)
    ra = [torch.from_numpy(x).to(dev) for x in (off, lens.astype(np.int32), tl, fl)]
    base = torch.from_numpy(rng.randint(0, 2, size=(len(rows), n_names)).astype(np.uint8)).to(dev)
    for t in (95.0, 90.0, 80.0, 97.5, 50.0):
        got, want = base.clone(), base.clone()
        editdist_cuda.myers_bound(text_d, *ra, *pm, t, got)
        myers_bound_plain(text_d, *ra, *pm, t, want)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"myers_bound differs from plain at t={t} (300 patterns)"
        assert (got >> 1).any(), t
    dist = torch.empty((len(rows), len(pats)), dtype=torch.int32, device=dev)
    editdist_cuda.myers_bound(text_d, *ra, *pm, 95.0, base.clone(), dist=dist)
    width = int(lens.max())
    padded = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = np.frombuffer(r, np.uint8)
    want_d = torch.cat([semiglobal_dist_shared_plain(
        pm[0], pm[1], torch.from_numpy(padded[r0:r0 + 32]).to(dev), ra[1][r0:r0 + 32])
        for r0 in range(0, len(rows), 32)])
    torch.cuda.synchronize()
    assert torch.equal(dist, want_d), "myers_bound distances differ from plain (300 patterns)"
    return 6


def pairs_constant(name: str) -> int:
    """A constant of ``myers_pairs`` (``constexpr int name = ...;``), read
    from ``csrc/editdist.cu``, the source the kernel is built from."""
    from advanced_scrapper_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "editdist.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def pair_edge_lengths(block: int = 512) -> list[int]:
    """Text lengths at the edges of ``myers_pairs``' geometry (a pair a
    block of ``kPairWarps`` warps, a tile a thread): one byte short of, at
    and one past 32 tiles (a block's second warp), 32 * warps tiles (a
    second round) and twice that (a third)."""
    lanes = 32 * pairs_constant("kPairWarps")
    return [n * block + d for n in (32, lanes, 2 * lanes) for d in (-1, 0, 1)]


def check_myers_pairs_vs_plain(dev) -> dict:
    """``myers_pairs`` (one pattern per pair) bit-equal to
    ``semiglobal_dist_plain``: patterns of 1 to 32 bytes, of non-ASCII
    bytes, of zero bytes, empty and of a length out of range, and masks in
    which every byte's mask has bits set; texts of 0, 1, T - 1, T, T + 1,
    543, 544, 2T + 1, 3T + 31, 65,536 and 200,000 bytes, of every byte
    value, and at the edges of the kernel's geometry
    (:func:`pair_edge_lengths`), a pattern planted across a tile edge;
    every (text, pattern) pair, 20,000 random ones and pairs whose indices
    or text lie out of range (-1), the buffer 3 bytes off its alignment;
    every (text, pattern) pair again with the buffer 1 and 2 bytes off;
    then launches in which every pair shares one text, every pair shares
    one pattern, and pairs of 0 and 65,536 bytes alternate."""
    from advanced_scrapper_tpu_torch.ops import editdist_cuda
    from advanced_scrapper_tpu_torch.ops.editdist import build_pattern_masks, semiglobal_dist_plain

    rng = np.random.RandomState(41)
    T = 512
    pats = [bytes(rng.randint(97, 101, size=m, dtype=np.uint8)) for m in range(1, 33)]
    pats += [bytes(rng.randint(0, 256, size=rng.randint(1, 33), dtype=np.uint8))
             for _ in range(8)] + [b"\0" * 4, b"\0\1" * 16, b"", b"z" * 32]
    masks, plens, _ok = build_pattern_masks(pats)
    plens[-1] = 33  # a length out of range
    # masks in which every byte's mask has bits set, as no pattern's has
    masks = np.concatenate([masks[:-1], rng.randint(1, 1 << 31, size=(2, 256)).astype(np.uint32)
                            | 1, masks[-1:]])
    plens = np.concatenate([plens[:-1], np.array([7, 32], np.int32), plens[-1:]])
    lengths = (0, 1, 7, 31, 32, T - 1, T, T + 1, 543, 544, 2 * T + 1, 3 * T + 31, 4096, 65536)
    texts = [bytes(rng.randint(97, 101, size=n, dtype=np.uint8)) for n in lengths]
    texts.append(bytes(rng.randint(0, 256, size=3000, dtype=np.uint8)))
    texts[10] = texts[10][:T - 5] + pats[20] + texts[10][T - 5 + len(pats[20]):]
    texts += [bytes(rng.randint(97, 101, size=n, dtype=np.uint8))
              for n in (*pair_edge_lengths(), 200_000)]
    n, K = len(texts) + 1, len(plens)
    every = (np.repeat(np.arange(n), K), np.tile(np.arange(K), n))
    pm = [torch.from_numpy(masks.view(np.int32)).view(torch.uint32).to(dev),
          torch.from_numpy(plens).to(dev)]

    def held(lead: int, pt, pp) -> torch.Tensor:
        """The kernel against the plain version on the pairs ``(pt, pp)``,
        the texts ``lead`` bytes into the buffer and a last one past its
        end; returns the distances."""
        blob = bytes(rng.randint(97, 123, size=lead, dtype=np.uint8)) + b"".join(texts)
        tl = np.array([len(t) for t in texts] + [10], np.int32)
        off = np.zeros(len(tl), np.int64)
        off[1:len(texts)] = np.cumsum(tl[:len(texts) - 1])
        off[:len(texts)] += lead
        off[-1] = len(blob) - 2
        args = [*pm, torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev),
                torch.from_numpy(off).to(dev), torch.from_numpy(tl).to(dev),
                torch.from_numpy(np.asarray(pt, np.int32)).to(dev),
                torch.from_numpy(np.asarray(pp, np.int32)).to(dev)]
        want = semiglobal_dist_plain(*args).cpu()
        got = editdist_cuda.myers_pairs(*args).cpu()
        assert torch.equal(got, want), f"myers_pairs differs from semiglobal_dist_plain ({lead=})"
        return want

    pt = np.concatenate([every[0], rng.randint(0, n, 20000), [-1, n, 0, 0]])
    pp = np.concatenate([every[1], rng.randint(0, K, 20000), [0, 0, -1, K]])
    want = held(3, pt, pp)
    for lead in (1, 2):
        held(lead, *every)
    long_text = lengths.index(65536)
    held(3, np.full(500, long_text), rng.randint(0, K, 500))           # one text
    held(3, rng.randint(0, n - 1, 500), np.full(500, 20))               # one pattern
    held(3, np.tile([0, long_text], 64), rng.randint(0, K - 1, 128))   # 0 and 65,536 bytes
    one_text = [torch.zeros(1, dtype=d, device=dev) for d in (torch.uint8, torch.int64, torch.int32)]
    no_pairs = torch.zeros(0, dtype=torch.int32, device=dev)
    assert editdist_cuda.myers_pairs(*pm, *one_text, no_pairs, no_pairs).shape == (0,)
    return {"myers_pairs_pairs": int(pt.size), "myers_pairs_minus_one": int((want == -1).sum()),
            "myers_pairs_zero": int((want == 0).sum()), "myers_pairs_texts": len(texts),
            "myers_pairs_longest": max(map(len, texts)), "myers_pairs_equal": True}


def entry_path(card: str) -> None:
    """The port's ``entry()`` (``advanced_scrapper_tpu_torch/entry.py``):
    its dedup step on the card against the same step on the CPU, with the
    launch counters set to 0 just before the card's call: one
    ``minhash_sig`` launch and no other; the planted copy (row 128)
    resolved to row 0."""
    from advanced_scrapper_tpu_torch.entry import entry

    fn, args = entry()
    fn(*args)  # warm: the kernel's library
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn(*args).cpu()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    cpu_fn, cpu_args = entry(device="cpu")
    want = cpu_fn(*cpu_args)
    equal = torch.equal(out, want)
    log("entry_path", rows=int(args[0].shape[0]), width=int(args[0].shape[1]), seconds=seconds,
        launches=launches, reps_equal=equal, planted_rep=int(out[128]),
        merged_rows=int((out != torch.arange(out.numel(), dtype=out.dtype)).sum()), card=card)
    assert equal, "entry() differs between the card and the CPU"
    assert int(out[128]) == 0, "entry(): the planted copy is not resolved"
    assert launches["minhash_sig"] == 1 and sum(launches.values()) == 1, launches


def cli_run(argv: list[str]) -> dict:
    """``cli.main(argv)`` with its standard output kept, the launch
    counters set to 0 just before and read just after."""
    import contextlib
    import io

    from advanced_scrapper_tpu_torch import cli

    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return {"rc": rc, "seconds": time.perf_counter() - t0, "launches": read_launches(),
            "stdout": buf.getvalue()}


def cli_path(card: str) -> None:
    """The port's CLI through ``cli.main`` on the card and with ``--device
    cpu``: ``dedup`` over 2,048 near-dup-heavy lines (the whole corpus,
    and ``--stream``), ``xdedup`` over two CSVs and a sqlite store of
    1,024 rows each, and ``match --workers 1`` over 256 articles of the
    S&P entity set (its knobs from ``ASTPU_MATCH_*``).  Each output equal,
    byte for byte; each card run launched its kernels."""
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    rng = np.random.RandomState(31)
    lines = [d.replace(b"\n", b" ").replace(b"\r", b" ").decode("utf-8", "replace")
             for d in rerank_corpus(rng, CLI_LINES)]
    corpus = os.path.join(root, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    report: dict = {}
    for mode, extra, kernel in (("dedup", [], "minhash_fold_segments"),
                                ("dedup_stream", ["--stream"], "minhash_fold_segments")):
        runs, outs = {}, {}
        for device in ("cuda", "cpu"):
            path = os.path.join(root, f"{mode}_{device}.txt")
            runs[device] = cli_run(["--device", device, "dedup", corpus, *extra, "-o", path])
            with open(path, "rb") as fh:
                outs[device] = fh.read()
        report[mode] = {"rc": [r["rc"] for r in runs.values()],
                        "seconds": {d: r["seconds"] for d, r in runs.items()},
                        "launches": runs["cuda"]["launches"], "kept": outs["cuda"].count(b"\n"),
                        "equal": outs["cuda"] == outs["cpu"]}
        assert report[mode]["rc"] == [0, 0] and report[mode]["equal"], (mode, report[mode])
        assert runs["cuda"]["launches"][kernel] > 0, (mode, runs["cuda"]["launches"])
        assert 0 < report[mode]["kept"] < CLI_LINES

    docs = rerank_corpus(rng, 3 * CLI_SOURCE_ROWS)
    parts = [[(f"https://x/{k}/{i}", d.decode("utf-8", "replace"))
              for i, d in enumerate(docs[k * CLI_SOURCE_ROWS:(k + 1) * CLI_SOURCE_ROWS])]
             for k in range(3)]
    sources = write_sources(root, parts)
    runs, outs = {}, {}
    for device in ("cuda", "cpu"):
        path = os.path.join(root, f"xdedup_{device}.csv")
        runs[device] = cli_run(["--device", device, "xdedup", *sources, "-o", path])
        with open(path, "rb") as fh:
            outs[device] = fh.read()
    report["xdedup"] = {"rc": [r["rc"] for r in runs.values()],
                        "seconds": {d: r["seconds"] for d, r in runs.items()},
                        "launches": runs["cuda"]["launches"],
                        "stats": json.loads(runs["cuda"]["stdout"]),
                        "equal": outs["cuda"] == outs["cpu"]
                        and runs["cuda"]["stdout"] == runs["cpu"]["stdout"]}
    assert report["xdedup"]["rc"] == [0, 0] and report["xdedup"]["equal"], report["xdedup"]
    assert runs["cuda"]["launches"]["minhash_fold_segments"] > 0, runs["cuda"]["launches"]

    entities = sp500_entities(np.random.RandomState(17))
    records, _planted = sp500_articles(rng, entities, MATCH_SUBSET)
    info, articles = write_matcher_inputs(os.path.join(root, "match"), entities, records)
    knobs = {"ASTPU_MATCH_INFO_DIR": info, "ASTPU_MATCH_ARTICLES_CSV": articles}
    saved = {k: os.environ.get(k) for k in (*knobs, "ASTPU_MATCH_SOURCE_NAME")}
    runs, trees = {}, {}
    try:
        os.environ.update(knobs)
        for device in ("cuda", "cpu"):
            source = os.path.join(root, f"match_{device}")
            os.environ["ASTPU_MATCH_SOURCE_NAME"] = source
            runs[device] = cli_run(["--device", device, "match", "--workers", "1"])
            trees[device] = tree_bytes(source + "_ticker_matched_articles")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    report["match"] = {"rc": [r["rc"] for r in runs.values()],
                       "seconds": {d: r["seconds"] for d, r in runs.items()},
                       "launches": runs["cuda"]["launches"], "files": len(trees["cuda"]),
                       "equal": trees["cuda"] == trees["cpu"]}
    assert report["match"]["rc"] == [0, 0] and report["match"]["equal"], report["match"]
    assert trees["cuda"] and runs["cuda"]["launches"]["match_screen"] > 0, report["match"]
    log("cli_path", lines=CLI_LINES, source_rows=CLI_SOURCE_ROWS, articles=MATCH_SUBSET,
        **report, card=card)
    tmp.cleanup()


def legacy_batches(records, index, dev) -> tuple[int, list]:
    """The legacy screen's batches of ``MATCH_SCREEN_BATCH`` rows over the
    chunk, found from the packed screen's masks: how many hold a mask, and
    the refine pairs (``_refine_pairs``) of each one that has some."""
    from advanced_scrapper_tpu_torch.pipeline.matcher import _get_col, _refine_pairs, screen_chunk

    rows = [(_get_col(r, "article_text", "article"), _get_col(r, "title"), None, r)
            for r in records]
    masks, _p = screen_chunk(rows, index, use_refine=False, threshold=95.0,
                             screen_block=1 << 16, device=dev)
    screened, batches = 0, []
    for start in range(0, len(rows), MATCH_SCREEN_BATCH):
        got = masks[start:start + MATCH_SCREEN_BATCH]
        screened += any(m is not None for m in got)
        pairs = _refine_pairs(rows[start:start + MATCH_SCREEN_BATCH], got, index)
        if pairs is not None:
            batches.append(pairs)
    return screened, batches


def pair_inputs(batches, dev) -> tuple[list[tuple], dict]:
    """Each legacy batch's ``myers_pairs`` arguments on the card after the
    masks (texts, offsets, lengths, each pair's text and pattern), and
    what they hold: ``steps`` (live bytes over every tile of every pair),
    ``bytes`` (texts, indices and masks read once, distances written),
    ``pairs``, and each launch's longest live tile (``longest``)."""
    inputs, steps, moved, n_pairs, longest = [], 0, 0, 0, []
    for _row, pair_text, ks, tok, lens in batches:
        L = tok.shape[1]
        inputs.append((torch.from_numpy(tok.reshape(-1)).to(dev),
                       torch.arange(tok.shape[0], dtype=torch.int64, device=dev) * L,
                       torch.from_numpy(lens).to(dev), torch.from_numpy(pair_text).to(dev),
                       torch.from_numpy(ks.astype(np.int32)).to(dev)))
        tl = lens.astype(np.int64)[pair_text]
        for start in range(0, int(tl.max()), 512):
            steps += int(np.clip(tl - start, 0, 543).sum())
        longest.append(min(int(tl.max()), 543))
        moved += int(lens.sum()) + 12 * tok.shape[0] + 8 * ks.size + 1028 * np.unique(ks).size
        moved += 4 * ks.size  # the distances written
        n_pairs += ks.size
    return inputs, {"steps": steps, "bytes": moved, "pairs": n_pairs, "longest": longest}


def joined_pairs(inputs: list[tuple]) -> tuple:
    """The batches' ``myers_pairs`` arguments (:func:`pair_inputs`, after
    the masks) joined into one call's: the same pairs over the texts laid
    one after another."""
    base = np.cumsum([0] + [b[0].numel() for b in inputs[:-1]])
    first = np.cumsum([0] + [b[2].numel() for b in inputs[:-1]])
    return (torch.cat([b[0] for b in inputs]),
            torch.cat([b[1] + int(o) for b, o in zip(inputs, base)]),
            torch.cat([b[2] for b in inputs]),
            torch.cat([b[3] + int(f) for b, f in zip(inputs, first)]),
            torch.cat([b[4] for b in inputs]))


def matcher_legacy(records, index, pool, packed_matches, info, entities, tmp: str,
                   clock_mhz: float, card: str) -> dict:
    """The legacy screen (``packed=False``) over the S&P chunk, screen-only
    and with the refine forced, on the card with the verify pool: its
    matches equal the packed screen's; one ``match_screen`` launch a
    batch of 128 rows and, forced, one ``myers_pairs`` launch a batch that
    has pairs (the pairs found independently from the packed screen's
    masks, by ``_refine_pairs``); card and CPU write byte-equal CSV trees
    on 256 articles (64 with the refine forced).  Then ``myers_pairs`` on
    the chunk's batches, timed by the profiler (device ms per recorded
    launch), beside its plain version on the card (every batch's pairs in
    one call, per launch), its bounds (14 INT32 operations a live
    pair-step; the text, indices and masks moved once), the launch floor
    (a one-element fill in the same profiler window) and the chain floor
    (:func:`chain_floor_ms`, the step of a lone chain from one pair on a
    543-byte and on a 1-byte text timed in the same call), all per launch:
    the mean over the chunk's batches; with the SASS instructions a step
    of its window loop.  Returns the ``kernels`` line's row."""
    from advanced_scrapper_tpu_torch.config import MatchConfig
    from advanced_scrapper_tpu_torch.ops import _build, editdist_cuda
    from advanced_scrapper_tpu_torch.ops.editdist import semiglobal_dist_plain
    from advanced_scrapper_tpu_torch.ops.sass import pairs_sass
    from advanced_scrapper_tpu_torch.pipeline.matcher import match_chunk_async, run_matcher

    dev = torch.device("cuda")
    want_e, batches = legacy_batches(records, index, dev)
    want_f = len(batches)

    modes = {}
    for mode, refine in (("screen_only", False), ("forced_refine", True)):
        reset_launches()
        t0 = time.perf_counter()
        collect = match_chunk_async(records, index, pool=pool, use_refine=refine, packed=False,
                                    screen_batch=MATCH_SCREEN_BATCH)
        t1 = time.perf_counter()
        res = collect()
        t2 = time.perf_counter()
        launches = read_launches()
        equal = norm_matches(res) == packed_matches
        modes[mode] = {"seconds": t2 - t0, "screen_s": t1 - t0, "verify_s": t2 - t1,
                       "articles_per_s": len(records) / (t2 - t0), "matches": len(res),
                       "launches": launches, "equal_to_packed": equal}
        assert equal, f"the legacy screen ({mode}) changed the matches"
        assert launches["match_screen"] == want_e and launches["myers_bound"] == 0, launches
        assert launches["myers_pairs"] == (want_f if refine else 0), (launches, want_f)
    assert want_f > 0, "no batch of the chunk has a refine pair"

    # card vs CPU: CSV trees on 256 articles, 64 with the refine forced
    sub_dir = os.path.join(tmp, "legacy_subset")
    same = []
    for n, refine in ((MATCH_SUBSET, "auto"), (MATCH_REFINE_SUBSET, True)):
        _info, sub_csv = write_matcher_inputs(os.path.join(sub_dir, str(n)), entities,
                                              records[:n])
        trees = []
        for dev_name in ("cuda", "cpu"):
            c = MatchConfig(source_name=os.path.join(sub_dir, str(n), dev_name), info_dir=info,
                            verify_workers=1, packed=False)
            assert run_matcher(c, articles_csv=sub_csv, use_refine=refine, device=dev_name) == 0
            trees.append(tree_bytes(c.source_name + c.out_dir_suffix))
        same.append(trees[0] == trees[1] and len(trees[0]) > 0)
    assert all(same), "card and CPU legacy matchers disagree"

    # myers_pairs on the chunk's batches
    _screen_t, (pmasks, plens, _ok, _cols) = index.device_tables(dev)
    inputs, work = pair_inputs(batches, dev)
    steps, moved, n_pairs, longest = (work[k] for k in ("steps", "bytes", "pairs", "longest"))
    outs: list = []

    def run_pairs():
        outs[:] = [editdist_cuda.myers_pairs(pmasks, plens, *b) for b in inputs]

    one = torch.empty((1,), dtype=torch.int32, device=dev)

    def with_fill():
        run_pairs()
        one.fill_(0)

    run_pairs()
    event_ms = cuda_ms(run_pairs, 3) / len(inputs)
    seen = profiler_device_ms(with_fill, ("pairs_kernel", "FillFunctor"))
    ms, recorded = per_launch_ms(seen, "pairs_kernel")
    floor_ms, _n = per_launch_ms(seen, "FillFunctor")
    assert floor_ms > 0, f"the profiler saw no fill, only {sorted(seen)}"
    ms_from = "profiler" if recorded else "events"
    ms = ms or event_ms
    # a lone chain: one pair on a 543-byte and on a 1-byte text, in the same call
    lone = {}
    for n in (LONE_STEPS, 1):
        args = (torch.randint(97, 123, (n,), dtype=torch.uint8, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.full((1,), n, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
        lone[n], = profiled_ms(lambda: editdist_cuda.myers_pairs(pmasks, plens, *args),
                               "pairs_kernel", reps=20)
    step_ms = lone_step_ms(lone[LONE_STEPS], lone[1], pairs_constant("kWindow"))
    chain_ms = chain_floor_ms(longest, step_ms, floor_ms)
    # the plain version on every batch's pairs at once: the same work
    joined = joined_pairs(inputs)
    plain: list = []
    plain_ms = cuda_ms(lambda: plain.append(
        semiglobal_dist_plain(pmasks, plens, *joined, pairs_per_batch=1 << 16))) / len(inputs)
    assert torch.equal(torch.cat(outs), plain[0]), "myers_pairs differs from plain on the chunk"
    ops_ms, bytes_ms = bound_ms(14 * steps, moved, clock_mhz)
    ops_ms, bytes_ms = ops_ms / len(inputs), bytes_ms / len(inputs)
    row = dict(name="myers_pairs", batches=len(inputs), pairs=n_pairs, pair_steps=steps,
               int_ops=14 * steps, bytes=moved, ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
               ms=ms, ms_from=ms_from, event_ms=event_ms, plain_ms=plain_ms,
               share_of_bound=max(ops_ms, bytes_ms) / ms, profiler_launches=recorded,
               launch_floor_ms=floor_ms, lone_ms=lone[LONE_STEPS], lone_1_byte_ms=lone[1],
               lone_step_ns=step_ms * 1e6, longest_steps_mean=float(np.mean(longest)),
               chain_floor_ms=chain_ms, share_of_floor=max(ops_ms, bytes_ms, chain_ms) / ms,
               sass=pairs_sass(_build.library_path("editdist")),
               per="launch (the mean over the chunk's batches)")
    log("kernel_timing", **row, clock_max_sm_mhz=clock_mhz, card=card)
    log("matcher_legacy", articles=len(records), screen_batch=MATCH_SCREEN_BATCH,
        batches_screened=want_e, batches_with_pairs=want_f, modes=modes,
        card_vs_cpu_trees_equal=same, card=card)
    return dict(row, launches=modes["forced_refine"]["launches"]["myers_pairs"])


def check_match_vs_plain(dev) -> dict:
    """Phase 3, the matcher: ``match_screen`` bit-equal to ``screen_plain``
    and ``myers_bound`` bit-equal to ``myers_bound_plain`` (the mask bits)
    and to ``semiglobal_dist_shared_plain`` (every pair's distance) on the
    rows and names of :func:`match_edge_case`, at thresholds 95, 90, 80,
    97.5 and 50, over two chunks into one set of name tables (300 and 257
    rows: neither a multiple of the screen's rows a block), from a text
    that starts off a 16-byte boundary; the screen also at N = 1 and 33."""
    from advanced_scrapper_tpu_torch.ops import editdist_cuda, match_cuda
    from advanced_scrapper_tpu_torch.ops.editdist import (
        build_pattern_masks,
        myers_bound_plain,
        semiglobal_dist_shared_plain,
    )
    from advanced_scrapper_tpu_torch.ops.match import (
        prepare_names,
        screen_frac,
        screen_plain,
        screen_tensors,
    )

    rng = np.random.RandomState(21)
    names, fuzzy, pats, cols, *_ = match_edge_case(rng, 0)
    tables = screen_tensors(prepare_names(names, fuzzy=fuzzy), dev)
    masks, plens, ok = build_pattern_masks(pats)
    pm = (torch.from_numpy(masks.view(np.int32)).to(dev).view(torch.uint32),
          torch.from_numpy(plens).to(dev), torch.from_numpy(ok).to(dev),
          torch.from_numpy(cols).to(dev))
    before = (match_cuda.match_screen.launches, editdist_cuda.myers_bound.launches)
    cases = survivors = pruned = 0
    for chunk, n_rows in enumerate((300, 257)):
        _n, _f, _p, _c, rows, tl, ttl, fl = match_edge_case(rng, n_rows)
        text, off, lens = flat_text(rows, lead=3)
        full = torch.from_numpy(np.r_[np.zeros(5, np.uint8), text]).to(dev)
        text_d = full[5:]  # starts off a 16-byte boundary
        assert text_d.data_ptr() % 16 != 0
        ra = [torch.from_numpy(x).to(dev) for x in
              (off, lens.astype(np.int32), tl, ttl, fl)]
        off_d, len_d, tl_d, ttl_d, fl_d = ra
        for t in (95.0, 90.0, 80.0, 97.5, 50.0):
            got = match_cuda.match_screen(text_d, off_d, len_d, tl_d, ttl_d, tables,
                                          screen_frac(t))
            want = screen_plain(text_d, off_d, len_d, tl_d, ttl_d, tables, t).to(torch.uint8)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"match_screen differs from plain at t={t}"
            plain_mask = want.clone()
            editdist_cuda.myers_bound(text_d, off_d, len_d, tl_d, fl_d, *pm, t, got)
            myers_bound_plain(text_d, off_d, len_d, tl_d, fl_d, *pm, t, plain_mask)
            torch.cuda.synchronize()
            assert torch.equal(got, plain_mask), f"myers_bound differs from plain at t={t}"
            survivors += int((got & 1).sum())
            pruned += int((got >> 1).sum())
            cases += 1
        for few in (1, 33):  # N = 1, and N one past a warp's names
            sub_t = screen_tensors(prepare_names(names[-few:], fuzzy=fuzzy[-few:]), dev)
            got = match_cuda.match_screen(text_d, off_d, len_d, tl_d, ttl_d, sub_t,
                                          screen_frac(90.0))
            want = screen_plain(text_d, off_d, len_d, tl_d, ttl_d, sub_t, 90.0).to(torch.uint8)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"match_screen differs from plain at N={few}"
            cases += 1
        dist = torch.empty((len(rows), len(pats)), dtype=torch.int32, device=dev)
        scratch = torch.zeros((len(rows), len(names)), dtype=torch.uint8, device=dev)
        editdist_cuda.myers_bound(text_d, off_d, len_d, tl_d, fl_d, *pm, 95.0, scratch,
                                  dist=dist)
        width = int(lens.max())
        padded = np.zeros((len(rows), width), np.uint8)
        for i, r in enumerate(rows):
            padded[i, :len(r)] = np.frombuffer(r, np.uint8)
        want_d = torch.cat([semiglobal_dist_shared_plain(
            pm[0], pm[1], torch.from_numpy(padded[r0:r0 + 32]).to(dev), len_d[r0:r0 + 32])
            for r0 in range(0, len(rows), 32)])
        torch.cuda.synchronize()
        assert torch.equal(dist, want_d), "myers_bound distances differ from plain"
        cases += 1
    cases += check_myers_edges(dev)
    launches = (match_cuda.match_screen.launches - before[0],
                editdist_cuda.myers_bound.launches - before[1])
    assert launches == (14, 18), launches
    assert survivors and pruned, (survivors, pruned)
    return {"cases": cases, "names": len(names), "patterns": len(pats),
            "survivor_bits": survivors, "prune_bits": pruned, "max_abs_err": 0}


MATCH_TICKERS = 500      # S&P 500 (DESIGN.md: 500 tickers, ~4,700 names)
MATCH_ARTICLES = 20000   # one chunk at MatchConfig.chunk_size
MATCH_SUBSET = 256       # card vs CPU
MATCH_REFINE_SUBSET = 64  # card vs CPU with the bound forced (the CPU's plain bound is slow)
MATCH_SCREEN_BATCH = 128  # the legacy screen's rows a batch (match_chunk's default)
CLI_LINES = 2048          # the CLI's dedup corpus, lines
CLI_SOURCE_ROWS = 1024    # the CLI's xdedup sources, rows each


def letters(rng: np.random.RandomState, lo: int, hi: int) -> str:
    """A word of ``lo``-``hi`` random lowercase letters (as the matcher's
    tests make filler: diverse grams, so the screen has work to do)."""
    return "".join(chr(97 + c) for c in rng.randint(0, 26, size=rng.randint(lo, hi + 1)))


def sp500_entities(rng: np.random.RandomState) -> list[dict]:
    """500 US companies in the info-JSON schema, ~9.4 names each: an
    ALL-CAPS ticker of 2-5 letters (exact path), a label, aliases,
    products (some pure lowercase: skipped), subsidiaries (some over 98
    bytes: truncated grams; some over 32: no bound), CEOs and board
    members; ~2% of names non-ASCII; CEO windows ``(Start:)`` /
    ``(End:)`` that some article dates fall outside."""
    tickers: set[str] = set()
    while len(tickers) < MATCH_TICKERS:
        tickers.add("".join(chr(65 + c) for c in rng.randint(0, 26, size=rng.randint(2, 6))))

    def word() -> str:
        w = letters(rng, 3, 9).capitalize()
        return w.replace("e", "é", 1) if rng.rand() < 0.02 else w

    def person() -> str:
        return f"{word()} {word()}"

    out = []
    for t in sorted(tickers):
        name = f"{word()} {word()}"
        subs = []
        for _ in range(rng.randint(0, 3)):
            if rng.rand() < 0.1:
                subs.append(" ".join(word() for _ in range(16)) + " Holdings Limited")
            elif rng.rand() < 0.3:
                subs.append(f"{word()} {word()} {word()} International (Start: 2012-03-01T00:00:00Z)")
            else:
                subs.append(f"{word()} {word()}")
        products = [f"{word()} {rng.choice(['Pro', 'Max', 'One', 'Cloud'])} {rng.randint(2, 9)}"
                    for _ in range(rng.randint(1, 3))]
        if rng.rand() < 0.2:
            products.append(letters(rng, 5, 9))  # pure lowercase: never a name
        ceos = [f"{person()} (Start: 2{rng.randint(10, 20):03d}-0{rng.randint(1, 9)}-15T00:00:00Z)"]
        if rng.rand() < 0.5:
            ceos.append(f"{person()} (Start: 1998-01-01T00:00:00Z) (End: 2009-06-30T00:00:00Z)")
        out.append({
            "id_label": f"{name} {rng.choice(['Inc.', 'Corp.', 'Group', 'Co.', 'Holdings'])}",
            "ticker": t,
            "country": ["United States"],
            "industry": ["technology"],
            "aliases": [name] + ([t.lower().capitalize() + " Co"] if rng.rand() < 0.5 else []),
            "products": products,
            "subsidiaries": subs,
            "owned_entities": [],
            "ceos": ceos,
            "board_members": [person() for _ in range(rng.randint(1, 3))],
        })
    return out


def sp500_articles(rng: np.random.RandomState, entities: list[dict], n: int):
    """``(records, planted)``: ``n`` articles (text 1-3 kB of word-like
    filler, titles of 40-120 bytes, dates in 2021-2023) with 15% planted
    mentions (exact, or with 1-2 byte edits), 10% decoys (a fuzzy name's
    two halves apart: every gram present, no close substring), ~3%
    non-ASCII texts and 4 articles over 65,536 bytes.  ``planted`` maps an
    article to the tickers of its exact mentions that must match (names
    whose window holds the article's date)."""
    vocab = [letters(rng, 2, 9) for _ in range(3000)]
    from advanced_scrapper_tpu_torch.pipeline.matcher import extract_time_periods

    names = []  # (ticker, name, must-match in 2021-2023)
    for e in entities:
        for attr in ("ticker", "id_label", "aliases", "products", "subsidiaries", "ceos",
                     "board_members"):
            for nm, (start, end) in extract_time_periods(e[attr]).items():
                if nm and not (nm.islower() and nm.replace(" ", "").isalpha()):
                    names.append((e["ticker"], nm, end is None))
    fuzzy = [x for x in names if not x[1].isupper() and len(x[1]) >= 8]
    records, planted = [], {}
    for i in range(n):
        overlong = i in (n // 8, 3 * n // 8, 5 * n // 8, 7 * n // 8)  # apart: one per slice
        size = rng.randint(66000, 70000) if overlong else rng.randint(1000, 3000)
        words = [vocab[w] for w in rng.randint(0, len(vocab), size=size // 6)]
        title = " ".join(vocab[w] for w in rng.randint(0, len(vocab), size=20))
        title = title[: rng.randint(40, 121)].capitalize()
        u = rng.rand()
        if u < 0.15 or overlong:
            for _ in range(rng.randint(1, 4)):
                ticker, nm, must = names[rng.randint(len(names))]
                if rng.rand() < 0.3 and not nm.isupper():
                    nm = edit_bytes(rng, nm.encode(), rng.randint(1, 3)).decode("utf-8", "replace")
                elif must:
                    planted.setdefault(i, set()).add(ticker)
                words.insert(rng.randint(len(words)), nm)
        elif u < 0.25:
            _ticker, nm, _must = fuzzy[rng.randint(len(fuzzy))]
            h = len(nm) // 2
            words.insert(rng.randint(len(words)), nm[: h + 2])
            words.insert(0, nm[h - 1:])
        text = " ".join(words)
        if rng.rand() < 0.03:  # a word of its own: inside a planted name it would break it
            text = "café “Zürich” " + text
        day = f"202{rng.randint(1, 4)}-{rng.randint(1, 13):02d}-{rng.randint(1, 29):02d}"
        records.append({
            "article_text": text, "title": title,
            "date_time": f"{day}T{rng.randint(0, 24):02d}:{rng.randint(0, 60):02d}:00Z"
            if i % 50 else day,
            "url": f"https://news.example/{i}.html", "source": "yahoo",
            "source_url": "https://news.example",
        })
    return records, planted


def write_matcher_inputs(root: str, entities: list[dict], records: list[dict]) -> tuple[str, str]:
    """An info directory (10 companies per JSON file) and an articles CSV
    under ``root``; returns their paths."""
    import csv

    info = os.path.join(root, "info")
    os.makedirs(info, exist_ok=True)
    for k in range(0, len(entities), 10):
        with open(os.path.join(info, f"part{k // 10:03d}.json"), "w", encoding="utf-8") as f:
            json.dump(entities[k : k + 10], f, ensure_ascii=False)
    path = os.path.join(root, "articles.csv")
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(list(records[0]))
        w.writerows([list(r.values()) for r in records])
    return info, path


def norm_matches(res) -> list:
    """``tests/test_match_dispatch.py``'s ``_norm``: sorted (ticker,
    matches as sorted JSON, url)."""
    return sorted((t, json.dumps(m, sort_keys=True), r["url"]) for t, m, r in res)


def tree_bytes(path: str) -> dict[str, bytes]:
    out = {}
    for f in sorted(os.listdir(path)):
        with open(os.path.join(path, f), "rb") as fh:
            out[f] = fh.read()
    return out


def timed_chunk(records, index, pool, **kw) -> tuple[list, dict]:
    """``match_chunk`` on the card with the launch counters set to 0 just
    before and read just after: ``(results, record)`` with the screen's
    and the verify's host seconds, the screen's stage times and the
    launches."""
    from advanced_scrapper_tpu_torch.pipeline.matcher import match_chunk_async

    reset_launches()
    t0 = time.perf_counter()
    collect = match_chunk_async(records, index, pool=pool, **kw)
    t1 = time.perf_counter()
    res = collect()
    t2 = time.perf_counter()
    clock = index.last_screen_clock
    return res, {"seconds": t2 - t0, "screen_s": t1 - t0, "verify_s": t2 - t1,
                 "articles_per_s": len(records) / (t2 - t0), "matches": len(res),
                 "launches": read_launches(), "screen_host_s": dict(clock.seconds),
                 "screen_device_ms": clock.device_ms()}


def matcher_kernel_timing(index, records, clock_mhz: float) -> list[dict]:
    """Kernels E and F on the chunk's own buffer (``join_rows``), timed by
    the profiler (``ms``: device ms per recorded launch over 5 calls, as the
    other kernels of the ``kernels`` line are; ``profiler_launches``, the
    launches it recorded) and with CUDA events over 5 calls after a warm
    one, as the host makes them (``event_ms``; E also queued behind a spin
    of the card, so that its ~0.2 ms launches run back to back,
    ``queued_ms``), beside their plain versions on the card (one call), and
    held bit-equal to them.  Where the profiler saw no launch of a kernel in
    3 windows, ``ms`` is its event time and ``ms_from`` says so.
    F ORs into one mask call after call (the same bits).  Bounds from this
    data: E moves the text and row arrays once, the name tables once and
    one mask byte per pair, and does ~16 operations per window, ~4 per
    (row, kept gram) probe and ~16 per pair; F does 14 INT32 operations
    per live byte of each tile for each computed pair (ok, text longer
    than the pattern, ASCII text; the operations are listed in
    ``csrc/editdist.cu``'s header) and moves the text, row arrays, pattern
    masks and one mask byte per (row, pattern).  F's row also gives the
    SASS instructions of one step by pipe and the floor each pipe sets
    (:func:`myers_sass`).  E's row gives its rows a block and the SASS of
    its probe loop and its mask write-out (``ops/sass.py:screen_sass``),
    and the bound restated from them: 16 operations a window as counted
    (what the hash needs: FNV-1a's 3 XOR and 3 multiplies, fmix32's 3
    shifts, 3 XOR and 2 multiplies, the mask and the OR), the probe loop's
    ALU and FMA instructions per (row, gram), and per pair the SWAR compare
    (5 operations a register of four rows' byte counters: 1.25) plus the
    write-out loop's ALU and FMA instructions per byte stored."""
    from advanced_scrapper_tpu_torch.ops import _build, editdist_cuda, match_cuda
    from advanced_scrapper_tpu_torch.ops.editdist import myers_bound_plain
    from advanced_scrapper_tpu_torch.ops.match import screen_frac, screen_plain
    from advanced_scrapper_tpu_torch.ops.sass import screen_sass
    from advanced_scrapper_tpu_torch.pipeline.matcher import join_rows

    dev = torch.device("cuda")
    rows = [(r["article_text"], r["title"], None, r) for r in records]
    eligible, text, off, ln, tl, ttl, fl = join_rows(rows, 1 << 16, dev)
    screen_t, (masks, plens, ok, cols) = index.device_tables(dev)
    R, N, K = eligible.size, screen_t["kept"].numel(), plens.numel()
    frac = screen_frac(95.0)
    out: dict = {}

    def run_e():
        out["e"] = match_cuda.match_screen(text, off, ln, tl, ttl, screen_t, frac)

    def run_f():
        editdist_cuda.myers_bound(text, off, ln, tl, fl, masks, plens, ok, cols, 95.0, out["f"])

    run_e()
    out["f"] = out["e"].clone()
    run_f()
    e_event_ms = cuda_ms(run_e, 5)
    e_queued_ms = cuda_ms(run_e, 5, queued=True)
    f_clock_before = nvidia_smi("clocks.sm")
    f_event_ms = cuda_ms(run_f, 5)
    f_clock_after = nvidia_smi("clocks.sm")
    seen = profiler_device_ms(lambda: (run_e(), run_f()), ("screen_kernel", "bound_kernel"))
    prof = {name: per_launch_ms(seen, kernel)
            for name, kernel in (("e", "screen_kernel"), ("f", "bound_kernel"))}
    saw = None if all(n for _ms, n in prof.values()) else sorted(seen)
    e_ms = prof["e"][0] or e_event_ms
    f_ms = prof["f"][0] or f_event_ms
    plain = {}
    e_plain_ms = cuda_ms(lambda: plain.update(e=screen_plain(text, off, ln, tl, ttl, screen_t,
                                                             95.0).to(torch.uint8)))
    f_plain_ms = cuda_ms(lambda: plain.update(f=myers_bound_plain(
        text, off, ln, tl, fl, masks, plens, ok, cols, 95.0, plain["e"].clone(),
        rows_per_batch=2048)))
    torch.cuda.synchronize()
    assert torch.equal(out["e"], plain["e"]), "match_screen differs from plain on the chunk"
    assert torch.equal(out["f"], plain["f"]), "myers_bound differs from plain on the chunk"

    lens = ln.cpu().numpy().astype(np.int64)
    kept = screen_t["kept"].cpu().numpy().astype(np.int64)
    windows = int(np.maximum(lens - 2, 0).sum())
    e_ops = 16 * windows + 4 * R * int(kept.sum()) + 16 * R * N
    table_bytes = sum(screen_t[k].numel() * screen_t[k].element_size() for k in match_cuda.TABLES)
    e_bytes = int(lens.sum()) + 20 * R + table_bytes + R * N
    e_ops_ms, e_bytes_ms = bound_ms(e_ops, e_bytes, clock_mhz)
    e_sass = screen_sass(_build.library_path("match"))
    e_restated_ops = None
    if "work_per_row_gram" in e_sass:
        per_pair = SWAR_COMPARE_PER_PAIR + e_sass["write_work_per_pair"]
        e_restated_ops = (16 * windows + min(e_sass["work_per_row_gram"], 4) * R * int(kept.sum())
                          + min(per_pair, 16) * R * N)
    e_bound_ms = max(bound_ms(e_restated_ops or e_ops, e_bytes, clock_mhz))
    # F: live bytes of each row's tiles, over the pairs the gates keep
    steps = np.zeros(R, np.int64)
    for start in range(0, int(lens.max()) if R else 0, 512):
        steps += np.clip(lens - start, 0, 543)
    flags = fl.cpu().numpy() & 1
    pl = plens.cpu().numpy()
    okk = ok.cpu().numpy()
    text_len = tl.cpu().numpy()
    pairs_per_row = ((text_len[:, None] > pl[None, :]) & okk[None, :]).sum(axis=1) * flags
    f_steps = int((steps * pairs_per_row).sum())
    f_ops = 14 * f_steps
    f_bytes = int(lens.sum()) + 20 * R + K * 1024 + 16 * K + R * K
    f_ops_ms, f_bytes_ms = bound_ms(f_ops, f_bytes, clock_mhz)
    survivors = int((out["e"] & 1).sum())
    pruned = int((out["f"] == 3).sum())
    return [
        dict(name="match_screen", rows=R, names=N, windows=windows, probes=R * int(kept.sum()),
             int_ops=e_ops, bytes=e_bytes, ops_bound_ms=e_ops_ms, bytes_bound_ms=e_bytes_ms,
             ms=e_ms, ms_from="profiler" if prof["e"][1] else "events", event_ms=e_event_ms,
             queued_ms=e_queued_ms, plain_ms=e_plain_ms,
             share_of_bound=max(e_ops_ms, e_bytes_ms) / e_ms, survivor_pairs=survivors,
             profiler_launches=prof["e"][1], profiler_saw=saw, rows_per_block=match_cuda.rows_per_block(), sass=e_sass,
             restated_int_ops=e_restated_ops,
             restated_ops_bound_ms=None if e_restated_ops is None
             else bound_ms(e_restated_ops, e_bytes, clock_mhz)[0],
             restated_share_of_bound=e_bound_ms / e_ms, bound_ms=e_bound_ms),
        dict(name="myers_bound", rows=R, patterns=K, pair_steps=f_steps,
             pairs=int(pairs_per_row.sum()), int_ops=f_ops, bytes=f_bytes,
             ops_bound_ms=f_ops_ms, bytes_bound_ms=f_bytes_ms, ms=f_ms,
             ms_from="profiler" if prof["f"][1] else "events", event_ms=f_event_ms,
             plain_ms=f_plain_ms, share_of_bound=max(f_ops_ms, f_bytes_ms) / f_ms,
             pruned_survivors=pruned, profiler_launches=prof["f"][1], profiler_saw=saw, chains=editdist_cuda.myers_chains(),
             clock_sm_before=f_clock_before, clock_sm_after=f_clock_after,
             sass=myers_sass(f_steps, clock_mhz)),
    ]


#: lane-operations per SM per clock of each Hopper pipe: the ALU and the FMA
#: pipe 64 each (4 partitions of 16 lanes), MIO's shared loads 32 (128 B of
#: shared memory a clock)
PIPE_LANES_PER_SM = {"alu": 64, "fma": 64, "mio": 32}

#: operations per (row, name) pair of the screen's SWAR compare: OR, subtract,
#: AND, shift and OR over a register that holds four rows' byte counters
SWAR_COMPARE_PER_PAIR = 5 / 4


def myers_sass(pair_steps: int, clock_mhz: float) -> dict:
    """Instructions per Myers step in the built ``myers_bound``'s step loop
    (``ops/sass.py:sass_step_counts``), by opcode and by pipe, with the
    floor in ms each pipe sets for ``pair_steps`` steps at ``clock_mhz``;
    or the reason there are none."""
    from advanced_scrapper_tpu_torch.ops import _build
    from advanced_scrapper_tpu_torch.ops.sass import sass_step_counts

    try:
        sass = sass_step_counts(_build.library_path("editdist"))
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        return {"error": str(e)[:300]}
    sass["pipe_floor_ms"] = pipe_floor_ms(sass["by_pipe_per_step"], pair_steps, clock_mhz)
    return sass


def pipe_floor_ms(by_pipe: dict[str, float], steps: int, clock_mhz: float) -> dict[str, float]:
    """The floor in ms each pipe sets for ``steps`` steps of ``by_pipe``
    instructions a step, at ``clock_mhz`` on the card's SMs."""
    return {pipe: steps * by_pipe.get(pipe, 0.0) / (lanes * CARD_SMS * clock_mhz * 1e6) * 1e3
            for pipe, lanes in PIPE_LANES_PER_SM.items()}


#: lane-instructions an SM issues a clock: four schedulers, a warp each
ISSUE_LANES_PER_SM = 128


def oph_fold_sass(shingles: int, clock_mhz: float, units: str = "SegmentUnits",
                  lib=None) -> dict:
    """Instructions per shingle in the hash loop of a built ``oph.cu``'s
    fold (k = 5, the mode of ``units``; ``ops/sass.py:oph_sass``; the
    shipped library unless ``lib``), by opcode and by pipe, with the floor
    in ms each pipe sets for ``shingles`` at ``clock_mhz`` and the issue
    floor (every instruction, ``ISSUE_LANES_PER_SM``); or the reason there
    are none."""
    from advanced_scrapper_tpu_torch.ops import _build
    from advanced_scrapper_tpu_torch.ops.sass import oph_sass

    sass = oph_sass(lib or _build.library_path("oph"), units)
    if "error" not in sass:
        sass["pipe_floor_ms"] = pipe_floor_ms(sass["by_pipe_per_step"], shingles, clock_mhz)
        sass["issue_floor_ms"] = shingles * sass["per_step"] / (
            ISSUE_LANES_PER_SM * CARD_SMS * clock_mhz * 1e6) * 1e3
    return sass


def matcher_path(clock_mhz: float, card: str) -> tuple[list, dict, dict]:
    """The matcher at S&P scale on the card (see the module docstring);
    returns the kernel-line rows of ``match_screen`` and ``myers_bound``,
    the launches counted on the path, and the legacy screen's
    ``myers_pairs`` row (:func:`matcher_legacy`)."""
    import tempfile

    from advanced_scrapper_tpu_torch.config import MatchConfig
    from advanced_scrapper_tpu_torch.cpu.csvframe import read_csv_records
    from advanced_scrapper_tpu_torch.pipeline.matcher import (
        EntityIndex,
        append_match,
        make_verify_pool,
        match_chunk,
        run_matcher,
        sort_matched_csv,
    )

    rng = np.random.RandomState(17)
    t0 = time.perf_counter()
    entities = sp500_entities(rng)
    records, planted = sp500_articles(rng, entities, MATCH_ARTICLES)
    tmp = tempfile.TemporaryDirectory()
    info, articles = write_matcher_inputs(tmp.name, entities, records)
    index = EntityIndex.from_info_dir(info)
    n_names = len(index.entries)
    gen_s = time.perf_counter() - t0
    # the kernels alone first, before the verify pool and the run's threads
    timing = matcher_kernel_timing(index, records, clock_mhz)
    for t in timing:
        log("kernel_timing", **t, clock_max_sm_mhz=clock_mhz, card=card)
    t0 = time.perf_counter()
    pool = make_verify_pool(index, 0)
    pool_s = time.perf_counter() - t0
    try:
        match_chunk(records[:512], index, pool=pool, use_refine=True)  # warm: tables, libraries
        _res, first = timed_chunk(records, index, pool, use_refine=False)  # first full-size call
        modes = {}
        for mode, refine in (("screen_only", False), ("forced_refine", True)):
            res, rec = timed_chunk(records, index, pool, use_refine=refine)
            assert rec["launches"]["match_screen"] == 1, rec["launches"]
            assert rec["launches"]["myers_bound"] == (1 if refine else 0), rec["launches"]
            found = {(t, int(r["url"].rsplit("/", 1)[1].split(".")[0])) for t, _m, r in res}
            missed = [(i, t) for i, ts in planted.items() for t in ts if (t, i) not in found]
            assert not missed, f"{len(missed)} planted mentions not found, first {missed[:5]}"
            modes[mode] = (norm_matches(res), rec, res)
        assert modes["screen_only"][0] == modes["forced_refine"][0], "refine changed the matches"
        matches = modes["screen_only"][0]
        for mode, (_n, rec, _res) in modes.items():
            log("matcher_path", mode=mode, articles=MATCH_ARTICLES, tickers=MATCH_TICKERS,
                names=n_names, planted_articles=len(planted), **rec,
                first_call_seconds=first["seconds"], pool_workers=os.cpu_count(),
                pool_start_s=pool_s, card=card)
        # CSV write and sort alone: the screen-only matches appended and sorted
        res = modes["screen_only"][2]
        out_dir = os.path.join(tmp.name, "write_only")
        os.makedirs(out_dir)
        t1 = time.perf_counter()
        written = sum(append_match(out_dir, t, m, r) for t, m, r in res)
        t2 = time.perf_counter()
        for f in os.listdir(out_dir):
            sort_matched_csv(os.path.join(out_dir, f))
        t3 = time.perf_counter()
        n_read = sum(len(c) for c in read_csv_records(articles, MATCH_ARTICLES))
        read_s = time.perf_counter() - t3
        assert n_read == MATCH_ARTICLES and written == len(res)
        legacy = matcher_legacy(records, index, pool, modes["screen_only"][0], info, entities,
                                tmp.name, clock_mhz, card)
    finally:
        if pool is not None:
            pool.shutdown()

    # run_matcher end to end: the "auto" race, the verify pool, the CSVs
    cfg = MatchConfig(source_name=os.path.join(tmp.name, "yahoo"), info_dir=info)
    reset_launches()
    t0 = time.perf_counter()
    assert run_matcher(cfg, articles_csv=articles) == 0
    run_s = time.perf_counter() - t0
    run_launches = read_launches()
    assert run_launches["match_screen"] == 1, run_launches
    trees = tree_bytes(cfg.source_name + cfg.out_dir_suffix)
    n_csv_rows = sum(len(read_csv_records_all(os.path.join(cfg.source_name + cfg.out_dir_suffix, f)))
                     for f in trees)
    assert n_csv_rows == len(matches), (n_csv_rows, len(matches))
    log("matcher_run", articles=MATCH_ARTICLES, seconds=run_s, articles_per_s=MATCH_ARTICLES / run_s,
        files=len(trees), csv_rows=n_csv_rows, launches=run_launches, csv_read_s=read_s,
        csv_write_s=t2 - t1, csv_sort_s=t3 - t2, generate_s=gen_s, card=card)

    # where the screen-only chunk's time goes, from the timed call's clock
    rec = modes["screen_only"][1]
    log("matcher_breakdown", mode="screen_only", host_s=rec["screen_host_s"],
        device_ms=rec["screen_device_ms"], verify_s=rec["verify_s"],
        refine_device_ms=modes["forced_refine"][1]["screen_device_ms"],
        refine_verify_s=modes["forced_refine"][1]["verify_s"], csv_write_s=t2 - t1,
        csv_sort_s=t3 - t2, card=card)

    # card vs CPU on a subset at the full entity set
    sub = records[:MATCH_SUBSET]
    cpu_index = EntityIndex.from_info_dir(info)
    t0 = time.perf_counter()
    same_screen = norm_matches(match_chunk(sub, index, use_refine=False)) == norm_matches(
        match_chunk(sub, cpu_index, use_refine=False, device="cpu"))
    few = records[:MATCH_REFINE_SUBSET]
    same_refine = norm_matches(match_chunk(few, index, use_refine=True)) == norm_matches(
        match_chunk(few, cpu_index, use_refine=True, device="cpu"))
    sub_dir = os.path.join(tmp.name, "subset")
    _info, sub_csv = write_matcher_inputs(sub_dir, entities, sub)
    trees = []
    for dev_name in ("cuda", "cpu"):
        c = MatchConfig(source_name=os.path.join(sub_dir, dev_name), info_dir=info,
                        verify_workers=1)
        assert run_matcher(c, articles_csv=sub_csv, device=dev_name) == 0
        trees.append(tree_bytes(c.source_name + c.out_dir_suffix))
    same_trees = trees[0] == trees[1] and len(trees[0]) > 0
    log("matcher_card_vs_cpu", articles=MATCH_SUBSET, refine_articles=MATCH_REFINE_SUBSET,
        screen_only_equal=same_screen, forced_refine_equal=same_refine,
        csv_trees_equal=same_trees, files=len(trees[0]), seconds=time.perf_counter() - t0)
    assert same_screen and same_refine and same_trees, "card and CPU matchers disagree"
    tmp.cleanup()
    launches = {"match_screen": modes["forced_refine"][1]["launches"]["match_screen"],
                "myers_bound": modes["forced_refine"][1]["launches"]["myers_bound"]}
    return timing, launches, legacy


def read_csv_records_all(path: str) -> list[dict]:
    from advanced_scrapper_tpu_torch.cpu.csvframe import read_csv_records

    return [r for chunk in read_csv_records(path, 1 << 30) for r in chunk]


def bound_ms(int_ops: int, moved: int, clock_mhz: float) -> tuple[float, float]:
    """(operations bound, bytes bound) in ms on one H100."""
    ops_ms = int_ops / (INT32_OPS_PER_SM * CARD_SMS * clock_mhz * 1e6) * 1e3
    return ops_ms, moved / HBM_BYTES_PER_S * 1e3


LONE_STEPS = 543  # the lone chain's text: one whole live tile


def lone_step_ms(lone_ms: float, lone_1_ms: float, window: int) -> float:
    """The time of one step of a lone ``myers_pairs`` chain: the slope
    between a launch of one pair on a ``LONE_STEPS``-byte text
    (``lone_ms``) and one on a 1-byte text (``lone_1_ms``), over the steps
    the first runs past the second.  A warp runs whole windows of
    ``window`` steps, so those are ``window * (ceil(LONE_STEPS / window) -
    1)``; what both launches share (the launch, the masks staged, the
    first window loaded) drops out."""
    return (lone_ms - lone_1_ms) / (window * (-(-LONE_STEPS // window) - 1))


def chain_floor_ms(longest: list[int], step_ms: float, launch_floor_ms: float) -> float:
    """``myers_pairs``' chain floor in ms a launch, the mean over launches:
    a launch's longest live tile (``longest``, steps) times ``step_ms``, the
    time of one step of a lone chain (:func:`lone_step_ms`), plus the
    launch floor."""
    return launch_floor_ms + step_ms * sum(longest) / len(longest)


#: tier stats that do not depend on the device (``launches`` and
#: ``h2d_bytes`` count the card's work)
TIER_KEYS = (
    "pairs", "borderline", "exact_checks", "reprobes", "evicted", "clusters",
    "dropped_cells", "predicted_precision", "capped_buckets", "overflow_pairs",
)


def launch_counters() -> dict:
    from advanced_scrapper_tpu_torch.ops import (
        editdist_cuda,
        match_cuda,
        minhash_cuda,
        oph_cuda,
        rerank_cuda,
    )

    return {f.__name__: f for f in (
        minhash_cuda.minhash_fold_segments, minhash_cuda.minhash_fold,
        minhash_cuda.minhash_sig, rerank_cuda.rerank_settle, match_cuda.match_screen,
        editdist_cuda.myers_bound, editdist_cuda.myers_pairs, oph_cuda.oph_fold_segments,
        oph_cuda.oph_fold, oph_cuda.oph_sig, oph_cuda.oph_densify)}


def reset_launches() -> None:
    for f in launch_counters().values():
        f.launches = 0


def read_launches() -> dict[str, int]:
    return {name: f.launches for name, f in launch_counters().items()}


def check_roots(reps: np.ndarray, n: int) -> None:
    idx = np.arange(n)
    assert reps.shape == (n,)
    assert (reps <= idx).all() and (reps >= 0).all(), "a representative after its row"
    assert (reps[reps] == reps).all(), "representatives are not roots"


def run_corpora(engine, warm: list[bytes], corpora: list[list[bytes]], settles: int) -> dict:
    """``engine.dedup_reps`` over ``corpora`` after ``warm``, the launch
    counters set to 0 just before each corpus and read just after: the
    segment kernel once per chunk, ``rerank_settle`` ``settles`` times per
    corpus, no tile-path launch.  Returns the host-clock seconds, the
    launches summed over the corpora and each corpus's own record, with
    the engine's and the tier's per-stage host seconds and device times
    (``last_clock``), read after the corpus."""
    engine.dedup_reps(warm)
    seconds = 0.0
    launches = dict.fromkeys(launch_counters(), 0)
    per = []
    for docs in corpora:
        reset_launches()
        t0 = time.perf_counter()
        reps = engine.dedup_reps(docs)
        s = time.perf_counter() - t0
        got = read_launches()
        check_roots(reps, len(docs))
        assert got["minhash_fold_segments"] == engine.last_chunks > 0, got
        assert got["rerank_settle"] == settles, got
        assert got["minhash_fold"] == got["minhash_sig"] == 0, got
        seconds += s
        launches = {k: launches[k] + v for k, v in got.items()}
        rec = {"seconds": s, "dups": int((reps != np.arange(len(docs))).sum()),
               "engine_seconds": dict(engine.last_clock.seconds),
               "engine_device_ms": engine.last_clock.device_ms()}
        if engine.rerank_tier is not None:
            tier = engine.rerank_tier
            rec.update(stats=dict(tier.stats), tier_seconds=dict(tier.last_clock.seconds),
                       tier_device_ms=tier.last_clock.device_ms())
        else:
            rec["exact_checks"] = engine.last_exact_checks
        per.append(rec)
    return {"seconds": seconds, "launches": launches, "corpora": per}


def settle_timing(tier, clock_mhz: float) -> dict:
    """The settle kernel on the inputs the tier gave it in its last corpus
    (``last_settle_inputs``: its sketches on the card, its pair indices,
    copied there), timed with the profiler beside a one-element fill kernel
    in the same window (the launch floor) and with events beside its plain
    version, and held bit-equal to the plain version.  Its bound counts
    what this data needs: each sketch's live values and the ``PAD`` that
    ends them read once, 8 B of indices and 8 B of output per pair, and
    ``|a| + |b|`` comparison steps per pair (a merge of the live values)."""
    from advanced_scrapper_tpu_torch.ops.rerank import quantize, settle_plain
    from advanced_scrapper_tpu_torch.ops.rerank_cuda import rerank_settle

    cfg = tier.cfg
    lo = quantize(cfg.sim_threshold - cfg.rerank_margin)
    hi = quantize(cfg.sim_threshold + cfg.rerank_margin)
    sk, idx = tier.last_settle_inputs
    n_sk, size = sk.shape
    ia, ib = idx.to(sk.device)
    m = ia.numel()
    live = (sk.view(torch.int32) != -1).sum(dim=1)
    read = torch.clamp(live + 1, max=size)  # the live values and the PAD after them
    steps = int((live[ia.long()] + live[ib.long()]).sum())
    out = torch.empty((2, m), dtype=torch.int32, device=sk.device)
    moved = 4 * int(read.sum()) + 8 * m + out.nbytes
    one = torch.empty((1,), dtype=torch.int32, device=sk.device)

    def both():
        rerank_settle(sk, ia, ib, size, lo, hi, out=out)
        one.fill_(0)

    kernel_ms, floor_ms = profiled_ms(both, "settle_kernel", "FillFunctor")
    event_ms = cuda_ms(lambda: rerank_settle(sk, ia, ib, size, lo, hi, out=out), 5)
    plain_ms = cuda_ms(lambda: settle_plain(sk, ia, ib, lo, hi))
    assert torch.equal(out, settle_plain(sk, ia, ib, lo, hi)), "rerank_settle differs from plain"
    ops_ms, bytes_ms = bound_ms(steps, moved, clock_mhz)
    return dict(pairs=m, sketches=n_sk, sketch=size, live_values=int(live.sum()),
                bytes=moved, compare_steps=steps, clock_max_sm_mhz=clock_mhz,
                ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms, ms=kernel_ms,
                launch_floor_ms=floor_ms, event_ms=event_ms,
                share_of_bound=max(ops_ms, bytes_ms) / kernel_ms, plain_ms=plain_ms)


STREAM_WARM = 1024  # one batch of the default batch_size
STREAM_PARITY = 2048
STREAM_PARITY_BATCH = 512
EXACT_URLS = 262144  # bench.py's exact regime


def stream_records(docs: list[bytes], rng: np.random.RandomState) -> list[dict]:
    """Records for the stream backend: each doc as its ``article``, with
    ``url = https://news.example/<id>/article-<i>.html``; 10% of the
    records repeat an earlier record's url, 1% have none."""
    recs: list[dict] = []
    urls: list[str] = []
    for i, d in enumerate(docs):
        u = rng.rand()
        if u < 0.01:
            url = None
        elif u < 0.11 and urls:
            url = urls[rng.randint(len(urls))]
        else:
            url = f"https://news.example/{rng.randint(1 << 30)}/article-{i}.html"
            urls.append(url)
        recs.append({"url": url, "article": d.decode("ascii"), "i": i})
    return recs


def run_stream(backend, records: list[dict]) -> tuple[list[tuple], dict]:
    """Submit ``records`` one by one (copies of the dicts) and flush;
    returns the annotations ``(i, dup_of, near_dup_of)`` and the host
    seconds of the stream, of the backend's stages and of the engine's
    stages, the engine's device ms by stage, all summed over the batches,
    and the launches counted over the stream (counters set to 0 first)."""
    host: dict[str, float] = {}
    engine_host: dict[str, float] = {}
    device: dict[str, float] = {}
    process = backend._process

    def counted():
        out = process()
        for tgt, src in ((host, backend.last_clock.seconds),
                         (engine_host, backend.engine.last_clock.seconds),
                         (device, backend.engine.last_clock.device_ms())):
            for k, v in src.items():
                tgt[k] = tgt.get(k, 0.0) + v
        return out

    backend._process = counted
    out: list[dict] = []
    reset_launches()
    t0 = time.perf_counter()
    for rec in records:
        out += backend.submit(dict(rec))
    out += backend.flush()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    backend._process = process
    return [(r["i"], r["dup_of"], r["near_dup_of"]) for r in out], {
        "seconds": seconds, "host_s": host, "engine_host_s": engine_host,
        "engine_device_ms": device, "launches": launches}


DISPATCH_KNOBS = ((1, 0), (2, 4))  # (put_workers, dispatch_window)
CHAOS_OOM = 3  # injected device OOMs in dispatch_path: 3 halvings
FEED_BLOCK = 4096  # stream_signatures' block: documents truncate here
FEED_BATCH = 1024
FEED_PARITY = 2048  # the prefix the CPU feed runs


def staged_lag(engine) -> dict:
    """The last corpus's staged-chunk lag (put done → folded) on the
    engine's dispatcher: near 0 when the fold waits for the host, large
    when chunks wait for the fold.  ``stages``: each stage's seconds per
    chunk, taken on its own thread (``pack`` wall and ``pack_cpu``, the
    pack thread's CPU time; ``put``; the caller's ``wait`` on the staged
    edge, its ``dispatch``, the fold, and ``dispatch_cpu``), to tell which
    one holds the loop, and whether it computes or waits."""
    pipe = engine.last_dispatcher
    return {"count": pipe.lag_count, "mean_s": pipe.lag_sum_s / max(pipe.lag_count, 1),
            "max_s": pipe.lag_max_s,
            "stages": {k: t.as_dict() for k, t in pipe.times.items()}}


def timed_reps(engine, docs: list[bytes], warm: list[bytes]) -> tuple[np.ndarray, float, dict]:
    """``engine.dedup_reps_async(docs)`` after a warm corpus, the launch
    counters set to 0 just before and read just after: the representatives,
    the host seconds and the launches."""
    engine.dedup_reps_async(warm)[: len(warm)].cpu()
    reset_launches()
    t0 = time.perf_counter()
    reps = engine.dedup_reps_async(docs)[: len(docs)].cpu().numpy()
    seconds = time.perf_counter() - t0
    return reps, seconds, read_launches()


def dispatch_path(docs: list[bytes], main_reps: np.ndarray, warm: list[bytes],
                  card: str) -> dict:
    """The estimator-only path at the dispatcher's knobs
    (``DISPATCH_KNOBS``): the representatives equal ``main_path``'s, one
    ``minhash_fold_segments`` launch a chunk and no other launch, the
    staged lag; then ``ASTPU_CHAOS_DISPATCH_OOM=3``: equal again, 3
    halvings, launches = chunks + 3."""
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.pipeline import dispatch
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    n = len(docs)
    runs = []
    for put_workers, window in DISPATCH_KNOBS:
        engine = NearDupEngine(DedupConfig(rerank=False, exact_verify_band=0.0,
                                           put_workers=put_workers, dispatch_window=window),
                               device="cuda")
        reps, seconds, got = timed_reps(engine, docs, warm)
        assert np.array_equal(reps, main_reps), f"knobs {(put_workers, window)} change reps"
        assert got["minhash_fold_segments"] == engine.last_chunks > 0, got
        assert sum(got.values()) == got["minhash_fold_segments"], got
        assert engine.last_halvings == 0
        runs.append({"put_workers": put_workers, "dispatch_window": window, "seconds": seconds,
                     "articles_per_s": n / seconds, "chunks": engine.last_chunks,
                     "launches": got["minhash_fold_segments"], "staged_lag": staged_lag(engine)})
    os.environ["ASTPU_CHAOS_DISPATCH_OOM"] = str(CHAOS_OOM)
    dispatch.reset_chaos_oom()
    try:
        reset_launches()
        t0 = time.perf_counter()
        reps = engine.dedup_reps_async(docs)[:n].cpu().numpy()
        seconds = time.perf_counter() - t0
        got = read_launches()
    finally:
        del os.environ["ASTPU_CHAOS_DISPATCH_OOM"]
        dispatch.reset_chaos_oom()
    assert np.array_equal(reps, main_reps), "the OOM back-off changes the representatives"
    assert engine.last_halvings == CHAOS_OOM, engine.last_halvings
    assert got["minhash_fold_segments"] == engine.last_chunks + CHAOS_OOM, got
    chaos = {"injected": CHAOS_OOM, "halvings": engine.last_halvings,
             "chunks": engine.last_chunks, "launches": got["minhash_fold_segments"],
             "seconds": seconds, "articles_per_s": n / seconds}
    log("dispatch_path", articles=n, runs=runs, chaos_oom=chaos, card=card)
    return {"launches": sum(r["launches"] for r in runs) + chaos["launches"],
            "chunks": sum(r["chunks"] for r in runs) + chaos["chunks"], "halvings": CHAOS_OOM}


def legacy_transport_path(docs: list[bytes], main_reps: np.ndarray, warm: list[bytes],
                          card: str) -> dict:
    """``packed_h2d=False``, the reference's legacy tile transport, over
    the main corpus: the representatives equal ``main_path``'s, one
    ``minhash_sig`` launch a tile and no other launch."""
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    engine = NearDupEngine(DedupConfig(rerank=False, exact_verify_band=0.0, packed_h2d=False),
                           device="cuda")
    reps, seconds, got = timed_reps(engine, docs, warm)
    assert np.array_equal(reps, main_reps), "the unpacked transport changes the representatives"
    assert got["minhash_sig"] == engine.last_chunks > 0, got
    assert sum(got.values()) == got["minhash_sig"], got
    log("legacy_transport_path", articles=len(docs), seconds=seconds,
        articles_per_s=len(docs) / seconds, tiles=engine.last_chunks,
        launches=got["minhash_sig"], h2d_bytes=engine.last_h2d_bytes,
        staged_lag=staged_lag(engine), card=card)
    return {"launches": got["minhash_sig"], "tiles": engine.last_chunks}


def run_feed(docs: list[bytes], device: str, **kw) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """``stream_signatures`` over ``docs`` (block ``FEED_BLOCK``, batches of
    ``FEED_BATCH``): every tag once, and the rows in tag order: ``(sigs,
    keys, tags as delivered, batches)``."""
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.pipeline.feed import stream_signatures

    tags, sigs, keys = [], [], []
    for t, s, k in stream_signatures(docs, cfg=DedupConfig(), block=FEED_BLOCK,
                                     batch_size=FEED_BATCH, device=device, **kw):
        tags.append(t)
        sigs.append(s)
        keys.append(k)
    order = np.concatenate(tags)
    assert np.array_equal(np.sort(order), np.arange(len(docs))), "a tag lost or repeated"
    rank = np.argsort(order)
    return np.concatenate(sigs)[rank], np.concatenate(keys)[rank], order, len(tags)


def feed_path(docs: list[bytes], card: str) -> dict:
    """``stream_signatures`` over the main corpus truncated at
    ``FEED_BLOCK``, batches of ``FEED_BATCH``, at ``feed_workers`` 1 and
    2: every tag once, one ``minhash_sig`` launch a batch and no other,
    signatures and band keys equal to ``minhash_signatures`` + ``band_keys``
    called directly on the same rows, ``sig_bits=16`` their low 16 bits
    (on the prefix), and the prefix equal to the CPU feed's.  Docs/s, and
    the card's busy share: the direct calls' device time over the feed's
    wall time."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.core.tokenizer import encode_batch
    from advanced_scrapper_tpu_torch.ops.lsh import band_keys
    from advanced_scrapper_tpu_torch.ops.minhash import minhash_signatures
    from advanced_scrapper_tpu_torch.ops.shingle import to_u32

    n = len(docs)
    # one batch first: the native queue's library is built and loaded at its
    # first use, which no timed run should pay
    run_feed(docs[:FEED_BATCH], "cuda")
    runs, first = [], None
    for workers in (1, 2):
        reset_launches()
        t0 = time.perf_counter()
        sigs, keys, order, batches = run_feed(docs, "cuda", feed_workers=workers)
        seconds = time.perf_counter() - t0
        got = read_launches()
        assert got["minhash_sig"] == batches == -(-n // FEED_BATCH), got
        assert sum(got.values()) == got["minhash_sig"], got
        if first is None:
            first = (sigs, keys)
        assert np.array_equal(sigs, first[0]) and np.array_equal(keys, first[1])
        runs.append({"feed_workers": workers, "seconds": seconds, "docs_per_s": n / seconds,
                     "batches": batches, "launches": got["minhash_sig"],
                     "in_tag_order": bool((order == np.arange(n)).all())})
    sigs, keys = first
    params = make_params()
    tok, lens = encode_batch(docs, FEED_BLOCK)
    rows = [(torch.from_numpy(tok[i:i + FEED_BATCH]).cuda(),
             torch.from_numpy(lens[i:i + FEED_BATCH]).cuda()) for i in range(0, n, FEED_BATCH)]
    del tok
    direct: list = []

    def direct_pass():
        direct.clear()
        for t, ln in rows:
            s = minhash_signatures(t, ln, params)
            direct.append((s, band_keys(s, params.band_salt)))

    direct_pass()
    device_ms = cuda_ms(direct_pass)
    want_sigs = np.concatenate([s.view(torch.int32).cpu().numpy() for s, _ in direct]).view(np.uint32)
    want_keys = np.concatenate([to_u32(k).view(torch.int32).cpu().numpy()
                                for _, k in direct]).view(np.uint32)
    del rows, direct
    assert np.array_equal(sigs, want_sigs), "feed signatures differ from the direct calls"
    assert np.array_equal(keys, want_keys), "feed band keys differ from the direct calls"
    t0 = time.perf_counter()
    sigs16, keys16, _order, _b = run_feed(docs[:FEED_PARITY], "cuda", sig_bits=16)
    assert sigs16.dtype == np.uint16 and np.array_equal(sigs16, sigs[:FEED_PARITY] & 0xFFFF)
    assert np.array_equal(keys16, keys[:FEED_PARITY])
    cpu_sigs, cpu_keys, _order, _b = run_feed(docs[:FEED_PARITY], "cpu")
    cpu_equal = bool(np.array_equal(cpu_sigs, sigs[:FEED_PARITY])
                     and np.array_equal(cpu_keys, keys[:FEED_PARITY]))
    assert cpu_equal, "card and CPU feeds disagree"
    for r in runs:
        r["busy_share"] = device_ms / 1e3 / r["seconds"]
    log("feed_path", docs=n, block=FEED_BLOCK, batch=FEED_BATCH, runs=runs,
        direct_device_ms=device_ms, sig_bits_16_low_bits=True, parity_docs=FEED_PARITY,
        card_vs_cpu_equal=cpu_equal, parity_seconds=time.perf_counter() - t0, card=card)
    return {"launches": sum(r["launches"] for r in runs),
            "batches": sum(r["batches"] for r in runs)}


QUALITY_SECONDS_MAX = 90.0
#: the canary's floors on the default engine, and the acceptance
#: configuration's recall floor (the reference's canary test)
CANARY_FLOOR = 0.9
BROWNOUT_RECALL_FLOOR = 0.93


def quality_path(card: str, dev: torch.device) -> dict:
    """The quality plane on the card, through the default engine's
    certified one-shot ``NearDupEngine(DedupConfig(), device="cuda")
    .dedup_reps``.

    Canary: one ``CanaryProber`` round (seed 0) scored against its measured
    oracle: recall at least 0.9 and the SLO engine's ``canary_recall``
    compliant, recall and precision equal to the CPU engine's round (the
    precision, counting the pairs a knee family joins through its base, is
    logged with its verdict against the 0.9 floor).  Brownout: the reference canary test's
    acceptance configuration (``sim_threshold`` 0.6, ``exact_verify_cap``
    0, ``fine_margin`` 0.06) under a ``DegradationLadder``: compliant with
    one ``rerank_settle`` launch, violated with ``skip_rerank`` armed and
    no settle launch, compliant again with the healthy recall after the
    step exits; each round's recall equals the port's CPU engine's.
    Certification: seed 101 of both mixes (``quality_probe.py``), knee-heavy
    and ``knee_frac=0.2``, through the card engine and the CPU engine: equal
    representatives and decision counts by tier, recall at least 0.92, no
    unchained merge, on the knee-heavy mix precision at least the oracle's
    comparator less 0.02.  The oracle's pairs are computed in two worker
    processes meanwhile.  Launches are counted per round; the phase must
    take under ``QUALITY_SECONDS_MAX`` seconds."""
    import dataclasses

    import quality_probe as qp

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.obs import canary, decisions, slo, telemetry
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
    from advanced_scrapper_tpu_torch.runtime.admission import DegradationLadder

    t_phase = time.perf_counter()
    seed = qp.SEEDS[0]
    pool = qp.oracle_pool(2)
    truths = {mix: pool.submit(qp.oracle_truth, seed, kf) for mix, kf in qp.MIXES.items()}
    out: dict = {"card": card}
    try:
        def compliant(reg) -> float:
            (g,) = [m for m in reg.find("astpu_slo_compliant")
                    if m.labels["objective"] == "canary_recall"]
            return g.value

        def canary_round(prober, engine, reg, cpu_prober=None) -> dict:
            reset_launches()
            sli = prober.run_round(round_id=0)
            got = read_launches()
            verdict = {o["name"]: o for o in engine.evaluate(
                slo.SloEngine.registry_samples(reg))["objectives"]}
            row = {k: sli[k] for k in ("recall", "precision", "oracle_pairs",
                                       "predicted_pairs", "caught_pairs", "latency_seconds")}
            row.update(compliant=compliant(reg), recall_ok=verdict["canary_recall"]["ok"],
                       fold_segments=got["minhash_fold_segments"],
                       rerank_settle=got["rerank_settle"])
            assert got["minhash_fold_segments"] >= 1, got
            if cpu_prober is not None:
                cpu = cpu_prober.run_round(round_id=0)
                assert (cpu["recall"], cpu["precision"]) == (sli["recall"], sli["precision"]), \
                    (cpu, sli)
            return row

        # -- one canary round through the default engine ---------------------
        reg = telemetry.Registry(enabled=True)
        default = NearDupEngine(DedupConfig(), device=dev)
        prober = canary.CanaryProber(default.dedup_reps, registry=reg, seed=0)
        cpu_prober = canary.CanaryProber(NearDupEngine(DedupConfig(), device="cpu").dedup_reps,
                                         registry=telemetry.Registry(), seed=0)
        engine = slo.SloEngine(prober.objectives(recall_min=CANARY_FLOOR,
                                                 precision_min=CANARY_FLOOR), registry=reg)
        out["canary"] = row = canary_round(prober, engine, reg, cpu_prober)
        # the pair precision counts the members of a knee family that the
        # engine joins through their base (true J under the bar between
        # two members): it is the CPU engine's, and the reference's, value
        row["precision_ok"] = {o["name"]: o["ok"] for o in engine.last_verdict["objectives"]}[
            "canary_precision"]
        assert row["recall"] >= CANARY_FLOOR, row
        assert row["compliant"] == 1.0 and row["rerank_settle"] == 1, row

        # -- the brownout: skip_rerank armed, then left ----------------------
        def acceptance(device) -> NearDupEngine:
            cfg = dataclasses.replace(DedupConfig(rerank=True), sim_threshold=0.6,
                                      exact_verify_cap=0, fine_margin=0.06)
            return NearDupEngine(cfg, device=device)

        reg = telemetry.Registry(enabled=True)
        card_eng, cpu_eng = acceptance(dev), acceptance("cpu")
        ladder = DegradationLadder(dwell_s=0.0)
        card_eng.ladder = cpu_eng.ladder = ladder
        prober = canary.CanaryProber(card_eng.dedup_reps, registry=reg, seed=0, threshold=0.6)
        cpu_prober = canary.CanaryProber(cpu_eng.dedup_reps, registry=telemetry.Registry(),
                                         seed=0, threshold=0.6)
        engine = slo.SloEngine(prober.objectives(recall_min=BROWNOUT_RECALL_FLOOR,
                                                 precision_min=0.5), registry=reg)
        rounds = {"healthy": canary_round(prober, engine, reg, cpu_prober)}
        for _ in range(4):
            ladder.observe(1.0)
        assert ladder.active("skip_rerank"), ladder.status()
        rounds["skip_rerank"] = canary_round(prober, engine, reg, cpu_prober)
        for _ in range(4):
            ladder.observe(0.0)
        assert ladder.level() == 0, ladder.status()
        rounds["recovered"] = canary_round(prober, engine, reg, cpu_prober)
        healthy, brown, back = rounds["healthy"], rounds["skip_rerank"], rounds["recovered"]
        assert healthy["recall"] >= BROWNOUT_RECALL_FLOOR and healthy["compliant"] == 1.0
        assert healthy["rerank_settle"] == 1, healthy
        assert brown["recall"] < BROWNOUT_RECALL_FLOOR and brown["compliant"] == 0.0, brown
        assert brown["rerank_settle"] == 0, brown
        assert back["recall"] == healthy["recall"] and back["compliant"] == 1.0, back
        assert back["rerank_settle"] == 1, back
        out["brownout"] = rounds
        out["skip_rerank_effects"] = sum(
            c.value for c in telemetry.REGISTRY.find("astpu_degraded_effects_total")
            if c.labels["ladder"] == ladder.name and c.labels["step"] == "skip_rerank")

        # -- certification seeds: card vs CPU, then the oracle ---------------
        cpu_default = NearDupEngine(DedupConfig(), device="cpu")
        launches = {"minhash_fold_segments": 0, "rerank_settle": 0}
        cert = {}
        for mix, kf in qp.MIXES.items():
            texts = qp.certification_corpus(seed, kf)
            before = decisions.decision_mix_snapshot()
            reset_launches()
            t0 = time.perf_counter()
            reps = default.dedup_reps(texts)
            card_s = time.perf_counter() - t0
            got = read_launches()
            card_mix = decisions.decision_mix_delta(before)
            assert got["minhash_fold_segments"] == default.last_chunks and \
                got["rerank_settle"] == 1, got
            for k in launches:
                launches[k] += got[k]
            before = decisions.decision_mix_snapshot()
            t0 = time.perf_counter()
            cpu_reps = cpu_default.dedup_reps(texts)
            cpu_s = time.perf_counter() - t0
            cpu_mix = decisions.decision_mix_delta(before)
            assert np.array_equal(reps, cpu_reps), f"{mix}: card and CPU reps differ"
            assert card_mix == cpu_mix, (mix, card_mix, cpu_mix)
            t0 = time.perf_counter()
            pairs, comparator = truths[mix].result()
            wait_s = time.perf_counter() - t0
            row = qp.score(texts, reps, pairs)
            row.update(docs=len(texts), card_seconds=card_s, cpu_seconds=cpu_s,
                       oracle_wait_seconds=wait_s, oracle_precision=comparator[0],
                       decisions=card_mix)
            assert row["recall"] >= qp.SEED_RECALL_MIN and row["unchained"] == 0, (mix, row)
            if mix == "knee_heavy":
                assert row["precision"] >= comparator[0] - qp.COMPARATOR_SLACK, (mix, row)
            cert[mix] = row
        out["certification"] = cert
        out["launches"] = launches
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    out["seconds"] = seconds = time.perf_counter() - t_phase
    log("quality_path", **out)
    assert seconds < QUALITY_SECONDS_MAX, f"quality_path took {seconds:.1f} s"
    return out


def prewarm_path(default, rsmall: list[bytes], cpu_default_reps: np.ndarray, card: str) -> dict:
    """``NearDupEngine(DedupConfig(prewarm=1))``: two warm launches (the
    fold and, through the tier, the settle), each counter up by one; the
    default engine's tier prewarm: one settle launch; then the prewarmed
    engine on the 2,048 ``rerank_corpus`` articles equal to the CPU
    default engine."""
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    reset_launches()
    t0 = time.perf_counter()
    engine = NearDupEngine(DedupConfig(prewarm=1), device="cuda")
    seconds = time.perf_counter() - t0
    got = read_launches()
    assert engine.prewarm_launches == 2, engine.prewarm_launches
    assert got == {**dict.fromkeys(got, 0), "minhash_fold_segments": 1, "rerank_settle": 1}, got
    reset_launches()
    tier_launches = default.rerank_tier.prewarm()
    tier_got = read_launches()
    assert tier_launches == 1 == tier_got["rerank_settle"] == sum(tier_got.values()), tier_got
    reps = engine.dedup_reps(rsmall)
    equal = bool(np.array_equal(reps, cpu_default_reps))
    assert equal, "the prewarmed engine and the CPU engine disagree"
    log("prewarm_path", engine_prewarm_launches=engine.prewarm_launches, launches=got,
        construct_seconds=seconds, tier_prewarm_launches=tier_launches,
        articles=len(rsmall), reps_equal_cpu=equal, card=card)
    return {"fold_segments": got["minhash_fold_segments"],
            "rerank_settle": got["rerank_settle"] + tier_got["rerank_settle"]}


def stream_path(docs: list[bytes], planted: dict[int, int], card: str) -> int:
    """The stream backend (``extractors/tpu_batch.py``) at its defaults
    over the ragged corpus as 64 batches of 1,024 records, in the exact
    and the bloom mode, timed after one warm batch; then card and CPU
    backends on ``rerank_corpus`` records, and a checkpoint resume on the
    card.  Returns the segment kernel's launches over the exact-mode
    stream (one per batch) and the batches."""
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend

    dev = torch.device("cuda")
    records = stream_records(docs, np.random.RandomState(17))
    warm = stream_records(ragged_corpus(np.random.RandomState(18), STREAM_WARM)[0],
                          np.random.RandomState(19))
    batches = -(-len(records) // DedupConfig().batch_size)
    modes = {}
    for mode in ("exact", "bloom"):
        cfg = DedupConfig(stream_index=mode)
        run_stream(TpuBatchBackend(cfg, device=dev), warm)
        backend = TpuBatchBackend(cfg, device=dev)
        ann, rec = run_stream(backend, records)
        got = rec["launches"]
        assert got["minhash_fold_segments"] == batches == backend.stats.batches, got
        assert sum(got.values()) == batches, got  # no other kernel on this path
        by_i = {a[0]: a for a in ann}
        checked = missed = 0
        for i, src in planted.items():
            r, s = records[i], records[src]
            if r["url"] and by_i[i][1] is None and s["url"] and by_i[src][1] is None:
                checked += 1
                missed += by_i[i][2] is None
        assert checked > 0 and not missed, f"{mode}: {missed} of {checked} planted copies missed"
        stats = backend.stats
        modes[mode] = dict(records_per_s=len(records) / rec["seconds"], **rec,
                           planted_checked=checked, exact_dups=stats.exact_dups,
                           near_dups=stats.near_dups, kept=stats.kept)
    seg_launches = modes["exact"]["launches"]["minhash_fold_segments"]

    # card vs CPU on mutated near-dups (the fine bar), and a checkpoint
    # saved after batch 2 resumed by a fresh card backend
    import tempfile

    rdocs = rerank_corpus(np.random.RandomState(13), STREAM_PARITY)
    rrecs = stream_records(rdocs, np.random.RandomState(14))
    split = 2 * STREAM_PARITY_BATCH
    parity = {}
    t0 = time.perf_counter()
    for mode in ("exact", "bloom"):
        cfg = DedupConfig(stream_index=mode, batch_size=STREAM_PARITY_BATCH)
        card_b = TpuBatchBackend(cfg, device=dev)
        cpu_b = TpuBatchBackend(cfg, device="cpu")
        card_ann, _ = run_stream(card_b, rrecs)
        cpu_ann, _ = run_stream(cpu_b, rrecs)
        equal = card_ann == cpu_ann and card_b.stats == cpu_b.stats
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "stream_index.npz")
            first = TpuBatchBackend(cfg, device=dev)
            head, _ = run_stream(first, rrecs[:split])
            first.save_index(path)
            resumed = TpuBatchBackend(cfg, device=dev)
            loaded = resumed.load_index_if_valid(path)
            tail, _ = run_stream(resumed, rrecs[split:])
        resume_equal = loaded and head + tail == card_ann and resumed.stats == card_b.stats
        parity[mode] = dict(card_equals_cpu=equal, resume_equal=resume_equal,
                            near_dups=card_b.stats.near_dups, exact_dups=card_b.stats.exact_dups)
        assert equal, f"{mode}: card and CPU stream backends disagree"
        assert resume_equal, f"{mode}: the resumed stream differs"
    log("stream_path", records=len(records), batches=batches,
        text_bytes=int(sum(map(len, docs))), modes=modes, parity_records=STREAM_PARITY,
        parity_batch=STREAM_PARITY_BATCH, parity=parity,
        parity_seconds=time.perf_counter() - t0, card=card)
    return seg_launches, batches


def exact_urls(seed: int, n: int = EXACT_URLS) -> list[str]:
    """``bench.py``'s exact recipe: 80% unique urls, the rest repeats of
    them, shuffled."""
    r = np.random.RandomState(seed)
    base = [f"https://news.example/{r.randint(1 << 30)}/article-{i}.html"
            for i in range(int(n * 0.8))]
    urls = base + [base[r.randint(len(base))] for _ in range(n - len(base))]
    r.shuffle(urls)
    return urls


def best_of(fn, reps: int = 5) -> tuple[float, object]:
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def exact_path(card: str) -> None:
    """``ExactDedup`` over 262,144 urls (warmed on seed 1, timed on seed
    2, best of 5): the default tier, the blob tier alone and the grouping
    path with its hash on the card; every tier's kept indices equal a
    first-seen dict."""
    import sysconfig

    from advanced_scrapper_tpu_torch.core.tokenizer import bucket_len, to_bytes
    from advanced_scrapper_tpu_torch.cpu import exactdedup
    from advanced_scrapper_tpu_torch.cpu.hostbatch import exact_keep_first_native
    from advanced_scrapper_tpu_torch.ops.exact import ExactHasher
    from advanced_scrapper_tpu_torch.pipeline.dedup import ExactDedup

    dev = torch.device("cuda")
    warm, urls = exact_urls(1), exact_urls(2)
    seen: set = set()
    want = [i for i, u in enumerate(urls) if u not in seen and not seen.add(u)]
    tiers = {}
    default = ExactDedup(device=dev)
    default.keep_indices(warm)
    s, kept = best_of(lambda: default.keep_indices(urls))
    assert kept == want, "the default tier differs from first-seen"
    tiers["default"] = dict(served_by=default.last_path, seconds=s, urls_per_s=len(urls) / s)
    exact_keep_first_native(warm)
    s, keep = best_of(lambda: exact_keep_first_native(urls))
    assert np.flatnonzero(keep).tolist() == want, "the blob tier differs from first-seen"
    tiers["blob"] = dict(seconds=s, urls_per_s=len(urls) / s)
    grouping = ExactDedup(hasher=ExactHasher(device=dev))
    grouping.keep_indices(warm)
    s, kept = best_of(lambda: grouping.keep_indices(urls))
    assert kept == want and grouping.last_path == "grouping", "the grouping path differs"
    raw = [to_bytes(u) for u in urls]
    block = bucket_len(max(len(r) for r in raw))
    hasher = grouping.hasher
    hash_s, _ = best_of(lambda: hasher.hash_docs(raw, block_len=block), reps=3)
    hash_ms = cuda_ms(lambda: hasher.hash_docs(raw, block_len=block))
    # the device's own events (kernels and copies), not the aten:: ops that
    # hold them, which would count each one again
    seen = {k: v for k, v in profiler_device_ms(
        lambda: hasher.hash_docs(raw, block_len=block), (), reps=3).items()
        if not k.startswith("aten::")}
    tiers["grouping"] = dict(
        seconds=s, urls_per_s=len(urls) / s, block_len=block, hash_docs_s=hash_s,
        hash_docs_event_ms=hash_ms,
        hash_docs_device_ms=sum(v[0] for v in seen.values()) / 3,
        hash_docs_device_top={k: v for k, v in sorted(
            seen.items(), key=lambda kv: -kv[1][0])[:6]})
    include = sysconfig.get_paths().get("include")
    log("exact_path", urls=len(urls), kept=len(want), tiers=tiers,
        zero_copy_backend=exactdedup.exactdedup_backend(),
        zero_copy_reason=exactdedup.backend_reason(), python_include=include,
        python_h=bool(include and os.path.exists(os.path.join(include, "Python.h"))),
        card=card)


SCRAPE_PAGES = 8192      # --scrape: the scrape plane alone at full depth
SCRAPE_PARITY = 1024     # its card-vs-CPU run, one thread
SCRAPE_SMOKE_PAGES = 1024  # the default run's depth
SCRAPE_SMOKE_PARITY = 256
SCRAPE_THREADS = 8
SCRAPE_RATE = 5000.0     # admitted pages a second
SCRAPE_COPIES = 0.10     # planted near-dup copies of earlier pages
SCRAPE_TITLELESS = 0.02  # pages without a title (failed rows)
SCRAPE_RATE_LIMIT_WAIT = 0.2
SCRAPE_TICKERS = ("AAPL", "MSFT", "NVDA", "AMZN", "GOOGL", "META", "TSLA", "JPM", "XOM", "BRK-B")
SCRAPE_SOURCES = ("Reuters", "Bloomberg", "Motley Fool", "Barron's", "Zacks", "Benzinga")
#: the throttle interstitial the yfin extractor reads as ``rate_limit_reached``
RATE_LIMIT_PAGE = (
    "<!DOCTYPE html>\n<html>\n<head><title>Yahoo</title></head>\n<body>\n"
    "  <div class=\"error-page\">\n    <h1>We're experiencing technical difficulties.</h1>\n"
    "    <p>Thank you for your patience.</p>\n"
    "    <p>Our engineers are working quickly to resolve the issue.</p>\n  </div>\n"
    "</body>\n</html>\n")


def article_blocks(rng: np.random.RandomState, text: str) -> list[tuple[str, list[str]]]:
    """``text`` cut into a yfin body's blocks, ``(kind, pieces)``: mostly
    paragraphs, some bullet and numbered lists of 2-4 items and tables of
    2-4 rows."""
    blocks: list[tuple[str, list[str]]] = []
    pos = 0
    while pos < len(text):
        kind = ("p", "p", "p", "p", "ul", "ol", "table")[rng.randint(7)]
        pieces = []
        for _ in range(1 if kind == "p" else int(rng.randint(2, 5))):
            step = int(rng.randint(60, 600))
            pieces.append(text[pos:pos + step])
            pos += step
            if pos >= len(text):
                break
        blocks.append((kind, pieces))
    return blocks


def edit_blocks(rng: np.random.RandomState, blocks, share: float = 0.003):
    """A near-dup copy of ``blocks``: about ``share`` of the characters
    replaced by random letters (at least one)."""
    out = [(kind, list(pieces)) for kind, pieces in blocks]
    total = sum(len(p) for _, pieces in out for p in pieces)
    for _ in range(max(1, int(total * share))):
        kind, pieces = out[rng.randint(len(out))]
        j = rng.randint(len(pieces))
        if pieces[j]:
            k = rng.randint(len(pieces[j]))
            pieces[j] = pieces[j][:k] + chr(97 + rng.randint(26)) + pieces[j][k + 1:]
    return out


def yfin_page(rng: np.random.RandomState, i: int, blocks, tickers, title: str | None) -> str:
    """One page with the yfin fixture's structure (``div.cover-title``,
    ``div.byline-attr-author``, ``time[datetime]``, the source link
    ``a.subtle-link.fin-size-small``, ``div.body`` inside ``div.body-wrap``
    with the blocks, quote links to ``tickers`` in its last paragraph), a
    script, a style and a comment; ``title=None`` leaves the title out."""
    esc = html.escape
    author = f"{letters(rng, 3, 9).title()} {letters(rng, 4, 11).title()}"
    source = SCRAPE_SOURCES[rng.randint(len(SCRAPE_SOURCES))]
    day = int(rng.randint(0, 3650))
    stamp = time.strftime("%Y-%m-%dT%H:%M:00.000Z", time.gmtime(1.4e9 + day * 86400
                                                                  + rng.randint(86400)))
    out = [
        "<!DOCTYPE html>\n<html>\n<head><title>",
        esc(title or "Yahoo Finance"), "</title>\n",
        f"<script>window.__page = {{\"id\": {i}, \"cmp\": \"a<b && c>d\"}};</script>\n",
        "<style>.cover-title { font-weight: 700 } p > a { color: #0f69ff }</style>\n",
        f"</head>\n<body>\n<!-- article {i} -->\n<div class=\"article-wrap\">\n",
    ]
    if title is not None:
        out += ["  <div class=\"cover-title\">", esc(title), "</div>\n"]
    out += [
        "  <div class=\"byline-attr\">\n    <div class=\"byline-attr-author\">", esc(author),
        f"</div>\n    <time datetime=\"{stamp}\">{stamp[:10]}</time>\n  </div>\n",
        f"  <a class=\"subtle-link fin-size-small\" aria-label=\"{esc(source)}\" "
        f"href=\"https://news.example/{i}/story\">{esc(source)}</a>\n",
        "  <div class=\"body-wrap\">\n    <div class=\"body\">\n",
    ]
    for kind, pieces in blocks:
        if kind == "p":
            out += ["      <p>", esc(pieces[0]), "</p>\n"]
        elif kind in ("ul", "ol"):
            out.append(f"      <{kind}>\n")
            out += [f"        <li>{esc(p)}</li>\n" for p in pieces]
            out.append(f"      </{kind}>\n")
        else:
            out.append("      <table>\n        <tr><th>Segment</th><th>Note</th></tr>\n")
            for p in pieces:
                half = len(p) // 2
                out.append(f"        <tr><td>{esc(p[:half])}</td><td>{esc(p[half:])}</td></tr>\n")
            out.append("      </table>\n")
    links = [f"<a href=\"https://finance.yahoo.com/quote/{SCRAPE_TICKERS[t]}?p="
             f"{SCRAPE_TICKERS[t]}\">{SCRAPE_TICKERS[t]}</a>" for t in tickers]
    out += ["      <p>Shares of ", ", ".join(links) or "the group", " moved &amp; traded.</p>\n",
            "    </div>\n  </div>\n</div>\n</body>\n</html>\n"]
    return "".join(out)


def scrape_pages(rng: np.random.RandomState, n: int, body_cap: int | None = None):
    """``n`` article pages keyed by url, bodies from the ragged recipe
    (``ragged_corpus``, its exact copies redrawn): 10%
    near-dup copies of earlier titled pages (distinct sources, their quote
    links kept, about 0.3% of the characters edited), 2% without a title, one rate-limit sentinel
    page; ``body_cap`` cuts each body to that many bytes (the CPU tests'
    small pages).  Returns ``(urls, pages, {copy url: source url}, titleless
    urls, sentinel url)``."""
    docs, dups = ragged_corpus(rng, n)
    for i in dups:
        docs[i] = rng.randint(32, 127, size=len(docs[i]), dtype=np.uint8).tobytes()
    urls: list[str] = []
    pages: dict[str, str] = {}
    planted: dict[str, str] = {}
    titleless: set[str] = set()
    blocks_of: dict[str, list] = {}
    sources: list[str] = []
    limited = n // 2
    for i in range(n):
        url = f"https://finance.example/news/story-{i}-{rng.randint(1 << 30)}.html"
        urls.append(url)
        if i == limited:
            pages[url] = RATE_LIMIT_PAGE
            continue
        title = f"{letters(rng, 4, 10).title()} {letters(rng, 3, 8)} {letters(rng, 5, 12)} {i}"
        u = rng.rand()
        if u < SCRAPE_COPIES and len(sources) > 8:
            src = sources.pop(rng.randint(len(sources)))
            planted[url] = src
            blocks, tickers = blocks_of[src]
            blocks = edit_blocks(rng, blocks)
        else:
            blocks = article_blocks(rng, docs[i][:body_cap].decode("ascii"))
            tickers = rng.choice(len(SCRAPE_TICKERS), size=int(rng.randint(0, 4)), replace=False)
            if u < SCRAPE_COPIES + SCRAPE_TITLELESS:
                titleless.add(url)
                title = None
            else:
                sources.append(url)
                blocks_of[url] = blocks, tickers
        pages[url] = yfin_page(rng, i, blocks, tickers, title)
    return urls, pages, planted, titleless, urls[limited]


def csv_tree(path: str) -> dict[str, bytes]:
    """The bytes of each CSV file directly under ``path``."""
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".csv"):
            with open(os.path.join(path, name), "rb") as f:
                out[name] = f.read()
    return out


def run_scrape(urls: list[str], pages: dict[str, str], out_dir: str, dev, threads: int,
               input_csv: str, busy: bool = False) -> dict:
    """``run_scraper`` over ``urls`` (read from ``input_csv``) served by
    ``MockTransport(pages)``, its console caught; returns the run's
    seconds, the launches counted over it (counters set to 0 first), the
    scraper's own stage series over it (``obs.stages``: ``scrape_extract``,
    the tree build and extractor summed over the fetch threads by wall
    clock, GIL waits included; ``scrape_extract_cpu``, the same by each
    thread's CPU clock; ``scrape_backend``, the result loop's time in the
    backend's ``submit`` and the final ``flush``), its summary line, and
    with ``busy`` the card's busy ms: the device time of every kernel and
    copy that ``torch.profiler`` (device activity only) recorded over the
    run, ``None`` where it recorded none, and the segment folds it recorded
    (fewer than were launched: the busy ms is short by the rest)."""
    import contextlib
    import io

    from advanced_scrapper_tpu_torch.config import ScraperConfig
    from advanced_scrapper_tpu_torch.net.transport import MockTransport
    from advanced_scrapper_tpu_torch.obs import stages
    from advanced_scrapper_tpu_torch.pipeline import scraper

    if not os.path.exists(input_csv):
        with open(input_csv, "w") as f:
            f.write("url\n" + "\n".join(urls) + "\n")
    cfg = ScraperConfig(input_csv=input_csv, out_dir=out_dir, max_threads=threads,
                        desired_request_rate=SCRAPE_RATE, rate_limit_wait=SCRAPE_RATE_LIMIT_WAIT,
                        result_timeout=120.0, transport="mock")
    os.makedirs(out_dir, exist_ok=True)
    console = io.StringIO()
    with contextlib.ExitStack() as stack:
        prof = None
        if busy:
            from torch.profiler import ProfilerActivity, profile

            prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
        reset_launches()
        stages.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(console):
            rc = scraper.run_scraper(cfg, transport_factory=lambda: MockTransport(pages),
                                     show_stats=False, device=dev)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        stage_ms = stages.snapshot_ms()
        if busy:
            torch.cuda.synchronize()
    busy_ms, seen_folds = None, 0
    if prof is not None:
        seen = [e for e in prof.key_averages() if e.device_time_total > 0]
        busy_ms = sum(e.device_time_total for e in seen) / 1e3 or None
        seen_folds = sum(e.count for e in seen if "SegmentUnits" in e.key)
    assert rc == 0, console.getvalue()[-2000:]
    summary = [ln for ln in console.getvalue().splitlines() if ln.startswith("Scraping completed")]
    return dict(seconds=seconds, launches=launches, busy_ms=busy_ms, seen_folds=seen_folds,
                extract_s=stage_ms.get("scrape_extract", 0.0) / 1e3,
                extract_cpu_s=stage_ms.get("scrape_extract_cpu", 0.0) / 1e3,
                backend_s=stage_ms.get("scrape_backend", 0.0) / 1e3,
                summary=summary[-1] if summary else "")


def scrape_path(card: str, dev=None, pages_n: int = SCRAPE_SMOKE_PAGES,
                parity_n: int = SCRAPE_SMOKE_PARITY) -> tuple[int, int]:
    """The scrape plane end to end: ``run_scraper`` over ``pages_n``
    generated yfin pages (``scrape_pages``) served by ``MockTransport``, 8
    fetch threads at 5,000 pages/s, successes streamed into the card's
    stream backend.  Checks: the rows add up, every planted copy is
    annotated a near-dup of its source (or its source of it), one
    ``minhash_fold_segments`` launch a stream batch of 1,024 successes and
    no other launch, a resume adds no row and launches nothing, and
    ``parity_n`` pages at one thread write the same CSV bytes on the card
    and on the CPU.  The default run takes 1,024 pages (parity 256);
    ``--scrape`` the full 8,192 (parity 1,024).  Returns the segment
    kernel's launches and the stream batches.  ``dev`` is the backend's
    device (``None``: the card; a CPU rehearsal passes ``"cpu"``)."""
    import csv
    import tempfile

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.storage.csvio import count_rows

    t0 = time.perf_counter()
    urls, pages, planted, titleless, limited = scrape_pages(np.random.RandomState(41), pages_n)
    generate_s = time.perf_counter() - t0
    html_bytes = sum(len(p.encode()) for p in pages.values())
    on_card = dev != "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "card")
        src_csv = os.path.join(tmp, "urls.csv")
        run = run_scrape(urls, pages, out, dev, SCRAPE_THREADS, src_csv, busy=on_card)
        ok_csv = os.path.join(out, "success_articles_yfin.csv")
        bad_csv = os.path.join(out, "failed_articles_yfin.csv")
        ann_csv = os.path.join(out, "dedup_annotations_yfin.csv")
        succeeded, failed = count_rows(ok_csv), count_rows(bad_csv)
        assert succeeded == len(urls) - len(titleless) - 1, (succeeded, len(urls), len(titleless))
        assert failed == len(titleless), (failed, len(titleless))
        with open(ann_csv, newline="", encoding="utf-8") as f:
            ann = {r["url"]: r for r in csv.DictReader(f)}
        assert len(ann) == succeeded, (len(ann), succeeded)
        missed = [c for c, s in planted.items()
                  if ann[c]["near_dup_of"] != s and ann[s]["near_dup_of"] != c]
        assert planted and not missed, f"{len(missed)} of {len(planted)} planted copies not annotated"
        got = run["launches"]
        batches = -(-succeeded // DedupConfig().batch_size)
        if on_card:  # the CPU runs the plain versions, which count no launch
            assert got["minhash_fold_segments"] == batches > 0, (got, batches)
            assert sum(got.values()) == batches, got  # no other kernel on this path
        near = sum(1 for r in ann.values() if r["near_dup_of"])
        before = csv_tree(out)
        resume = run_scrape(urls, pages, out, dev, SCRAPE_THREADS, src_csv)
        after = csv_tree(out)
        assert count_rows(ok_csv) == succeeded and count_rows(bad_csv) == failed
        assert after == before, "the resume run changed the CSVs"
        assert sum(resume["launches"].values()) == 0, resume["launches"]

        # card vs CPU: one fetch thread, so the rows come in one order
        sub = urls[:parity_n]
        sub_pages = {u: pages[u] for u in sub}
        sub_csv = os.path.join(tmp, "urls_parity.csv")
        par = {}
        for name, where in (("card", dev), ("cpu", "cpu")):
            par[name] = run_scrape(sub, sub_pages, os.path.join(tmp, f"parity_{name}"), where, 1,
                                   sub_csv)
        card_tree, cpu_tree = (csv_tree(os.path.join(tmp, f"parity_{n}")) for n in ("card", "cpu"))
        assert card_tree == cpu_tree and len(card_tree) == 3, "card and CPU scrape trees differ"
    seconds = run["seconds"]
    busy_ms = run["busy_ms"]
    log("scrape_path", pages=len(urls), html_bytes=html_bytes, generate_s=generate_s,
        threads=SCRAPE_THREADS, rate=SCRAPE_RATE, succeeded=succeeded, failed=failed,
        rate_limited=1, planted=len(planted), near_dups=near, seconds=seconds,
        pages_per_s=len(urls) / seconds, extract_s=run["extract_s"],
        extract_cpu_s=run["extract_cpu_s"], extract_share=run["extract_cpu_s"] / seconds,
        backend_s=run["backend_s"], backend_share=run["backend_s"] / seconds, batches=batches,
        launches=got, card_busy_ms=busy_ms, profiler_fold_launches=run["seen_folds"],
        card_busy_share=None if busy_ms is None else busy_ms / 1e3 / seconds,
        summary=run["summary"],
        resume=dict(seconds=resume["seconds"], launches=resume["launches"],
                    summary=resume["summary"]),
        parity=dict(pages=parity_n, card_equals_cpu=True,
                    card_seconds=par["card"]["seconds"], cpu_seconds=par["cpu"]["seconds"],
                    card_launches=par["card"]["launches"]),
        phase_s=time.perf_counter() - t0, card=card)
    return got["minhash_fold_segments"], batches


PERSIST_SPLIT = 32768  # session 1 takes the first half of the stream
PERSIST_PARITY_SPLIT = 1024  # the 2,048 parity records: two sessions
AGAINST_INDEX_ARTICLES = 4096


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _dirs, files in os.walk(path) for f in files)


def persist_path(docs: list[bytes], planted: dict[int, int], card: str) -> tuple[int, int, dict]:
    """The stream backend's persist mode at its defaults (batches of 1,024,
    cuts at 65,536 postings, compaction at 8 segments, on its thread) over
    the ragged records of ``stream_path`` in two sessions: the first half,
    then ``checkpoint`` and ``close``, then a fresh backend that reopens the
    directory and takes the second half; each timed after a warm batch
    into another directory.  One segment-kernel launch per batch and no
    other; every planted copy with a fresh url and an eligible source
    marked ``doc:<id>``, those whose source came in session 1 counted
    apart; every mark resolved by the docmap.  Then card and CPU backends
    on 2,048 ``rerank_corpus`` records in batches of 512 over two sessions
    (annotations, stats and both sub-indexes' postings equal), and
    ``dedup_against_index`` over 4,096 ragged articles on the card and on
    the CPU (equal attributions, across a reopen).  Returns the segment
    kernel's launches over the two sessions, the batches, and what
    ``fleet_path`` holds the fleet to: the two sessions' annotations and
    records/s and the card's ``dedup_against_index`` attributions, and a
    copy of the index directory as session 1 left it (``session1``, a
    temporary directory ``reshard_path`` probes and removes)."""
    import shutil
    import tempfile

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend
    from advanced_scrapper_tpu_torch.index import PersistentIndex
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    dev = torch.device("cuda")
    records = stream_records(docs, np.random.RandomState(17))
    warm = stream_records(ragged_corpus(np.random.RandomState(18), STREAM_WARM)[0],
                          np.random.RandomState(19))
    cfg = DedupConfig(stream_index="persist")
    tmp = tempfile.mkdtemp(prefix="persist-")
    try:
        warm_b = TpuBatchBackend(cfg, index_dir=os.path.join(tmp, "warm"), device=dev)
        run_stream(warm_b, warm)
        warm_b.close()
        index_dir = os.path.join(tmp, "index")
        sessions, ann = [], []
        launches = batches = 0
        session1 = tempfile.mkdtemp(prefix="persist-session1-")
        for si, part in enumerate((records[:PERSIST_SPLIT], records[PERSIST_SPLIT:])):
            if si == 1:  # session 1's index, for reshard_path's probes
                shutil.copytree(index_dir, session1, dirs_exist_ok=True)
            t0 = time.perf_counter()
            backend = TpuBatchBackend(cfg, index_dir=index_dir, device=dev)
            open_s = time.perf_counter() - t0
            got, rec = run_stream(backend, part)
            ann += got
            n = backend.stats.batches
            assert rec["launches"]["minhash_fold_segments"] == n == -(-len(part) // cfg.batch_size)
            assert sum(rec["launches"].values()) == n, rec["launches"]
            launches += n
            batches += n
            bands, urls = backend._pindex, backend._pindex_urls
            t0 = time.perf_counter()
            backend.checkpoint()
            checkpoint_s = time.perf_counter() - t0
            state = dict(
                segments=bands.stats()["segments"], urls_segments=urls.stats()["segments"],
                postings=bands.posting_count(), urls_postings=urls.posting_count(),
                resident_bytes=bands.resident_bytes() + urls.resident_bytes(),
                segment_cuts=bands.segment_cuts + urls.segment_cuts,
                observed_bloom_fp=bands.observed_fp_ratio(), probe_rows=bands.probe_rows,
                probe_hits=bands.probe_hits)
            t0 = time.perf_counter()
            backend.close()  # joins a compaction still running
            close_s = time.perf_counter() - t0
            stats = backend.stats
            sessions.append(dict(
                records=len(part), records_per_s=len(part) / rec["seconds"], **rec,
                open_seconds=open_s, reopen_seconds={"bands": bands.reopen_seconds,
                                                     "urls": urls.reopen_seconds},
                checkpoint_seconds=checkpoint_s, close_seconds=close_s,
                compactions=bands.compactions + urls.compactions,
                tombstoned=bands.tombstoned + urls.tombstoned, **state,
                disk_bytes=dir_bytes(index_dir), exact_dups=stats.exact_dups,
                near_dups=stats.near_dups, kept=stats.kept))
        assert sum(s["compactions"] for s in sessions) >= 1, "no compaction ran"
        by_i = {a[0]: a for a in ann}
        checked = across = missed = 0
        for i, src in planted.items():
            r, s = records[i], records[src]
            if r["url"] and by_i[i][1] is None and s["url"] and by_i[src][1] is None:
                checked += 1
                across += src < PERSIST_SPLIT <= i
                mark = by_i[i][2]
                missed += not (mark and mark.startswith("doc:"))
        assert checked and not missed, f"{missed} of {checked} planted copies missed"
        assert across > 0, "no planted copy whose source came in session 1"
        ids = {int(m[4:]) for a in ann for m in a[1:] if m}
        reader = PersistentIndex(os.path.join(index_dir, "bands"), read_only=True)
        names = reader.lookup_names(ids)
        reader.close()
        assert ids and set(names) == ids, f"{len(ids - set(names))} doc marks unresolved"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # card vs CPU over two sessions each, and dedup_against_index
    rrecs = stream_records(rerank_corpus(np.random.RandomState(13), STREAM_PARITY),
                           np.random.RandomState(14))
    pcfg = DedupConfig(stream_index="persist", batch_size=STREAM_PARITY_BATCH)
    adocs = ragged_corpus(np.random.RandomState(20), AGAINST_INDEX_ARTICLES)[0]
    half = AGAINST_INDEX_ARTICLES // 2
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="persist-parity-")
    try:
        runs = {}
        for name, device in (("card", dev), ("cpu", "cpu")):
            d = os.path.join(tmp, name)
            out, per_session = [], []
            for part in (rrecs[:PERSIST_PARITY_SPLIT], rrecs[PERSIST_PARITY_SPLIT:]):
                b = TpuBatchBackend(pcfg, index_dir=d, device=device)
                out += run_stream(b, part)[0]
                per_session.append(b.stats)
                dumps = [tuple(a.tolist() for a in index.dump_postings())
                         for index in (b._pindex, b._pindex_urls)]
                b.close()
            engine = NearDupEngine(DedupConfig(rerank=False), device=device)
            against = []
            for docs_part in (adocs[:half], adocs[half:]):  # the index reopened between
                index = engine.open_stream_index(os.path.join(tmp, name + "-against"))
                against += engine.dedup_against_index(docs_part, index).tolist()
                index.close()
            runs[name] = (out, per_session, dumps,
                          open(os.path.join(d, "bands", "docmap.log"), "rb").read(), against)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card_run, cpu_run = runs["card"], runs["cpu"]
    parity = dict(annotations_equal=card_run[0] == cpu_run[0],
                  stats_equal=card_run[1] == cpu_run[1], postings_equal=card_run[2] == cpu_run[2],
                  docmap_equal=card_run[3] == cpu_run[3],
                  against_index_equal=card_run[4] == cpu_run[4],
                  near_dups=sum(s.near_dups for s in card_run[1]),
                  against_index_hits=sum(a >= 0 for a in card_run[4]),
                  seconds=time.perf_counter() - t0)
    assert all(parity[k] for k in ("annotations_equal", "stats_equal", "postings_equal",
                                   "docmap_equal", "against_index_equal")), parity
    assert parity["near_dups"] and parity["against_index_hits"], parity
    log("persist_path", records=len(records), batches=batches, split=PERSIST_SPLIT,
        sessions=sessions, planted_checked=checked, planted_across_sessions=across,
        doc_marks=len(ids), parity_records=STREAM_PARITY, parity_batch=STREAM_PARITY_BATCH,
        against_index_articles=AGAINST_INDEX_ARTICLES, parity=parity,
        cut_postings=cfg.index_cut_postings, compact_segments=cfg.index_compact_segments,
        card=card)
    local = dict(annotations=ann, records_per_s=[x["records_per_s"] for x in sessions],
                 against=card_run[4], session1=session1)
    return launches, batches, local


FLEET_SHARDS, FLEET_REPLICAS = 2, 2  # each shard a primary and a replica
#: session 1's batches before shard 1's primary is killed.  Shard 1, not 0:
#: shard 0 holds the doc-id allocator, and a fresh client (session 2's)
#: whose allocator primary is dark refuses to allocate (it never synced a
#: durable floor), as the reference's does
FLEET_KILL_AFTER = 16
KILLED = (1, 0)
FLEET_READY_S = 60.0  # the most a shard process may take to listen
#: the healing client's digest resolution: 16 buckets, each streamed with
#: one ``fetch_range`` a side (the default 256 would stream 512 of them)
FLEET_DIGEST_BITS = 4


class ShardFleet:
    """``FLEET_SHARDS`` × ``FLEET_REPLICAS`` index shard servers, each a
    process of its own (``python -m advanced_scrapper_tpu_torch.index.remote``)
    on loopback over a directory under ``root``, at the server's defaults
    (spaces ``bands`` and ``urls``, cuts at 65,536 postings, compaction at
    8 segments inline).  ``grow`` adds shards.  Every process is stopped
    (SIGTERM, then SIGKILL) when the ``with`` block ends."""

    def __init__(self, root: str):
        self.root = root
        self.procs: dict[tuple[int, int], subprocess.Popen] = {}
        self.ports: dict[tuple[int, int], int] = {}
        self.shards = 0
        os.makedirs(root, exist_ok=True)
        self.grow(FLEET_SHARDS)

    def grow(self, shards: int) -> None:
        """Start the nodes of shards ``self.shards .. shards - 1`` together
        and wait until each listens."""
        new = [(s, r) for s in range(self.shards, shards) for r in range(FLEET_REPLICAS)]
        for node in new:
            self.start(*node)
        for node in new:
            self.wait_ready(*node)
        self.shards = max(self.shards, shards)

    def nodes(self):
        return [(s, r) for s in range(self.shards) for r in range(FLEET_REPLICAS)]

    def path(self, s: int, r: int, suffix: str = "") -> str:
        return os.path.join(self.root, f"s{s}n{r}{suffix}")

    def start(self, s: int, r: int, port: int = 0) -> None:
        port_file = self.path(s, r, ".port")
        if os.path.exists(port_file):
            os.remove(port_file)
        with open(self.path(s, r, ".log"), "ab") as err:
            self.procs[(s, r)] = subprocess.Popen(
                [sys.executable, "-m", "advanced_scrapper_tpu_torch.index.remote",
                 "--dir", self.path(s, r), "--port", str(port), "--port-file", port_file,
                 "--name", f"s{s}n{r}"],
                stdout=subprocess.DEVNULL, stderr=err)

    def wait_ready(self, s: int, r: int) -> None:
        port_file, proc = self.path(s, r, ".port"), self.procs[(s, r)]
        deadline = time.monotonic() + FLEET_READY_S
        while not os.path.exists(port_file):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"shard s{s}n{r} did not listen: " + open(
                    self.path(s, r, ".log"), errors="replace").read()[-2000:])
            time.sleep(0.02)
        self.ports[(s, r)] = int(open(port_file).read())

    @property
    def spec(self) -> str:
        return self.spec_of(FLEET_SHARDS)

    def spec_of(self, shards: int) -> str:
        """The spec of this fleet's first ``shards`` shards."""
        return ";".join("|".join(f"127.0.0.1:{self.ports[(s, r)]}" for r in range(FLEET_REPLICAS))
                        for s in range(shards))

    def kill(self, s: int, r: int) -> None:
        proc = self.procs[(s, r)]
        proc.kill()
        proc.wait(timeout=30)

    def restart(self, s: int, r: int) -> None:
        """The killed node back on its port, over its directory."""
        self.start(s, r, port=self.ports[(s, r)])
        self.wait_ready(s, r)

    def __enter__(self) -> "ShardFleet":
        return self

    def __exit__(self, *exc) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)


def rpc_latency(client) -> dict:
    """The fleet client's own RPC histograms (``astpu_fleet_rpc_seconds``,
    log2 buckets, interpolated inside the bucket): p50 and p99 in ms and
    the call count, by method and shard."""
    out: dict = {}
    for (sid, method), h in client._m_rpc_s.items():
        out.setdefault(method, {})[str(sid)] = dict(
            p50_ms=h.percentile(0.50) * 1e3, p99_ms=h.percentile(0.99) * 1e3, calls=h.count)
    return out


def fleet_counts(client) -> dict:
    return dict(failovers=client._m_failovers.value, promotions=client._m_promotions.value,
                spilled=client._m_spilled.value, replayed=client._m_replayed.value,
                degraded_probes=client._m_degraded.value)


def node_digests(fleet: ShardFleet, s: int, space: str) -> list:
    """``bucket_digests`` (and counts) of each node of shard ``s``, by RPC."""
    from advanced_scrapper_tpu_torch.index.remote import RemoteIndex

    out = []
    for r in range(FLEET_REPLICAS):
        node = RemoteIndex(("127.0.0.1", fleet.ports[(s, r)]), space=space)
        try:
            out.append(tuple(a.tolist() for a in node.digest()))
        finally:
            node.close()
    return out


def sorted_postings(index) -> list:
    keys, docs = index.dump_postings()
    order = np.lexsort((docs, keys))
    return [keys[order].tolist(), docs[order].tolist()]


def fleet_path(docs: list[bytes], card: str, local: dict, dev: str = "cuda") -> tuple[int, int]:
    """The persist mode on the index fleet: ``TpuBatchBackend(DedupConfig(
    stream_index="persist", index_fleet=spec))`` over a ``ShardFleet`` (2
    shards of a primary and a replica, each a process), on the records of
    ``persist_path`` in its two sessions, with telemetry on (the client's
    counters and RPC histograms).  Shard 1's primary is SIGKILLed after
    session 1's 16th batch and stays dark through session 2.  Checks: one segment-kernel launch per batch
    and no other; the annotations equal ``persist_path``'s local ones; each
    session's clients counted a failover and a promotion and spilled
    nothing; the killed node, restarted after session 2, is healed by
    ``repair_once`` and the shard's two nodes then give equal
    ``bucket_digests`` in both spaces.  Then card and CPU backends, each
    over a fleet of its own, on 2,048 ``rerank_corpus`` records in batches
    of 512 over two sessions (annotations and postings equal), and
    ``dedup_against_index`` over 4,096 ragged articles with
    ``open_stream_index`` on a fleet, equal to the local index's on the
    card.  Prints records/s beside ``persist_path``'s, the clients' RPC
    latency by method, ``fleet_status()`` and the share of each batch's
    host time in the index calls (the ``persist`` lap: the fan-out and its
    RPCs).  Returns the segment kernel's launches and the batches."""
    import shutil
    import tempfile

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend
    from advanced_scrapper_tpu_torch.index.fleet import open_fleet_index
    from advanced_scrapper_tpu_torch.obs import telemetry
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    t_phase = time.perf_counter()
    records = stream_records(docs, np.random.RandomState(17))
    telemetry.set_enabled(True)
    tmp = tempfile.mkdtemp(prefix="fleet-")
    try:
        with ShardFleet(os.path.join(tmp, "main")) as fleet:
            cfg = DedupConfig(stream_index="persist", index_fleet=fleet.spec)
            index_dir = os.path.join(tmp, "local")
            sessions, ann = [], []
            launches = batches = 0
            for si, part in enumerate((records[:PERSIST_SPLIT], records[PERSIST_SPLIT:])):
                t0 = time.perf_counter()
                backend = TpuBatchBackend(cfg, index_dir=index_dir, device=dev)
                open_s = time.perf_counter() - t0
                if si == 0:
                    process, done = backend._process, [0]

                    def killing(process=process, done=done):
                        out = process()
                        done[0] += 1
                        if done[0] == FLEET_KILL_AFTER:
                            fleet.kill(*KILLED)
                        return out

                    backend._process = killing
                got, rec = run_stream(backend, part)
                ann += got
                n = backend.stats.batches
                assert rec["launches"]["minhash_fold_segments"] == n == -(-len(part) // cfg.batch_size)
                assert sum(rec["launches"].values()) == n, rec["launches"]
                launches += n
                batches += n
                clients = {"bands": backend._pindex, "urls": backend._pindex_urls}
                counts = {sp: fleet_counts(c) for sp, c in clients.items()}
                for sp, c in counts.items():
                    assert c["failovers"] >= 1 and c["promotions"] >= 1, (sp, c)
                    assert c["spilled"] == 0, f"{sp} spilled while the replica lived: {c}"
                sessions.append(dict(
                    records=len(part), records_per_s=len(part) / rec["seconds"],
                    local_records_per_s=local["records_per_s"][si], **rec,
                    open_seconds=open_s,
                    fanout_share=rec["host_s"].get("persist", 0.0) / rec["seconds"],
                    persist_s_per_batch=rec["host_s"].get("persist", 0.0) / n,
                    counts=counts, rpc_latency={sp: rpc_latency(c) for sp, c in clients.items()},
                    fleet_status={sp: c.fleet_status() for sp, c in clients.items()}))
                backend.close()
            assert ann == local["annotations"], "the fleet's annotations differ from the local index's"
            # the killed node returns on its port and is healed by anti-entropy
            t0 = time.perf_counter()
            fleet.restart(*KILLED)
            before = {sp: node_digests(fleet, KILLED[0], sp) for sp in ("bands", "urls")}
            healed = {}
            for sp in ("bands", "urls"):
                client = open_fleet_index(cfg, index_dir, space=sp, digest_bits=FLEET_DIGEST_BITS)
                try:
                    healed[sp] = client.repair_once()
                finally:
                    client.close()
            after = {sp: [node_digests(fleet, s, sp) for s in range(FLEET_SHARDS)]
                     for sp in ("bands", "urls")}
            repair_s = time.perf_counter() - t0
            for sp in ("bands", "urls"):
                assert before[sp][0] != before[sp][1], f"{sp}: the killed node missed nothing"
                assert healed[sp]["pushed"] > 0 and healed[sp]["unmatched"] == 0, healed
                for s in range(FLEET_SHARDS):
                    assert after[sp][s][0] == after[sp][s][1], f"{sp} shard {s} still diverged"
        main_s = time.perf_counter() - t_phase

        # card vs CPU, each over a fleet of its own; dedup_against_index
        t0 = time.perf_counter()
        rrecs = stream_records(rerank_corpus(np.random.RandomState(13), STREAM_PARITY),
                               np.random.RandomState(14))
        runs = {}
        for name, device in (("card", dev), ("cpu", "cpu")):
            with ShardFleet(os.path.join(tmp, f"parity-{name}")) as pf:
                pcfg = DedupConfig(stream_index="persist", batch_size=STREAM_PARITY_BATCH,
                                   index_fleet=pf.spec)
                out = []
                for part in (rrecs[:PERSIST_PARITY_SPLIT], rrecs[PERSIST_PARITY_SPLIT:]):
                    b = TpuBatchBackend(pcfg, index_dir=os.path.join(tmp, f"parity-{name}-local"),
                                        device=device)
                    out += run_stream(b, part)[0]
                    dumps = [sorted_postings(ix) for ix in (b._pindex, b._pindex_urls)]
                    b.close()
                runs[name] = (out, dumps)
        adocs = ragged_corpus(np.random.RandomState(20), AGAINST_INDEX_ARTICLES)[0]
        half = AGAINST_INDEX_ARTICLES // 2
        with ShardFleet(os.path.join(tmp, "against")) as af:
            engine = NearDupEngine(DedupConfig(rerank=False, index_fleet=af.spec), device=dev)
            against = []
            for docs_part in (adocs[:half], adocs[half:]):  # the client reopened between
                index = engine.open_stream_index(os.path.join(tmp, "against-local"))
                against += engine.dedup_against_index(docs_part, index).tolist()
                index.close()
        parity = dict(annotations_equal=runs["card"][0] == runs["cpu"][0],
                      postings_equal=runs["card"][1] == runs["cpu"][1],
                      against_index_equal=against == local["against"],
                      near_dups=sum(1 for a in runs["card"][0] if a[2]),
                      against_index_hits=sum(a >= 0 for a in against),
                      seconds=time.perf_counter() - t0)
        assert all(parity[k] for k in ("annotations_equal", "postings_equal",
                                       "against_index_equal")), parity
        assert parity["near_dups"] and parity["against_index_hits"], parity
    finally:
        telemetry.set_enabled(None)
        shutil.rmtree(tmp, ignore_errors=True)
    log("fleet_path", records=len(records), batches=batches, shards=FLEET_SHARDS,
        replicas=FLEET_REPLICAS, killed="s{}n{}".format(*KILLED),
        kill_after_batches=FLEET_KILL_AFTER,
        sessions=sessions, repair=healed, repair_seconds=repair_s,
        digest_bits=FLEET_DIGEST_BITS, main_seconds=main_s, parity_records=STREAM_PARITY,
        parity_batch=STREAM_PARITY_BATCH, against_index_articles=AGAINST_INDEX_ARTICLES,
        parity=parity, seconds=time.perf_counter() - t_phase, card=card)
    return launches, batches


RESHARD_BATCHES = 32  # persist_path's session 1: 32 batches of 1,024 records
RESHARD_SHARDS = 4  # the scale-out's target; the scale-in merges back to FLEET_SHARDS
RESHARD_PROBE_ROWS = 4096  # key rows a fresh client probes after each transition
RESHARD_JOIN_S = 600.0  # the most the split may run on past the stream's end
#: the autoscaler's scripted input: one observation a batch on a clock of
#: ``RESHARD_TICK_S`` a batch, the pressure in the middle band until batch
#: ``RESHARD_PRESSURE_AT`` and in the scale-out band from there; armed at
#: batch 5, it holds past the 30 s dwell at batch 8
RESHARD_TICK_S, RESHARD_DWELL_S, RESHARD_PRESSURE_AT = 10.0, 30.0, 5
RESHARD_COOLDOWN_S = 300.0
RESHARD_SCALE_AT = RESHARD_PRESSURE_AT + int(RESHARD_DWELL_S // RESHARD_TICK_S)


def counter_total(name: str, fleet_id: str) -> float:
    """An always-on ``astpu_reshard_*`` counter of one fleet client."""
    from advanced_scrapper_tpu_torch.obs import telemetry

    return sum(m.value for m in telemetry.REGISTRY.find(name)
               if m.labels.get("fleet") == fleet_id)


def percentiles_ms(seconds: list[float]) -> dict:
    a = np.asarray(seconds, np.float64) * 1e3
    if not a.size:
        return dict(n=0, p50_ms=None, p99_ms=None, max_ms=None)
    return dict(n=int(a.size), p50_ms=float(np.percentile(a, 50)),
                p99_ms=float(np.percentile(a, 99)), max_ms=float(a.max()))


def reshard_space(client, space: str, spec: str) -> dict:
    """``client.reshard_to(spec)`` for one key space, timed, with the write
    gate's hold time per flip (each ``_flip_range`` call holds the gate from
    its start to its end); checks that every range flipped, none was voided
    and the migration WAL ended ``done`` with every range retired."""
    from advanced_scrapper_tpu_torch.index.reshard import ReshardLedger, ledger_path

    holds: list[float] = []
    flip = client._flip_range

    def timed_flip(*args, **kw):
        t0 = time.perf_counter()
        try:
            return flip(*args, **kw)
        finally:
            holds.append(time.perf_counter() - t0)

    pages0 = counter_total("astpu_reshard_pages_total", client._fid)
    client._flip_range = timed_flip
    t0 = time.perf_counter()
    try:
        stats = client.reshard_to(spec)
    finally:
        del client._flip_range
    seconds = time.perf_counter() - t0
    assert stats["flips"] == stats["ranges"] > 0 and stats["voided"] == 0, (space, stats)
    ledger = ReshardLedger.load(ledger_path(client.spill_dir, space))
    assert ledger.phase == "done" and ledger.all_retired(), (space, ledger.doc["phase"])
    return dict(space=space, seconds=seconds, arcs=stats["ranges"], flips=stats["flips"],
                voided=stats["voided"], digest_retries=stats["digest_retries"],
                migrated_postings=stats["migrated_postings"],
                pages=counter_total("astpu_reshard_pages_total", client._fid) - pages0,
                gate_hold=percentiles_ms(holds), spilled=fleet_counts(client)["spilled"])


def reshard_path(fleet: ShardFleet, docs: list[bytes], card: str, local: dict,
                 dev: str = "cuda") -> tuple[int, int]:
    """Live N→M resharding under the stream: the persist mode on ``fleet``
    (2 shards of a primary and a replica, each a process) over the first
    ``RESHARD_BATCHES`` batches of ``persist_path``'s records, with telemetry
    on.  An ``Autoscaler`` observes one scripted pressure sample a batch on
    an injected clock and fires ``scale_out(4)`` after batch
    ``RESHARD_SCALE_AT``: the callback starts 4 more shard processes and
    runs ``reshard_to`` the 4 × 2 spec on a thread of its own, the ``bands``
    space and then the ``urls`` space (a node's ``reshard_mark`` covers
    every space it hosts), while the batches keep flowing.  After the
    stream, two more samples make it fire ``scale_in(2)``, which merges the
    fleet back to 2 × 2 through fresh clients.  Checks: one segment-kernel
    launch per batch and no other; the annotations equal ``persist_path``'s
    session 1; each reshard flips every range and voids none, and its
    ledger ends ``done`` with every range retired; after each transition a
    fresh client on the spill directory gives the probes of session 1's
    local index over ``RESHARD_PROBE_ROWS`` band-key rows and their urls;
    nothing is spilled; the two replicas of each shard give equal
    ``bucket_digests`` in both spaces.  Prints records/s inside the split's
    window and outside it, each reshard's seconds, arcs, pages, migrated
    postings and the gate's hold time per flip, and the clients' RPC
    latency by method.  Returns the segment kernel's launches and the
    batches."""
    import threading

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend
    from advanced_scrapper_tpu_torch.index import PersistentIndex
    from advanced_scrapper_tpu_torch.index.fleet import open_fleet_index
    from advanced_scrapper_tpu_torch.obs import telemetry
    from advanced_scrapper_tpu_torch.runtime.autoscaler import Autoscaler
    from advanced_scrapper_tpu_torch.utils.bloom import hash_key64, pack_keys64

    t_phase = time.perf_counter()
    cfg = DedupConfig(stream_index="persist", index_fleet=fleet.spec)
    records = stream_records(docs, np.random.RandomState(17))[:RESHARD_BATCHES * cfg.batch_size]
    index_dir = os.path.join(fleet.root, "reshard-local")
    telemetry.set_enabled(True)
    backend = TpuBatchBackend(cfg, index_dir=index_dir, device=dev)
    clients = {"bands": backend._pindex, "urls": backend._pindex_urls}
    window: dict = {}
    box: dict = {}
    split: list[dict] = []
    merge: list[dict] = []

    def run_split(spec: str) -> None:
        try:
            for sp, client in clients.items():
                split.append(reshard_space(client, sp, spec))
        except BaseException as e:  # raised on the main thread after the stream
            box["error"] = e
        finally:
            window["end"] = time.perf_counter()

    def scale_out(target: int) -> None:
        window["start"] = time.perf_counter()
        fleet.grow(target)
        window["grow_seconds"] = time.perf_counter() - window["start"]
        box["thread"] = threading.Thread(target=run_split, args=(fleet.spec_of(target),),
                                         daemon=True)
        box["thread"].start()

    def scale_in(target: int) -> None:
        cfg_now = DedupConfig(stream_index="persist", index_fleet=fleet.spec_of(fleet.shards))
        for sp in ("bands", "urls"):
            client = open_fleet_index(cfg_now, index_dir, space=sp)
            try:
                merge.append(reshard_space(client, sp, fleet.spec_of(target)))
                merge[-1]["rpc_latency"] = rpc_latency(client)
            finally:
                client.close()

    clock = [0.0]
    scaler = Autoscaler(FLEET_SHARDS, scale_out=scale_out, scale_in=scale_in,
                        dwell_s=RESHARD_DWELL_S, cooldown_s=RESHARD_COOLDOWN_S,
                        min_shards=FLEET_SHARDS, max_shards=RESHARD_SHARDS,
                        clock=lambda: clock[0], name="reshard_path")
    process, ends, fired = backend._process, [], []

    def observed():
        out = process()
        ends.append(time.perf_counter())
        done = len(ends)
        clock[0] = done * RESHARD_TICK_S
        pressure = 0.9 if done >= RESHARD_PRESSURE_AT else 0.35
        fired.append(scaler.observe(pressure, now=clock[0]))
        return out

    backend._process = observed
    try:
        t_stream = time.perf_counter()
        got, rec = run_stream(backend, records)
        n = backend.stats.batches
        assert rec["launches"]["minhash_fold_segments"] == n == RESHARD_BATCHES, rec["launches"]
        assert sum(rec["launches"].values()) == n, rec["launches"]
        assert fired.index("out") + 1 == RESHARD_SCALE_AT, fired
        assert got == local["annotations"][:len(records)], \
            "the resharded fleet's annotations differ from the local index's"
        box["thread"].join(timeout=RESHARD_JOIN_S)
        assert not box["thread"].is_alive(), "the split did not finish"
        if "error" in box:
            raise box["error"]
        stream_counts = {sp: fleet_counts(c) for sp, c in clients.items()}
        stream_latency = {sp: rpc_latency(c) for sp, c in clients.items()}
        stream_status = {sp: c.fleet_status() for sp, c in clients.items()}
        rng = np.random.RandomState(23)
        sample = np.sort(rng.choice(len(records), RESHARD_PROBE_ROWS, replace=False))
        _s, wide = backend.engine.signatures_and_keys(
            [records[i]["article"] for i in sample], wide=True, sync_sigs=False)
        rows = {"bands": pack_keys64(wide),
                "urls": np.array([[hash_key64(records[i]["url"])] for i in sample
                                  if records[i]["url"]], np.uint64)}
    finally:
        backend._process = process
        backend.close()
    # records/s: a batch's interval runs from the previous batch's end
    starts = [t_stream] + ends[:-1]
    inside = [i for i, e in enumerate(ends) if window["start"] <= e <= window["end"]]
    outside = [i for i in range(len(ends)) if i not in inside]

    def rate(ix: list[int]) -> float | None:
        secs = sum(ends[i] - starts[i] for i in ix)
        return len(ix) * cfg.batch_size / secs if ix else None

    oracle = {sp: PersistentIndex(os.path.join(local["session1"], sp), read_only=True)
              for sp in ("bands", "urls")}
    try:
        want = {sp: np.asarray(oracle[sp].probe_batch(rows[sp])) for sp in rows}
    finally:
        for ix in oracle.values():
            ix.close()

    def check_transition(shards: int) -> dict:
        """A fresh client at ``shards`` shards on the spill directory: its
        probes equal session 1's local index's, nothing spilled; every
        shard's two nodes give equal digests in both spaces."""
        tcfg = DedupConfig(stream_index="persist", index_fleet=fleet.spec_of(shards))
        hits = {}
        for sp in ("bands", "urls"):
            client = open_fleet_index(tcfg, index_dir, space=sp)
            try:
                probed = np.asarray(client.probe_batch(rows[sp]))
                assert client._route_shards == shards
            finally:
                client.close()
            assert (probed == want[sp]).all(), f"{sp} at {shards} shards: probes differ"
            hits[sp] = int((probed >= 0).sum())
            for s in range(fleet.shards):
                d = node_digests(fleet, s, sp)
                assert d[0] == d[1], f"{sp} shard {s}: the replicas diverged"
        return hits

    after_split = check_transition(RESHARD_SHARDS)
    clock[0] = max(clock[0], RESHARD_SCALE_AT * RESHARD_TICK_S + RESHARD_COOLDOWN_S)
    assert scaler.observe(0.05, now=clock[0], slo_ok=True) == "none"
    clock[0] += RESHARD_DWELL_S
    assert scaler.observe(0.05, now=clock[0], slo_ok=True) == "in"
    after_merge = check_transition(FLEET_SHARDS)
    for r in split + merge:
        assert r["spilled"] == 0, r
    for sp, c in stream_counts.items():
        assert c["spilled"] == 0 and c["failovers"] == 0, (sp, c)
    status = scaler.status()
    assert status["shards"] == FLEET_SHARDS, status
    assert scaler._m_trans["out"].value == scaler._m_trans["in"].value == 1
    telemetry.set_enabled(None)
    log("reshard_path", records=len(records), batches=n, shards=FLEET_SHARDS,
        replicas=FLEET_REPLICAS, grown_to=RESHARD_SHARDS, scale_out_after_batch=RESHARD_SCALE_AT,
        autoscaler=dict(status=status, decisions=fired,
                        blocked={k: c.value for k, c in scaler._m_blocked.items()}),
        grow_seconds=window["grow_seconds"], window_seconds=window["end"] - window["start"],
        batches_in_window=len(inside), records_per_s_in_window=rate(inside),
        records_per_s_outside=rate(outside),
        local_records_per_s=local["records_per_s"][0],
        stream_seconds=rec["seconds"], split=split, merge=merge,
        probe_rows={sp: len(r) for sp, r in rows.items()},
        probe_hits=dict(after_split=after_split, after_merge=after_merge),
        counts=stream_counts, rpc_latency=stream_latency, fleet_status=stream_status,
        seconds=time.perf_counter() - t_phase, card=card)
    return n, n


GATEWAY_BATCHES, GATEWAY_BATCH = 8, 1024  # each of tenants a and b
GATEWAY_SHARED = 256  # of a's articles repeated in each of b's batches
GATEWAY_Q_BATCHES, GATEWAY_Q_BATCH = 4, 256
GATEWAY_Q_RATE = 3.0  # tenant q's quota, requests/s, burst 1


def gateway_path(fleet: ShardFleet, card: str, dev: str = "cuda") -> tuple[int, int]:
    """The multi-tenant gateway on the merged 2 × 2 fleet: a process of
    its own (``python -m advanced_scrapper_tpu_torch.service.gateway``),
    tenants ``a`` and ``b`` provisioned on first sight, ``q`` declared with
    a quota of ``GATEWAY_Q_RATE`` requests/s.  ``a`` and ``b`` each submit
    ``GATEWAY_BATCHES`` batches of 1,024 ``rerank_corpus`` articles, their
    keys computed on the card (``signatures_and_keys(wide=True,
    sync_sigs=False)``, packed by ``pack_keys64``) and sent by ``RpcClient``
    as ``submit_batch`` with ``allocate: true``; each of ``b``'s batches
    repeats ``GATEWAY_SHARED`` of ``a``'s articles.  Checks: one
    segment-kernel launch per batch and no other; each tenant's
    attributions equal a local ``PersistentIndex``'s fed the same rows and
    ids; every attribution of ``b`` names one of ``b``'s own ids (the
    allocators are per tenant space, so both draw from 0), and the rows
    ``b`` copied from ``a`` are first sight in ``b`` wherever its local
    index says so; a client without retries gets ``RpcOverloaded`` from
    ``q``'s bucket, and a retrying one lands the rest with the local
    index's attributions; ``tenant_status`` counts each tenant's postings
    as its local index does; ``wipe_tenant("b")`` drops exactly ``b``'s
    postings on every node and leaves the others; SIGTERM stops the
    gateway with status 0.  Prints ``submit_batch`` p50/p99 per tenant and
    articles/s end to end with the keys' share.  Returns the segment
    kernel's launches and the batches."""
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.index import PersistentIndex
    from advanced_scrapper_tpu_torch.net.rpc import RpcClient, RpcOverloaded
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
    from advanced_scrapper_tpu_torch.utils.bloom import pack_keys64

    t_phase = time.perf_counter()
    root = os.path.join(fleet.root, "gateway")
    os.makedirs(root)
    port_file, log_path = os.path.join(root, "port"), os.path.join(root, "log")
    cmd = [sys.executable, "-m", "advanced_scrapper_tpu_torch.service.gateway",
           "--port-file", port_file, "--name", "chip-gateway", "--stats-interval", "0",
           "--tenant", f"q,rate={GATEWAY_Q_RATE},burst=1"]
    for s in range(FLEET_SHARDS):
        cmd += ["--shard", ",".join(f"127.0.0.1:{fleet.ports[(s, r)]}"
                                    for r in range(FLEET_REPLICAS))]
    engine = NearDupEngine(DedupConfig(stream_index="persist"), device=dev)
    rng = np.random.RandomState(43)
    a_docs = rerank_corpus(np.random.RandomState(41), GATEWAY_BATCHES * GATEWAY_BATCH)
    b_docs = rerank_corpus(np.random.RandomState(42), GATEWAY_BATCHES * GATEWAY_BATCH)
    q_docs = rerank_corpus(np.random.RandomState(44), GATEWAY_Q_BATCHES * GATEWAY_Q_BATCH)
    batches = {"a": [], "b": []}
    copied = []  # per b batch: the rows copied from a
    for k in range(GATEWAY_BATCHES):
        lo, hi = k * GATEWAY_BATCH, (k + 1) * GATEWAY_BATCH
        a_batch, b_batch = a_docs[lo:hi], list(b_docs[lo:hi])
        rows = np.sort(rng.choice(GATEWAY_BATCH, GATEWAY_SHARED, replace=False))
        for r, src in zip(rows, rng.choice(GATEWAY_BATCH, GATEWAY_SHARED, replace=False)):
            b_batch[r] = a_batch[src]
        batches["a"].append(a_batch)
        batches["b"].append(b_batch)
        copied.append(rows)
    with open(log_path, "ab") as err:
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err)
    locals_: dict = {}
    rc = strict = retrying = None
    try:
        deadline = time.monotonic() + FLEET_READY_S
        while not os.path.exists(port_file):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the gateway did not listen: "
                                   + open(log_path, errors="replace").read()[-2000:])
            time.sleep(0.02)
        addr = ("127.0.0.1", int(open(port_file).read()))
        rc = RpcClient(addr, timeout=60.0)
        locals_ = {t: PersistentIndex(os.path.join(root, f"local-{t}")) for t in ("a", "b", "q")}
        submit_s: dict[str, list[float]] = {"a": [], "b": [], "q": []}
        keys_s = 0.0
        attrs: dict[str, list] = {"a": [], "b": [], "q": []}
        ids_of: dict[str, list] = {"a": [], "b": [], "q": []}
        want: dict[str, list] = {"a": [], "b": [], "q": []}

        def keys_of(texts) -> np.ndarray:
            nonlocal keys_s
            t0 = time.perf_counter()
            _s, wide = engine.signatures_and_keys(texts, wide=True, sync_sigs=False)
            keys = pack_keys64(wide)
            keys_s += time.perf_counter() - t0
            return keys

        local_s = 0.0

        def landed(t: str, keys, resp, arrays, seconds: float) -> None:
            nonlocal local_s
            attr, ids = (np.asarray(x) for x in arrays)
            assert resp["allocated"] and resp["n"] == len(keys) == len(ids), resp
            submit_s[t].append(seconds)
            attrs[t].append(attr.astype(np.int64))
            ids_of[t].append(ids.astype(np.uint64))
            t0 = time.perf_counter()
            want[t].append(np.asarray(locals_[t].check_and_add_batch(keys, ids), np.int64))
            local_s += time.perf_counter() - t0

        reset_launches()
        t_ab = time.perf_counter()
        for k in range(GATEWAY_BATCHES):
            for t in ("a", "b"):
                keys = keys_of(batches[t][k])
                t0 = time.perf_counter()
                resp, arrays = rc.call("submit_batch", {"tenant": t, "allocate": True}, [keys])
                landed(t, keys, resp, arrays, time.perf_counter() - t0)
        # end to end without the local indexes' own time
        ab_seconds, ab_keys_s = time.perf_counter() - t_ab - local_s, keys_s
        q_keys = [keys_of(q_docs[k * GATEWAY_Q_BATCH:(k + 1) * GATEWAY_Q_BATCH])
                  for k in range(GATEWAY_Q_BATCHES)]
        launches = read_launches()
        n_batches = 2 * GATEWAY_BATCHES + GATEWAY_Q_BATCHES
        assert launches["minhash_fold_segments"] == n_batches, launches
        assert sum(launches.values()) == n_batches, launches
        # q: a client without retries until the bucket refuses, then one that retries
        strict = RpcClient(addr, timeout=60.0, retries=0)
        retrying = RpcClient(addr, timeout=60.0, retries=8)
        refused, k = None, 0
        t_q = time.perf_counter()
        while k < GATEWAY_Q_BATCHES:
            client = retrying if refused else strict
            t0 = time.perf_counter()
            try:
                resp, arrays = client.call("submit_batch", {"tenant": "q", "allocate": True},
                                           [q_keys[k]])
            except RpcOverloaded as e:
                assert refused is None and e.retry_after and e.retry_after > 0, e
                refused = dict(batch=k, retry_after_s=e.retry_after)
                continue
            landed("q", q_keys[k], resp, arrays, time.perf_counter() - t0)
            k += 1
        q_seconds = time.perf_counter() - t_q
        assert refused is not None, "q's bucket never refused"
        for t in attrs:
            got, exp = np.concatenate(attrs[t]), np.concatenate(want[t])
            assert np.array_equal(got, exp), f"tenant {t}: attributions differ from its local index"
        b_attr, b_ids = np.concatenate(attrs["b"]), np.concatenate(ids_of["b"])
        assert set(b_attr[b_attr >= 0].tolist()) <= set(b_ids.tolist())
        copied_first = sum(int((attrs["b"][k][rows] < 0).sum()) for k, rows in enumerate(copied))
        assert copied_first > 0, "every row b copied from a was a dup in b"
        status = rc.call("tenant_status", {})[0]["tenants"]
        postings = {}
        for t, ix in locals_.items():
            st = ix.stats()
            postings[t] = int(st["segment_postings"]) + int(st["wal_postings"])
            fresh = sum(int((a < 0).sum()) for a in want[t])
            assert status[t]["postings"] == postings[t] == fresh * engine.params.num_bands, \
                (t, status[t]["postings"], postings[t], fresh)
        dropped = rc.call("wipe_tenant", {"tenant": "b"})[0]["dropped"]
        after = rc.call("tenant_status", {})[0]["tenants"]
        assert dropped == FLEET_REPLICAS * postings["b"], (dropped, postings["b"])
        assert after["b"]["postings"] == 0 and all(
            after[t]["postings"] == postings[t] for t in ("a", "q")), after
        probe = np.asarray(rc.call("probe_batch", {"tenant": "b"},
                                   [keys_of(batches["b"][0])])[1][0])
        assert (probe < 0).all(), "b's postings survived its wipe"
    finally:
        for c in (rc, strict, retrying):
            if c is not None:
                c.close()
        for ix in locals_.values():
            ix.close()
        proc.terminate()
        try:
            rc_gw = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
            rc_gw = None
    assert rc_gw == 0, f"the gateway exited {rc_gw} on SIGTERM"
    articles = 2 * GATEWAY_BATCHES * GATEWAY_BATCH
    log("gateway_path", tenants=sorted(attrs), batches=n_batches, articles=articles,
        shared_per_b_batch=GATEWAY_SHARED, q_rate=GATEWAY_Q_RATE, q_refused=refused,
        q_seconds=q_seconds, copied_first_sight_in_b=copied_first,
        submit_batch={t: percentiles_ms(s) for t, s in submit_s.items()},
        articles_per_s=articles / ab_seconds, keys_share=ab_keys_s / ab_seconds,
        postings=postings, wiped=dropped, dups={t: int(sum((a >= 0).sum() for a in v))
                                              for t, v in attrs.items()},
        seconds=time.perf_counter() - t_phase, card=card)
    return launches["minhash_fold_segments"], n_batches


def elastic_paths(docs: list[bytes], card: str, local: dict,
                  dev: str = "cuda") -> tuple[tuple[int, int], tuple[int, int]]:
    """``reshard_path`` and then ``gateway_path`` on one ``ShardFleet``;
    removes ``persist_path``'s copy of session 1.  Returns each phase's
    launches and batches."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="elastic-")
    try:
        with ShardFleet(os.path.join(tmp, "fleet")) as fleet:
            resharded = reshard_path(fleet, docs, card, local, dev)
            served = gateway_path(fleet, card, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(local["session1"], ignore_errors=True)
    return resharded, served


CROSS_A, CROSS_B, CROSS_STORE = 32768, 16384, 16384  # articles per source
CROSS_COPIES = 0.10  # syndicated copies of the first source in the others
CROSS_PARITY = (1024, 512, 512)  # the card-vs-CPU cut of the sources


def bulk_sqlite(path: str):
    """The port's sqlite backend without an fsync or a journal file a
    commit: the store is set-up data, written anew on every run, one
    commit an article."""
    from advanced_scrapper_tpu_torch.storage.backends import SqliteBackend

    class Bulk(SqliteBackend):
        def connect(self):
            conn = super().connect()
            conn.execute("PRAGMA synchronous=OFF")
            conn.execute("PRAGMA journal_mode=MEMORY")
            return conn

    return Bulk(path)


def write_sources(root: str, parts: list[list[tuple[str, str]]]) -> list[str]:
    """Two success CSVs (``url,title,article``) and a sqlite store written
    through the port's ``ArticleStore.store``."""
    import csv

    from advanced_scrapper_tpu_torch.storage.stores import ArticleStore

    paths = []
    for name, rows in (("success_a.csv", parts[0]), ("success_b.csv", parts[1])):
        p = os.path.join(root, name)
        with open(p, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["url", "title", "article"])
            w.writerows((url, "t", text) for url, text in rows)
        paths.append(p)
    db = os.path.join(root, "store.db")
    store = ArticleStore(bulk_sqlite(db))
    for url, text in parts[2]:
        store.store(url, {"article": text, "title": "t", "datetime": "2020-06-01 12:00:00"})
    return paths + [db]


def cross_source_path(card: str) -> tuple[int, int]:
    """``cross_source_dedup`` at the defaults (the exact stream index) over
    three sources made from the ragged corpus (seed 23): a success CSV of
    32,768 articles, a second CSV and a sqlite store of 16,384 each, 10%
    of each of the last two verbatim or mutated (0.5% of bytes) copies of
    first-source articles under other urls.  Every planted copy whose
    source is eligible (a url, kept or a near-dup, at least a shingle of
    text) is ``near_dup`` or ``exact_dup`` in the manifest; one segment-
    kernel launch per batch and no other.  Then a 2,048-article cut of the
    sources on the card and on the CPU: byte-equal manifests.  Returns the
    launches and the batches."""
    import csv
    import shutil
    import tempfile

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.pipeline.cross_source import cross_source_dedup, load_source
    from advanced_scrapper_tpu_torch.storage.csvio import AppendCsv

    dev = torch.device("cuda")
    rng = np.random.RandomState(23)
    docs = [d.decode("ascii") for d in ragged_corpus(rng, CROSS_A + CROSS_B + CROSS_STORE)[0]]
    parts: list[list[tuple[str, str]]] = [[], [], []]
    copies: dict[str, str] = {}  # copy url → source url
    for i, text in enumerate(docs):
        if i < CROSS_A:
            parts[0].append((f"https://a.example/{i}/article.html", text))
            continue
        p = 1 if i < CROSS_A + CROSS_B else 2
        url = f"https://{'bc'[p - 1]}.example/{i}/article.html"
        if rng.rand() < CROSS_COPIES:
            j = rng.randint(CROSS_A)
            src_url, text = parts[0][j]
            if rng.rand() < 0.5:
                raw = bytearray(text.encode("ascii"))
                for _ in range(max(1, len(raw) // 200)):
                    raw[rng.randint(len(raw))] = rng.randint(32, 127)
                text = raw.decode("ascii")
            copies[url] = src_url
        parts[p].append((url, text))
    n = sum(map(len, parts))
    tmp = tempfile.mkdtemp(prefix="cross-source-")
    try:
        t0 = time.perf_counter()
        sources = write_sources(tmp, parts)
        write_sources_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_read = sum(1 for s in sources for _ in load_source(s))
        read_s = time.perf_counter() - t0
        assert n_read == n, (n_read, n)
        manifest = os.path.join(tmp, "manifest.csv")
        warm_dir = os.path.join(tmp, "warm")
        os.makedirs(warm_dir)
        cross_source_dedup(write_sources(warm_dir, [parts[0][:STREAM_WARM], [], []]),
                           os.path.join(warm_dir, "manifest.csv"), device=dev)
        reset_launches()
        t0 = time.perf_counter()
        stats = cross_source_dedup(sources, manifest, cfg=DedupConfig(), device=dev)
        seconds = time.perf_counter() - t0
        got = read_launches()
        batches = -(-n // DedupConfig().batch_size)
        assert got["minhash_fold_segments"] == batches and sum(got.values()) == batches, got
        with open(manifest, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        t0 = time.perf_counter()
        with AppendCsv(os.path.join(tmp, "rewrite.csv"), ["url", "source", "status",
                                                          "dup_of"]) as out:
            for row in rows:
                out.write_row(row)
        write_manifest_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    status = {r["url"]: r["status"] for r in rows}
    assert len(rows) == n == stats["total"]
    checked = [u for u, s in copies.items() if status[s] != "exact_dup"]
    missed = [u for u in checked if status[u] not in ("near_dup", "exact_dup")]
    assert checked and not missed, f"{len(missed)} of {len(checked)} planted copies missed"

    # a cut of the sources on the card and on the CPU: byte-equal manifests
    cut = [p[:k] for p, k in zip(parts, CROSS_PARITY)]
    outs = []
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cross-parity-")
    try:
        cut_sources = write_sources(tmp, cut)
        for device in (dev, "cpu"):
            out = os.path.join(tmp, f"manifest-{device}.csv")
            st = cross_source_dedup(cut_sources, out, cfg=DedupConfig(), device=device)
            outs.append((open(out, "rb").read(), st))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    parity_equal = outs[0] == outs[1]
    assert parity_equal, "card and CPU manifests differ"
    log("cross_source_path", articles=n, sources={"success_a.csv": CROSS_A,
        "success_b.csv": CROSS_B, "store.db": CROSS_STORE}, planted_copies=len(copies),
        planted_checked=len(checked), seconds=seconds, articles_per_s=n / seconds,
        stats=stats, write_sources_seconds=write_sources_s, read_sources_seconds=read_s,
        write_manifest_seconds=write_manifest_s, launches=got, batches=batches,
        parity_articles=sum(CROSS_PARITY), parity_manifests_equal=parity_equal,
        parity_stats=outs[0][1], parity_seconds=time.perf_counter() - t0, card=card)
    return got["minhash_fold_segments"], batches


#: the OPH kernels' rows of the ``kernels`` line
OPH_SOURCE = "advanced_scrapper_tpu_torch/csrc/oph.cu"
OPH_RAW = "advanced_scrapper_tpu/ops/oph.py:61 (_raw_impl, jnp)"
OPH_DENSIFY = "advanced_scrapper_tpu/ops/oph.py:91 (densify, jnp)"


def oph_launches() -> dict[str, int]:
    return {k: v for k, v in read_launches().items() if k.startswith("oph_")}


def raw_oph_rows(rng: np.random.RandomState, rows: int, P: int, fill: float) -> np.ndarray:
    """``uint32[rows, P]`` raw OPH rows with about ``fill`` of the bins filled."""
    sig = rng.randint(0, 0xFFFFFFFF, size=(rows, P), dtype=np.uint64).astype(np.uint32)
    sig[rng.rand(rows, P) >= fill] = 0xFFFFFFFF
    return sig


def densify_edge_rows(P: int) -> np.ndarray:
    """All-empty, one-filled (first, middle, last bin), all-filled,
    alternating (even and odd bins), and wrap-around rows (only the first
    bins filled, so the last bins borrow across the end)."""
    E = 0xFFFFFFFF
    rows = [np.full(P, E, np.uint64) for _ in range(9)]
    rows[1][0] = 5
    rows[2][P // 2] = 7
    rows[3][P - 1] = 11
    rows[4][:] = np.arange(P) + 100
    rows[5][0::2] = np.arange(0, P, 2) + 3
    rows[6][1::2] = np.arange(1, P, 2) + 9
    rows[7][:2] = [E - 1, 1]
    rows[8][P // 4] = E - 1  # a value whose offset wraps past 2^32
    return np.stack(rows).astype(np.uint32)


def check_oph_vs_plain(params, cfg, dev, kernels=None) -> dict:
    """Phase 3, OPH: each entry point bit-equal to its plain version.
    ``oph_fold_segments`` on articles of edge lengths among random ones at
    every start residue mod 16, segments of the engine's size, the
    kernel's largest, 37 and 8 (some 50,000 descriptors a launch, so a
    warp's range holds several and cuts owner runs), k = 5, 9 and 1 and
    2, 64 and 1,024 bins, two chunks into one accumulator that starts part
    filled, shared and dropped owners, one article of 100,000 bytes, each
    chunk's text ending at its last shingle (the allocation's last byte);
    ``oph_sig`` and ``oph_fold`` at every width bucket (and k = 9, 1; P =
    2, 64, 1,024) on tiles of 64 rows (the chunker's tail tiles) and 67,
    the last row full; ``oph_densify`` on all-empty, one-filled,
    all-filled, alternating and wrap-around rows among random ones at P =
    128 and 64.  ``kernels``: an object with the three fold entry points
    of ``ops/oph_cuda.py`` (``oph_probe.py`` passes a built variant's);
    the wrappers' launches are counted only when it is not given."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.cpu.hostbatch import segment_ranges
    from advanced_scrapper_tpu_torch.ops import oph, oph_cuda
    from advanced_scrapper_tpu_torch.ops.minhash import SEGMENT_SHINGLES, fold_segments_plain
    from advanced_scrapper_tpu_torch.ops.pack import pack_tile
    from advanced_scrapper_tpu_torch.pipeline.dedup import _prewarm_widths

    def same(x, y) -> bool:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.view(np.int32)).to(dev).view(torch.uint32)

    kern = kernels or oph_cuda
    rng = np.random.RandomState(17)
    before = oph_launches()
    residues: set[int] = set()
    p2, p64 = make_params(num_perm=2, num_bands=2), make_params(num_perm=64, num_bands=16)
    p1024 = make_params(num_perm=1024, num_bands=16)
    runs = [(params, SEGMENT_SHINGLES), (params, oph_cuda.MAX_SEGMENT_SHINGLES),
            (params, 37), (params, 8), (make_params(shingle_k=9), SEGMENT_SHINGLES),
            (make_params(shingle_k=1), 37), (p64, SEGMENT_SHINGLES), (p2, SEGMENT_SHINGLES),
            (p1024, 37)]
    descriptors = []
    for p, S in runs:
        k, P = p.shingle_k, p.num_perm
        edge = [0, 1, k - 1, k, S + k - 2, S + k - 1, S + k, 3 * S, 100_000]
        lens = np.r_[edge, rng.randint(0, 5000, size=300)]
        rng.shuffle(lens)
        n_docs = len(lens)
        half = n_docs // 2
        lens[[half - 1, n_docs - 1]] = [2 * k + 3, 3 * S + k]  # each chunk ends in shingles
        docs = [rng.randint(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lens]
        owners = rng.randint(0, n_docs + 2, size=n_docs)  # shared and dropped owners
        owners[:2] = [n_docs - 1, n_docs]
        owners[[half - 1, n_docs - 1]] = [1, 2]
        start = on_card(raw_oph_rows(rng, n_docs, P, 0.3))
        run_k, run_p = start.clone(), start.clone()
        for lead, part in ((3, slice(0, half)), (0, slice(half, n_docs))):  # two chunks
            text, off, ln = flat_text(docs[part], lead)
            seg = segment_ranges(off, ln, owners[part], k, S)
            assert seg[0][-1] + seg[1][-1] + k - 1 == len(text)
            residues.update((seg[0] % 16).tolist())
            descriptors.append(len(seg[0]))
            full = torch.from_numpy(np.r_[np.zeros(5, np.uint8), text]).to(dev)
            text_d = full[5:]  # starts off a 16-byte boundary, ends the allocation
            host = [torch.from_numpy(x).pin_memory() for x in seg]
            card = [x.to(dev) for x in host]
            kern.oph_fold_segments(run_k, text_d, *(card if lead else host), k)
            fold_segments_plain(run_p, text_d, *card, p,
                                signatures=oph.oph_raw_signatures_plain)
        torch.cuda.synchronize()
        assert same(run_k, run_p), f"oph_fold_segments differs from plain at S={S}, k={k}, P={P}"
    assert residues == set(range(16)), sorted(residues)
    tiles = 0
    for p, w in ([(params, w) for w in _prewarm_widths(cfg)]
                 + [(make_params(shingle_k=kk), w) for kk in (9, 1) for w in (64, 4096)]
                 + [(p64, 512), (p2, 4096), (p1024, 512)]):
        for rows in (64, 67):
            k, P = p.shingle_k, p.num_perm
            tok = rng.randint(0, 256, size=(rows, w)).astype(np.uint8)
            lens = rng.randint(0, w + 1, size=rows).astype(np.int32)
            lens[:4] = [0, k - 1, w, k]  # empty, below k, full width, one shingle
            lens[-1] = w  # the tile's last byte is a shingle's
            tok_d, lens_d = torch.from_numpy(tok).to(dev), torch.from_numpy(lens).to(dev)
            got = kern.oph_sig(tok_d, lens_d, P, k)
            want = oph.oph_raw_signatures_plain(tok_d, lens_d, p)
            assert same(got, want), f"oph_sig differs from plain at {rows}x{w}, k={k}, P={P}"
            n_art = max(rows // 3, 1)
            packed = torch.from_numpy(pack_tile(tok, lens, rng.randint(0, n_art, size=rows)
                                                .astype(np.int32))).to(dev)
            start = on_card(raw_oph_rows(rng, n_art, P, 0.3))
            run_k, run_p = start.clone(), start.clone()
            kern.oph_fold(run_k, packed, rows=rows, width=w, k=k)
            oph.oph_fused_tile_step_plain(run_p, packed, rows=rows, width=w, params=p)
            torch.cuda.synchronize()
            assert same(run_k, run_p), f"oph_fold differs from plain at {rows}x{w}, k={k}, P={P}"
            tiles += 1
    dens_rows = 0
    for P in (128, 64):
        sig = np.concatenate([densify_edge_rows(P)] + [
            raw_oph_rows(rng, 1024, P, fill) for fill in (0.0, 0.01, 0.1, 0.5, 0.99)])
        sig_d = on_card(sig)
        got = oph_cuda.oph_densify(sig_d)
        assert same(got, oph.densify_plain(sig_d)), f"oph_densify differs from plain at P={P}"
        assert same(got[0], sig_d[0]), "an all-empty row changed"
        dens_rows += sig.shape[0]
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in oph_launches().items()}
    if kernels is None:
        assert launches == {"oph_fold_segments": 2 * len(runs), "oph_fold": tiles,
                            "oph_sig": tiles, "oph_densify": 2}, launches
    return {"segment_cases": len(runs), "residues_mod_16": len(residues),
            "most_descriptors": max(descriptors), "tile_cases": tiles,
            "densify_rows": dens_rows, "launches": launches, "max_abs_err": 0}


def oph_ms(fn, kernel: str, units: str, reps: int = 5, launches: int = 1) -> tuple[float, float]:
    """``(event_ms, kernel_ms)`` per call, as :func:`timed`, for an OPH
    kernel: the profiler's kernels whose name holds both ``kernel`` and
    ``units`` (the fold's three modes share one template)."""
    fn()
    event_ms = cuda_ms(fn, reps)
    seen = profiler_device_ms(fn, (kernel,), reps)
    hit = {k: v for k, v in seen.items() if kernel in k and units in k}
    n = sum(v[1] for v in hit.values())
    assert n, f"the profiler saw no {kernel} {units} kernel, only {sorted(seen)}"
    return event_ms, sum(v[0] for v in hit.values()) / n * launches


def oph_path(docs: list[bytes], planted: dict[int, int], warm: list[bytes], card: str,
             clock_mhz: float, dev: torch.device) -> list[dict]:
    """``DedupConfig(backend="oph", rerank=False, exact_verify_band=0)``
    over the main corpus, timed on its second call: one ``oph_fold_segments``
    launch a chunk, one ``oph_densify`` a corpus and no other launch, every
    planted duplicate resolved; the unpacked transport (``packed_h2d=False``)
    equal with one ``oph_sig`` a tile; card and CPU equal on 2,048 articles;
    the tile step (``oph_fold``) over the reference chunker's tiles equal to
    the segment fold.  Each kernel timed by the profiler at these shapes
    beside its bound and plain version, and beside the reference's own
    formulation in torch (a sort and a ``searchsorted`` of each unpacked
    tile).  Returns the four rows of the ``kernels`` line."""
    import dataclasses

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.ops import oph, oph_cuda
    from advanced_scrapper_tpu_torch.ops.minhash import fold_segments_plain, make_fused_tile_step
    from advanced_scrapper_tpu_torch.ops.pack import pack_tile
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    cfg = DedupConfig(backend="oph", rerank=False, exact_verify_band=0.0)
    eng = NearDupEngine(cfg, device=dev)
    params = eng.params
    k, P = params.shingle_k, params.num_perm
    n = len(docs)
    eng.dedup_reps_async(warm)[: len(warm)].cpu()
    t0 = time.perf_counter()
    eng.dedup_reps_async(docs)[:n].cpu()
    first_call_seconds = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    reps = eng.dedup_reps_async(docs)[:n].cpu().numpy()
    seconds = time.perf_counter() - t0
    got = read_launches()
    chunks = eng.last_chunks
    assert got == {**dict.fromkeys(got, 0), "oph_fold_segments": chunks,
                   "oph_densify": 1} and chunks > 0, got
    check_roots(reps, n)
    missed = [i for i, s in planted.items() if reps[i] != reps[s]]
    assert not missed, f"{len(missed)} planted dups unresolved, first {missed[:5]}"
    log("oph_path", articles=n, seconds=seconds, articles_per_s=n / seconds,
        first_call_seconds=first_call_seconds, chunks=chunks, launches=got,
        planted=len(planted), dups=int((reps != np.arange(n)).sum()),
        staged_lag=staged_lag(eng), card=card)

    legacy = NearDupEngine(dataclasses.replace(cfg, packed_h2d=False), device=dev)
    legacy.dedup_reps_async(warm)[: len(warm)].cpu()
    reset_launches()
    t0 = time.perf_counter()
    lreps = legacy.dedup_reps_async(docs)[:n].cpu().numpy()
    legacy_seconds = time.perf_counter() - t0
    lgot = read_launches()
    assert lgot == {**dict.fromkeys(lgot, 0), "oph_sig": legacy.last_chunks,
                    "oph_densify": 1}, lgot
    assert np.array_equal(lreps, reps), "the unpacked OPH transport disagrees"
    sig_launches = lgot["oph_sig"]
    del legacy, lreps

    small, _ = ragged_corpus(np.random.RandomState(11), PARITY_ARTICLES)
    cpu = NearDupEngine(cfg, device="cpu")
    sig_equal = bool((eng.signatures(small) == cpu.signatures(small)).all())
    reps_equal = bool((eng.dedup_reps(small) == cpu.dedup_reps(small)).all())
    log("oph_card_vs_cpu", articles=PARITY_ARTICLES, signatures_equal=sig_equal,
        reps_equal=reps_equal, unpacked_seconds=legacy_seconds,
        unpacked_articles_per_s=n / legacy_seconds, unpacked_tiles=sig_launches, card=card)
    assert sig_equal and reps_equal, "card and CPU OPH engines disagree"

    # the kernels at the main path's shapes
    lens = np.fromiter(map(len, docs), np.int64, count=n)
    text_bytes = int(lens.sum())
    shingles = int(np.maximum(lens - (k - 1), 0).sum())
    int_ops = (2 * k + 10) * shingles  # FNV steps, fmix32, the bin shift and the min
    running, n_bucket = eng._accumulate_device(docs)
    resident = [[x.to(dev, non_blocking=True) for x in c] for c in eng._host_chunks(docs)]

    def fresh():
        return torch.full((n_bucket, P), -1, dtype=torch.int32, device=dev).view(torch.uint32)

    def same(x, y) -> bool:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))

    run_k, run_p = fresh(), fresh()

    def seg_pass():
        for text, st, ns, ow in resident:
            oph_cuda.oph_fold_segments(run_k, text, st, ns, ow, k)

    def seg_plain():
        for text, st, ns, ow in resident:
            fold_segments_plain(run_p, text, st, ns, ow, params,
                                signatures=oph.oph_raw_signatures_plain)

    seg_event_ms, seg_ms = oph_ms(seg_pass, "oph_fold_kernel", "SegmentUnits",
                                  launches=len(resident))
    seg_plain_ms = cuda_ms(seg_plain)
    assert same(run_k, run_p) and same(run_k, running), "OPH segment accumulators differ"
    n_seg = sum(c[1].numel() for c in resident)
    seg_ops_ms, seg_bytes_ms = bound_ms(int_ops, text_bytes + 16 * n_seg + n_bucket * P * 4,
                                        clock_mhz)
    del resident, run_p

    dense = oph_cuda.oph_densify(run_k)
    dens_event_ms, dens_ms = oph_ms(lambda: oph_cuda.oph_densify(run_k), "oph_densify_kernel", "")
    dens_plain: list = []
    dens_plain_ms = cuda_ms(lambda: dens_plain.append(oph.densify_plain(run_k)))
    assert same(dense, dens_plain[0]), "oph_densify differs from plain on the corpus"
    dens_ops_ms, dens_bytes_ms = bound_ms(3 * n_bucket * P, 2 * n_bucket * P * 4, clock_mhz)
    del dense, dens_plain

    raw_tiles = list(eng._host_tiles(docs))
    packed = [torch.from_numpy(pack_tile(t, l, o)).to(dev) for t, l, o in raw_tiles]
    tok_d = [(torch.from_numpy(t).to(dev), torch.from_numpy(l).to(dev)) for t, l, _o in raw_tiles]
    shapes = [t.shape for t, _l, _o in raw_tiles]
    step = make_fused_tile_step(params, "oph", dev)
    run_t, run_tp = fresh(), fresh()

    def fold_pass():
        for pk, (rows, w) in zip(packed, shapes):
            step(run_t, pk, rows=rows, width=w)

    def fold_plain():
        for pk, (rows, w) in zip(packed, shapes):
            oph.oph_fused_tile_step_plain(run_tp, pk, rows=rows, width=w, params=params)

    oph_cuda.oph_fold.launches = 0
    fold_pass()  # the tile step's run: counted
    fold_launches = oph_cuda.oph_fold.launches
    assert fold_launches == len(packed), (fold_launches, len(packed))
    assert same(run_t, running), "OPH tile and segment accumulators differ"
    fold_event_ms, fold_ms = oph_ms(fold_pass, "oph_fold_kernel", "TileUnits",
                                    launches=len(packed))
    fold_plain_ms = cuda_ms(fold_plain)
    assert same(run_t, run_tp), "oph_fold differs from plain on the corpus"
    fold_ops_ms, fold_bytes_ms = bound_ms(
        int_ops, sum(pk.numel() for pk in packed) + n_bucket * P * 4, clock_mhz)
    del packed, run_t, run_tp

    sig_event_ms, sig_ms = oph_ms(
        lambda: [oph_cuda.oph_sig(t, l, P, k) for t, l in tok_d], "oph_fold_kernel",
        "TileUnits", launches=len(tok_d))
    sigs = [oph_cuda.oph_sig(t, l, P, k) for t, l in tok_d]
    plain_sigs: list = []
    sig_plain_ms = cuda_ms(lambda: plain_sigs.extend(
        oph.oph_raw_signatures_plain(t, l, params) for t, l in tok_d))
    assert all(same(x, y) for x, y in zip(sigs, plain_sigs)), "oph_sig differs from plain"
    # the reference's formulation, the plain version's own: a sort of each
    # row's shingle hashes and a searchsorted of the bins' lower bounds
    reference_ms = sig_plain_ms
    sig_ops_ms, sig_bytes_ms = bound_ms(
        int_ops, sum(t.numel() + 4 * l.numel() + P * 4 * l.numel() for t, l in tok_d),
        clock_mhz)
    del tok_d, sigs, plain_sigs, raw_tiles, running, run_k
    seg_sass = oph_fold_sass(shingles, clock_mhz)
    tile_sass = oph_fold_sass(shingles, clock_mhz, "TileUnits")
    log("oph_kernel_timing", shingles=shingles, int_ops=int_ops, text_bytes=text_bytes,
        segments=n_seg, tiles=len(shapes), clock_max_sm_mhz=clock_mhz,
        fold_segments={"ms": seg_ms, "event_ms": seg_event_ms, "plain_ms": seg_plain_ms,
                       "ops_bound_ms": seg_ops_ms, "bytes_bound_ms": seg_bytes_ms,
                       "sass": seg_sass},
        densify={"ms": dens_ms, "event_ms": dens_event_ms, "plain_ms": dens_plain_ms,
                 "ops_bound_ms": dens_ops_ms, "bytes_bound_ms": dens_bytes_ms},
        fold={"ms": fold_ms, "event_ms": fold_event_ms, "plain_ms": fold_plain_ms,
              "ops_bound_ms": fold_ops_ms, "bytes_bound_ms": fold_bytes_ms,
              "sass": tile_sass},
        sig={"ms": sig_ms, "event_ms": sig_event_ms, "plain_ms": sig_plain_ms,
             "ops_bound_ms": sig_ops_ms, "bytes_bound_ms": sig_bytes_ms},
        reference_formulation_ms=reference_ms, card=card)
    info = {"source": OPH_SOURCE, "reference_formulation_ms": reference_ms}
    floors = {name: {"pipe_floor_ms": x.get("pipe_floor_ms"),
                     "issue_floor_ms": x.get("issue_floor_ms")}
              for name, x in (("seg", seg_sass), ("tile", tile_sass))}
    return [
        kernel_entry("oph_fold_segments", got["oph_fold_segments"], seg_ms, seg_plain_ms,
                     seg_ops_ms, seg_bytes_ms, replaces=OPH_RAW, **info, **floors["seg"]),
        kernel_entry("oph_fold", fold_launches, fold_ms, fold_plain_ms, fold_ops_ms,
                     fold_bytes_ms, replaces=OPH_RAW, **info, **floors["tile"]),
        kernel_entry("oph_sig", sig_launches, sig_ms, sig_plain_ms, sig_ops_ms,
                     sig_bytes_ms, replaces=OPH_RAW, **info, **floors["tile"]),
        kernel_entry("oph_densify", got["oph_densify"], dens_ms, dens_plain_ms, dens_ops_ms,
                     dens_bytes_ms, source=OPH_SOURCE, replaces=OPH_DENSIFY),
    ]


def obs_path(card: str, dev: torch.device) -> None:
    """The obs core on the card, ``ASTPU_TELEMETRY=1``: the estimator-only
    engine over 2,048 ragged articles (one chunk).  On its second call the
    kernel-build sentinel stays at 0, the ``dedup`` plane counts one
    dispatch a ``minhash_fold_segments`` launch and one put a chunk plus
    the valid mask, and the Prometheus text holds the stage, dispatch
    latency, device-put and dispatch series.  Under
    ``ASTPU_DISPATCH_TIMING=fenced`` the timing gauge reads 1 and each
    launch adds one latency observation.  ``device_trace`` writes a Chrome
    trace that names ``minhash_fold_segments``."""
    import tempfile

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.obs import devprof, profiler, stages, telemetry
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    os.environ["ASTPU_TELEMETRY"] = "1"
    telemetry.REGISTRY.set_enabled(None)
    telemetry.REGISTRY.reset()
    try:
        docs, _ = ragged_corpus(np.random.RandomState(13), PARITY_ARTICLES)
        eng = NearDupEngine(DedupConfig(rerank=False, exact_verify_band=0.0), device=dev)
        eng.dedup_reps_async(docs).cpu()
        builds = devprof.jit_compiles_total()
        before = stages.regime_device_counters("dedup")
        reset_launches()
        t0 = time.perf_counter()
        eng.dedup_reps_async(docs).cpu()
        seconds = time.perf_counter() - t0
        launches = read_launches()["minhash_fold_segments"]
        after = stages.regime_device_counters("dedup")
        assert devprof.jit_compiles_total() == builds, "a kernel built on the second call"
        assert after["device_dispatches"] - before["device_dispatches"] == launches \
            == eng.last_chunks > 0, (before, after, launches)
        assert after["device_puts"] - before["device_puts"] == eng.last_chunks + 1
        text = telemetry.REGISTRY.prometheus_text()
        series = ("astpu_stage_seconds", "astpu_dispatch_latency_seconds",
                  "astpu_device_puts_total", "astpu_device_dispatches_total",
                  "astpu_dedup_docs_total", "astpu_dedup_step_seconds")
        missing = [s for s in series if s not in text]
        assert not missing, missing

        def fold_hists():
            return [h for h in telemetry.REGISTRY.find(devprof.DISPATCH_HISTOGRAM)
                    if h.labels["kernel"] == "dedup_fold_segments"]

        async_count = sum(h.count for h in fold_hists())
        async_sum = sum(h.sum for h in fold_hists())
        os.environ["ASTPU_DISPATCH_TIMING"] = "fenced"
        try:
            eng.dedup_reps_async(docs).cpu()
        finally:
            del os.environ["ASTPU_DISPATCH_TIMING"]
        (gauge,) = telemetry.REGISTRY.find("astpu_dispatch_timing_fenced")
        fenced_count = sum(h.count for h in fold_hists())
        fenced_sum = sum(h.sum for h in fold_hists()) - async_sum
        assert gauge.value == 1.0 and fenced_count - async_count == eng.last_chunks
        with tempfile.TemporaryDirectory() as d:
            with profiler.device_trace(d):
                eng.dedup_reps_async(docs).cpu()
            (name,) = os.listdir(d)
            with open(os.path.join(d, name)) as f:
                trace_text = f.read()
        assert "minhash_fold_segments" in trace_text, "the trace does not name the fold"
        log("obs_path", articles=PARITY_ARTICLES, seconds=seconds, launches=launches,
            device_counters={k: after[k] - before[k] for k in after},
            builds_on_second_call=devprof.jit_compiles_total() - builds,
            builds_total=devprof.jit_compiles_by_kernel(), series=list(series),
            async_observations=async_count, async_mean_ms=1e3 * async_sum / async_count,
            fenced_observations=fenced_count - async_count,
            fenced_mean_ms=1e3 * fenced_sum / (fenced_count - async_count),
            stage_ms=stages.snapshot_ms(), trace_bytes=len(trace_text), card=card)
    finally:
        os.environ.pop("ASTPU_TELEMETRY", None)
        telemetry.REGISTRY.set_enabled(None)
        telemetry.REGISTRY.reset()


MESH_SHAPES = ((4, 2), (8, 1))
MESH_SHARDS = 8
MESH_BATCH = 2048  # the sharded functions' batch: 2,048 rows of 1,024 bytes
MESH_BLOCK = 1024
MESH_WORLD_TIMEOUT_S = 300.0  # the most a rank of a world may take


def mesh_batch() -> tuple[np.ndarray, np.ndarray]:
    """The sharded functions' batch: ``ragged_corpus`` seed 11 cut to
    1,024-byte rows (planted copies across shards)."""
    from advanced_scrapper_tpu_torch.core.tokenizer import encode_batch

    small, _ = ragged_corpus(np.random.RandomState(11), MESH_BATCH)
    return encode_batch(small, block_len=MESH_BLOCK)


def reps_digest(reps: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(reps, np.int32).tobytes()).hexdigest()


def ledger_deltas(before: dict, after: dict) -> dict:
    return {s: {k: after[s][k] - before.get(s, {}).get(k, 0.0) for k in after[s]} for s in after}


def mesh_planes(docs: list[bytes], engines: dict, wants: dict, dev) -> dict:
    """Part 1 of ``mesh_path``: ``dedup_reps_sharded`` of each engine
    (``minhash``, ``oph``) on each of ``MESH_SHAPES`` (8 shards on the one
    card), after a ``prewarm_sharded``: the representatives equal the
    one-device ones, every shard's ledger is tiles + 1 / tiles + 1 with
    skew 0, and the fold ran once a shard a tile group (OPH: one densify a
    corpus).  Returns each run's record and the launches summed."""
    from advanced_scrapper_tpu_torch.core.mesh import build_mesh
    from advanced_scrapper_tpu_torch.obs import stages

    runs, launches = [], dict.fromkeys(launch_counters(), 0)
    for backend, eng in engines.items():
        fold = "oph_fold" if backend == "oph" else "minhash_fold"
        for shape in MESH_SHAPES:
            mesh = build_mesh(*shape, devices=[dev] * MESH_SHARDS)
            t0 = time.perf_counter()
            warm = eng.prewarm_sharded(mesh, len(docs))
            prewarm_s = time.perf_counter() - t0
            before = stages.sharded_device_counters()
            stages.reset()
            reset_launches()
            t0 = time.perf_counter()
            reps = eng.dedup_reps_sharded(docs, mesh)
            seconds = time.perf_counter() - t0
            got = read_launches()
            stage_ms = stages.snapshot_ms()
            deltas = ledger_deltas(before, stages.sharded_device_counters())
            groups = eng.last_tiles
            skew = stages.record_sharded_put_skew(before)
            assert np.array_equal(reps, wants[backend]), f"{backend} {shape}: reps differ"
            assert len(deltas) == MESH_SHARDS and all(
                d["device_puts"] == d["device_dispatches"] == groups + 1 for d in deltas.values()
            ), (backend, shape, groups, deltas)
            assert skew == 0.0, skew
            assert got[fold] == groups * MESH_SHARDS, (fold, got, groups)
            assert got["oph_densify"] == (backend == "oph"), got
            assert sum(got.values()) == got[fold] + got["oph_densify"], got
            launches = {k: launches[k] + v for k, v in got.items()}
            runs.append({
                "backend": backend, "mesh": f"{shape[0]}x{shape[1]}", "shards": MESH_SHARDS,
                "seconds": seconds, "articles_per_s": len(docs) / seconds,
                "prewarm_s": prewarm_s, "prewarm_launches": warm, "tile_groups": groups,
                "launches": {k: v for k, v in got.items() if v},
                "ledger_per_shard": deltas["0"], "put_skew": skew,
                "h2d_bytes_per_shard": sorted({d["h2d_bytes"] for d in deltas.values()}),
                "stage_ms": stage_ms, "local_combines": mesh.stats["local_combines"],
                "reps_equal": True,
            })
    return {"runs": runs, "launches": launches}


def mesh_against_index(engine, dev) -> dict:
    """``dedup_against_index(mesh=...)`` on 4,096 ragged articles in two
    batches: the mesh's wide keys equal the one-device keys, and the
    attributions (and both indexes' postings) equal the one-device call's."""
    import tempfile

    from advanced_scrapper_tpu_torch.core.mesh import build_mesh
    from advanced_scrapper_tpu_torch.index import PersistentIndex

    adocs = ragged_corpus(np.random.RandomState(20), AGAINST_INDEX_ARTICLES)[0]
    half = AGAINST_INDEX_ARTICLES // 2
    mesh = build_mesh(4, 2, devices=[dev] * MESH_SHARDS)
    keys_mesh = engine._keys_wide_sharded(adocs, mesh)
    _sigs, keys_one = engine.signatures_and_keys(adocs, wide=True, sync_sigs=False)
    assert np.array_equal(keys_mesh, keys_one), "the mesh's wide keys differ"
    got, postings = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, m in (("mesh", mesh), ("one", None)):
            idx = PersistentIndex(os.path.join(tmp, name))
            try:
                t0 = time.perf_counter()
                got[name] = [engine.dedup_against_index(adocs[:half], idx, mesh=m),
                             engine.dedup_against_index(adocs[half:], idx, mesh=m)]
                got[name + "_s"] = time.perf_counter() - t0
                postings[name] = sorted_postings(idx)
            finally:
                idx.close()
    same = all(np.array_equal(a, b) for a, b in zip(got["mesh"], got["one"]))
    assert same and postings["mesh"] == postings["one"], "the mesh's attributions differ"
    return {"articles": AGAINST_INDEX_ARTICLES, "keys_equal": True, "attributions_equal": True,
            "dups": int(sum((x >= 0).sum() for x in got["mesh"])),
            "postings": len(postings["mesh"][0]), "mesh_seconds": got["mesh_s"],
            "one_device_seconds": got["one_s"]}


def mesh_functions(dev) -> tuple[list[dict], dict, np.ndarray]:
    """Part 2 of ``mesh_path``: ``make_sharded_dedup``,
    ``make_sharded_block_dedup`` (two 1,024-byte blocks an article),
    ``make_seq_sharded_signatures`` and ``make_ring_dedup`` on each of
    ``MESH_SHAPES``, card against the same function on CPU shards, on the
    2,048 × 1,024-byte batch.  Returns each check's record, the card's
    launches summed, and the 8×1 card batch step's representatives (the
    one-process result the worlds are held to)."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.core.mesh import build_mesh, host_numpy
    from advanced_scrapper_tpu_torch.parallel.ring import make_ring_dedup
    from advanced_scrapper_tpu_torch.parallel.sharded import (
        make_seq_sharded_signatures,
        make_sharded_block_dedup,
        make_sharded_dedup,
    )

    params = make_params()
    tok, lens = mesh_batch()
    owners = (np.arange(MESH_BATCH) // 2).astype(np.int32)
    steps = {
        "sharded_dedup": (lambda m: make_sharded_dedup(m, params), (tok, lens)),
        "sharded_block_dedup": (lambda m: make_sharded_block_dedup(m, params, MESH_BATCH // 2),
                                (tok, lens, owners)),
        "seq_sharded_signatures": (lambda m: make_seq_sharded_signatures(m, params, MESH_BLOCK),
                                   (tok, lens)),
        "ring_dedup": (lambda m: make_ring_dedup(m, params), (tok, lens)),
    }

    def host(out):
        if isinstance(out, tuple):
            return [host_numpy(x) for x in out]
        return [out.numpy() if hasattr(out, "pieces") else host_numpy(out)]

    records, launches, one_process = [], dict.fromkeys(launch_counters(), 0), None
    for shape in MESH_SHAPES:
        card_mesh = build_mesh(*shape, devices=[dev] * MESH_SHARDS)
        cpu_mesh = build_mesh(*shape, devices=["cpu"] * MESH_SHARDS)
        for name, (make, args) in steps.items():
            step = make(card_mesh)
            reset_launches()
            t0 = time.perf_counter()
            out = host(step(*args))  # the readback waits for the card
            card_s = time.perf_counter() - t0
            got = read_launches()
            t0 = time.perf_counter()
            want = host(make(cpu_mesh)(*args))
            cpu_s = time.perf_counter() - t0
            equal = all(np.array_equal(a, b) for a, b in zip(out, want))
            assert equal, f"{name} on {shape}: card and CPU differ"
            assert got["minhash_sig"] == MESH_SHARDS and sum(got.values()) == MESH_SHARDS, got
            launches = {k: launches[k] + v for k, v in got.items()}
            if name == "sharded_dedup" and shape == (8, 1):
                one_process = out[0]
            records.append({"function": name, "mesh": f"{shape[0]}x{shape[1]}",
                            "card_s": card_s, "cpu_s": cpu_s, "equal": True,
                            "minhash_sig_launches": got["minhash_sig"],
                            "dups": int((out[0] != np.arange(len(out[0]))).sum())
                            if out[0].ndim == 1 else None})
    return records, launches, one_process


def run_mesh_world(world: int, backend: str, dev: torch.device, articles: int) -> list[dict]:
    """Start ``world`` ranks of ``chip_smoke.py --mesh-worker`` on ``dev``
    (the card; CPU shards to rehearse) over ``articles`` of the ragged
    corpus and return each rank's JSON line; a rank that fails or
    outlasts ``MESH_WORLD_TIMEOUT_S`` fails the phase (every rank is
    stopped)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    script = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, script, "--mesh-worker", str(r), str(world),
                               str(port), backend, dev.type, str(articles), str(MESH_BATCH)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=MESH_WORLD_TIMEOUT_S)
            assert p.returncode == 0, f"{backend} rank failed ({p.returncode}):\n{err[-4000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def mesh_worker(rank: str, world: str, port: str, backend: str, device: str = "cuda",
                articles: str = str(MAIN_ARTICLES), batch: str = str(MESH_BATCH)) -> int:
    """One rank of a ``torch.distributed`` world on the card (``mesh_path``
    parts 3 and 4): ``world`` ranks share the card, ``8 / world`` shards
    each.  It runs ``multihost_dedup`` over its rows of the ``batch`` ×
    1,024-byte batch and ``dedup_reps_sharded`` over ``articles`` ragged
    articles on ``global_mesh``, and prints their representatives'
    digests, times, launches and the collectives' bytes, ms and staging
    copies as one JSON line.  Under NCCL it also all-reduces the uint32
    edge values in their sign-flip wire form.  ``device="cpu"`` rehearses
    it on CPU shards."""
    global MESH_BATCH
    MESH_BATCH = int(batch)
    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.core.mesh import new_stats
    from advanced_scrapper_tpu_torch.parallel import collectives
    from advanced_scrapper_tpu_torch.parallel.dist import (
        global_mesh,
        initialize_multihost,
        multihost_dedup,
        world_info,
    )
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    rank, world = int(rank), int(world)
    t_start = time.perf_counter()
    assert initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    mesh = global_mesh(devices=[dev] * (MESH_SHARDS // world))
    out = {"rank": rank, "backend": backend, "world": world_info(mesh)}
    if backend == "nccl":
        edges = np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
        wire = torch.from_numpy(edges.view(np.int32)).to(dev) ^ -(1 << 31)
        back = collectives.world_reduce(mesh, wire, "min", (rank,))
        assert np.array_equal((back ^ -(1 << 31)).cpu().numpy().view(np.uint32), edges)
        out["nccl_wire_check"] = True
    tok, lens = mesh_batch()
    per = MESH_BATCH // world
    params = make_params()
    mesh.stats = new_stats()
    reset_launches()
    t0 = time.perf_counter()
    rep, hist = multihost_dedup(tok[rank * per:(rank + 1) * per], lens[rank * per:(rank + 1) * per],
                                params, mesh=mesh)
    out["multihost"] = {"seconds": time.perf_counter() - t0, "digest": reps_digest(rep),
                        "hist_sum": int(hist.sum()), "launches": read_launches()["minhash_sig"],
                        "collectives": dict(mesh.stats)}
    docs, _ = ragged_corpus(np.random.RandomState(7), int(articles))
    eng = NearDupEngine(DedupConfig(rerank=False, exact_verify_band=0.0), device=dev)
    warm = eng.prewarm_sharded(mesh, len(docs))
    mesh.stats = new_stats()
    reset_launches()
    t0 = time.perf_counter()
    reps = eng.dedup_reps_sharded(docs, mesh)
    seconds = time.perf_counter() - t0
    got = read_launches()
    if dev.type == "cuda":  # the plain versions count no launch
        assert got["minhash_fold"] == eng.last_tiles * len(mesh.local), (got, eng.last_tiles)
    out["packed"] = {"seconds": seconds, "articles_per_s": len(docs) / seconds,
                     "digest": reps_digest(reps), "tile_groups": eng.last_tiles,
                     "prewarm_launches": warm, "minhash_fold_launches": got["minhash_fold"],
                     "collectives": dict(mesh.stats)}
    out["process_seconds"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def mesh_path(docs: list[bytes], main_reps: np.ndarray, engine, card: str, dev="cuda") -> dict:
    """The device mesh on the card (``core/mesh.py``, ``parallel/*``), each
    part with the launch counters set to 0 just before it and read just
    after:

    1. a virtual 8-shard mesh in this process, 4×2 and 8×1:
       ``dedup_reps_sharded`` over the 65,536 ragged articles with
       ``main_path``'s engine equals its ``dedup_reps_async``
       representatives, each shard's ledger tiles + 1 / tiles + 1 with
       skew 0, ``minhash_fold`` launches = tile groups × 8; the same with
       ``backend="oph"`` (``oph_fold`` = groups × 8, one ``oph_densify`` a
       corpus); ``dedup_against_index(mesh=...)`` on 4,096 articles equal
       to the one-device call; ``entry.dryrun_multichip(8)`` over the
       visible cards;
    2. ``make_sharded_dedup``, ``make_sharded_block_dedup``,
       ``make_seq_sharded_signatures`` and ``make_ring_dedup`` on both
       meshes, card equal to CPU shards, on 2,048 × 1,024 bytes;
    3. a gloo world of 2 ranks sharing the card, 4 shards each: its
       ``multihost_dedup`` equals part 2's 8×1 batch step, its
       ``dedup_reps_sharded`` part 1's, both ranks agreeing; the
       collectives' bytes, ms and staging copies;
    4. an NCCL world of 1 on the card: the same, and the wire form through
       NCCL.

    Returns the launches of the kernels on the path (parts 1 and 2)."""
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    n = len(docs)
    oph = NearDupEngine(DedupConfig(backend="oph", rerank=False, exact_verify_band=0.0),
                        device=dev)
    oph_reps = oph.dedup_reps_async(docs)[:n].cpu().numpy()
    planes = mesh_planes(docs, {"minhash": engine, "oph": oph},
                         {"minhash": main_reps, "oph": oph_reps}, dev)
    log("mesh_path_planes", articles=n, runs=planes["runs"], card=card)
    against = mesh_against_index(engine, dev)
    log("mesh_path_against_index", **against, card=card)
    from advanced_scrapper_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    dry = dryrun_multichip(MESH_SHARDS, device=dev)
    cards = min(MESH_SHARDS, torch.cuda.device_count()) if dev.type == "cuda" else 1
    assert dry["distinct_devices"] == cards, dry
    log("mesh_path_dryrun", **dry, seconds=time.perf_counter() - t0, card=card)
    functions, fn_launches, one_process = mesh_functions(dev)
    log("mesh_path_functions", batch=[MESH_BATCH, MESH_BLOCK], checks=functions, card=card)
    for world, backend in ((2, "gloo"), (1, "nccl" if dev.type == "cuda" else "gloo")):
        t0 = time.perf_counter()
        ranks = run_mesh_world(world, backend, dev, n)
        wall = time.perf_counter() - t0
        for r in ranks:
            assert r["multihost"]["digest"] == reps_digest(one_process), (backend, r["rank"])
            assert r["packed"]["digest"] == reps_digest(main_reps), (backend, r["rank"])
            assert r["world"]["global_devices"] == MESH_SHARDS, r["world"]
        log("mesh_path_world", backend=backend, ranks=world, wall_s=wall, per_rank=ranks,
            multihost_equal=True, packed_equal=True, card=card)
    launches = {k: planes["launches"][k] + fn_launches[k] for k in planes["launches"]}
    seconds = time.perf_counter() - t_phase
    log("mesh_path", seconds=seconds, launches={k: v for k, v in launches.items() if v},
        card=card)
    return launches


def bound_by(ops_ms: float, bytes_ms: float) -> str:
    return "operations" if ops_ms >= bytes_ms else "bytes"


def kernel_entry(name: str, launches: int, ms: float, plain_ms: float,
                 ops_ms: float, bytes_ms: float,
                 source: str = "advanced_scrapper_tpu_torch/csrc/minhash.cu",
                 replaces: str = "advanced_scrapper_tpu/ops/pallas_minhash.py:71",
                 **extra) -> dict:
    """One row of the ``kernels`` line; ``extra`` fields follow the
    contract's keys."""
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": 0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": bound_by(ops_ms, bytes_ms),
        "library_ms": None,
        **extra,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.core.tokenizer import to_bytes
    from advanced_scrapper_tpu_torch.cpu.hostbatch import chunk_ranges, segment_ranges
    from advanced_scrapper_tpu_torch.ops import _build, minhash_cuda
    from advanced_scrapper_tpu_torch.ops.lsh import fused_resolve_epilogue
    from advanced_scrapper_tpu_torch.ops.minhash import (
        SEGMENT_SHINGLES,
        fold_segments_plain,
        fused_tile_step_plain,
        make_fused_tile_step,
        minhash_signatures,
        minhash_signatures_plain,
        perm_tensors,
    )
    from advanced_scrapper_tpu_torch.ops.pack import pack_tile
    from advanced_scrapper_tpu_torch.pipeline import dedup
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine, _jump_rounds
    from advanced_scrapper_tpu_torch.pipeline.dispatch import resolve_dispatch_window

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log("device", card=card, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        numpy=np.__version__, host_cpu=host_cpu(), host_cores=os.cpu_count())

    t0 = time.perf_counter()
    sources = ("minhash", "rerank", "match", "editdist", "oph")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        outs = dict(zip(sources, pool.map(_build.build, sources)))
    log("build", seconds=time.perf_counter() - t0, built=[k for k, v in outs.items() if v],
        ptxas=[ln.strip() for out in outs.values() for ln in out.splitlines()
               if "registers" in ln or "smem" in ln])

    cfg = DedupConfig(rerank=False, exact_verify_band=0.0)
    engine = NearDupEngine(cfg, device=dev)
    params = engine.params
    k = params.shingle_k
    log("kernel_vs_plain", **check_kernels_vs_plain(params, cfg, dev))
    log("segments_vs_plain", **check_segments_vs_plain(params, dev))
    log("oph_vs_plain", **check_oph_vs_plain(params, cfg, dev))
    log("rerank_kernel_vs_plain", **check_rerank_vs_plain(dev))
    log("match_kernel_vs_plain", **check_match_vs_plain(dev), **check_myers_pairs_vs_plain(dev))
    entry_path(card)

    # -- phase 4: the main path at full width ------------------------------
    docs, planted = ragged_corpus(np.random.RandomState(7), MAIN_ARTICLES)
    warm, _ = ragged_corpus(np.random.RandomState(8), WARM_ARTICLES)
    torch.cuda.synchronize()
    engine.dedup_reps_async(warm)[:WARM_ARTICLES].cpu()
    # the first call at this size allocates its 64 MiB pinned chunk buffers
    # (the warm corpus fills less than one chunk); the second is counted
    t0 = time.perf_counter()
    engine.dedup_reps_async(docs)[:MAIN_ARTICLES].cpu()
    first_call_seconds = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    reps = engine.dedup_reps_async(docs)[:MAIN_ARTICLES].cpu().numpy()
    seconds = time.perf_counter() - t0
    seg_launches = minhash_cuda.minhash_fold_segments.launches
    chunks, h2d = engine.last_chunks, engine.last_h2d_bytes
    assert seg_launches == chunks > 0, f"{seg_launches} kernel launches for {chunks} chunks"
    assert minhash_cuda.minhash_fold.launches == minhash_cuda.minhash_sig.launches == 0
    assert reps.shape == (MAIN_ARTICLES,)
    idx = np.arange(MAIN_ARTICLES)
    assert (reps <= idx).all() and (reps >= 0).all(), "a representative after its row"
    assert (reps[reps] == reps).all(), "representatives are not roots"
    missed = [i for i, s in planted.items() if reps[i] != reps[s]]
    assert not missed, f"{len(missed)} planted dups unresolved, first {missed[:5]}"
    lens = np.fromiter(map(len, docs), np.int64, count=len(docs))
    text_bytes = int(lens.sum())
    # what a pinned chunk buffer costs on this host: more buffers held than
    # the chunk loop left in PyTorch's pinned cache, each allocation timed
    held, pinned_alloc_ms = [], []
    for _ in range(2 * chunks):
        t0 = time.perf_counter()
        held.append(torch.empty((dedup.CHUNK_BYTES,), dtype=torch.uint8, pin_memory=True))
        pinned_alloc_ms.append(1e3 * (time.perf_counter() - t0))
    del held
    main_lag = staged_lag(engine)
    log("main_path", articles=MAIN_ARTICLES, text_bytes=text_bytes, seconds=seconds,
        articles_per_s=MAIN_ARTICLES / seconds, first_call_seconds=first_call_seconds,
        pinned_alloc_ms=pinned_alloc_ms, chunks=chunks,
        chunk_bytes=dedup.CHUNK_BYTES, segment_shingles=SEGMENT_SHINGLES,
        h2d_bytes=h2d, fold_segments_launches=seg_launches, planted=len(planted),
        dups=int((reps != idx).sum()), put_workers=dedup.resolve_put_workers(cfg),
        dispatch_window=resolve_dispatch_window(cfg.dispatch_window,
                                                dedup.resolve_put_workers(cfg)),
        staged_lag=main_lag, card=card)
    main_reps = reps

    # where the main path's time goes: host prep alone (to_bytes, join into
    # pinned buffers, descriptors), the copy of every chunk, the kernel over
    # the resident chunks, the resolve epilogue
    t0 = time.perf_counter()
    raw = [to_bytes(d) for d in docs]
    to_bytes_s = time.perf_counter() - t0
    for _chunk in engine._host_chunks(raw):
        pass  # each buffer returns to the pinned cache before the next chunk
    host_prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo, hi in chunk_ranges(lens, dedup.CHUNK_BYTES):
        off = np.concatenate([[0], np.cumsum(lens[lo:hi - 1])]).astype(np.int64)
        segment_ranges(off, lens[lo:hi], np.arange(lo, hi), k, SEGMENT_SHINGLES)
    descriptors_s = time.perf_counter() - t0
    host_chunks = list(engine._host_chunks(raw))
    resident: list = []
    copy_ms = cuda_ms(lambda: resident.extend(
        [x.to(dev, non_blocking=True) for x in c] for c in host_chunks))
    del host_chunks
    t0 = time.perf_counter()
    running, n_bucket = engine._accumulate_device(docs)
    torch.cuda.synchronize()
    chunk_loop_s = time.perf_counter() - t0
    valid = engine._valid_device(docs, n_bucket)
    epilogue_ms = cuda_ms(lambda: fused_resolve_epilogue(
        running, valid, params.band_salt, engine._fine_salt(), cfg.sim_threshold,
        cfg.fine_margin, num_coarse=params.num_bands, jump_rounds=_jump_rounds(n_bucket),
        use_fine_margin=False,
    ))
    seg_running = running
    del valid

    a, b = perm_tensors(params, dev)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])

    def fresh():
        return torch.full((n_bucket, 128), -1, dtype=torch.int32, device=dev).view(torch.uint32)

    def same(x, y) -> bool:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))

    # the segment kernel over the resident chunks, timed
    shingles = int(np.maximum(lens - (k - 1), 0).sum())
    int_ops = 2 * 128 * shingles  # multiply-add + min per (shingle, permutation)
    run_k, run_p = fresh(), fresh()

    def seg_pass():
        for text, st, ns, ow in resident:
            minhash_cuda.minhash_fold_segments(run_k, text, st, ns, ow, a, b, k)

    def seg_plain():
        for text, st, ns, ow in resident:
            fold_segments_plain(run_p, text, st, ns, ow, params)

    seg_event_ms, seg_ms = timed(seg_pass, "SegmentUnits", launches=len(resident))
    seg_plain_ms = cuda_ms(seg_plain)
    assert same(run_k, run_p) and same(run_k, seg_running), "segment accumulators differ"
    n_seg = sum(c[1].numel() for c in resident)
    seg_moved = text_bytes + 16 * n_seg + n_bucket * 128 * 4
    seg_ops_ms, seg_bytes_ms = bound_ms(int_ops, seg_moved, clock_mhz)
    log("main_path_breakdown", host_prep_s=host_prep_s, to_bytes_s=to_bytes_s,
        descriptors_s=descriptors_s, copy_ms=copy_ms, kernel_ms=seg_ms,
        epilogue_ms=epilogue_ms, chunk_loop_s=chunk_loop_s, chunks=len(resident),
        segments=n_seg, card=card)
    log("kernel_timing", name="minhash_fold_segments", launches_per_pass=len(resident),
        shingles=shingles, int_ops=int_ops, bytes=seg_moved, clock_max_sm_mhz=clock_mhz,
        ops_bound_ms=seg_ops_ms, bytes_bound_ms=seg_bytes_ms, ms=seg_ms,
        event_ms=seg_event_ms, share_of_bound=max(seg_ops_ms, seg_bytes_ms) / seg_ms,
        plain_ms=seg_plain_ms, card=card)
    del run_k, run_p

    # segment size, and chunks vs one launch: the whole corpus as one text
    text_all = torch.frombuffer(bytearray(b"".join(docs)), dtype=torch.uint8).to(dev)
    off_all = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    sweep = []
    for S in (256, 512, 1024, 2048):
        seg = [torch.from_numpy(x).to(dev) for x in segment_ranges(
            off_all, lens, np.arange(len(docs)), k, S)]
        run = fresh()
        _ev, ms_s = timed(lambda: minhash_cuda.minhash_fold_segments(
            run, text_all, *seg, a, b, k), "SegmentUnits")
        assert same(run, seg_running), f"segment size {S} changes the accumulator"
        ops_s, bytes_s = bound_ms(int_ops, text_bytes + 16 * len(seg[0]) + n_bucket * 512,
                                  clock_mhz)
        sweep.append({"segment_shingles": S, "segments": len(seg[0]), "ms": ms_s,
                      "share_of_bound": max(ops_s, bytes_s) / ms_s})
    log("segment_sweep", one_launch=sweep, card=card)
    del text_all, resident, running

    # the tile path, like for like with the first port: the reference
    # chunker's tiles resident on the card, through make_fused_tile_step
    # (minhash_fold) and minhash_signatures (minhash_sig)
    raw_tiles = list(engine._host_tiles(docs))
    packed = [torch.from_numpy(pack_tile(t, l, o)).to(dev) for t, l, o in raw_tiles]
    tok_d = [(torch.from_numpy(t).to(dev), torch.from_numpy(l).to(dev)) for t, l, _o in raw_tiles]
    shapes = [t.shape for t, _l, _o in raw_tiles]
    tile_shingles = sum(int(np.maximum(l.astype(np.int64) - (k - 1), 0).sum())
                        for _t, l, _o in raw_tiles)
    assert tile_shingles == shingles, (tile_shingles, shingles)
    step = make_fused_tile_step(params, "scan", dev)
    run_k, run_p = fresh(), fresh()

    def fold_pass():
        for p, (rows, w) in zip(packed, shapes):
            step(run_k, p, rows=rows, width=w)

    def fold_plain():
        for p, (rows, w) in zip(packed, shapes):
            fused_tile_step_plain(run_p, p, rows=rows, width=w, params=params)

    minhash_cuda.minhash_fold.launches = 0
    fold_pass()  # the tile path's run: counted, and its warm-up
    fold_launches = minhash_cuda.minhash_fold.launches
    assert fold_launches == len(packed), (fold_launches, len(packed))
    assert same(run_k, seg_running), "tile and segment accumulators differ"
    run_k = fresh()
    fold_event_ms, fold_ms = timed(fold_pass, "TileUnits", launches=len(packed))
    fold_plain_ms = cuda_ms(fold_plain)
    assert same(run_k, run_p), "kernel and plain tile accumulators differ"
    fold_ops_ms, fold_bytes_ms = bound_ms(
        int_ops, sum(p.numel() for p in packed) + n_bucket * 512, clock_mhz)
    log("kernel_timing", name="minhash_fold", tiles=len(packed), shingles=shingles,
        ops_bound_ms=fold_ops_ms, bytes_bound_ms=fold_bytes_ms, ms=fold_ms,
        event_ms=fold_event_ms, share_of_bound=max(fold_ops_ms, fold_bytes_ms) / fold_ms, plain_ms=fold_plain_ms,
        card=card)
    del packed, run_k, run_p

    minhash_cuda.minhash_sig.launches = 0
    sigs = [minhash_signatures(t, l, params) for t, l in tok_d]  # counted, and warm-up
    sig_launches = minhash_cuda.minhash_sig.launches
    assert sig_launches == len(tok_d), (sig_launches, len(tok_d))
    sig_event_ms, sig_ms = timed(
        lambda: [minhash_cuda.minhash_sig(t, l, a, b, k) for t, l in tok_d], "TileUnits",
        launches=len(tok_d))
    plain_sigs: list = []
    sig_plain_ms = cuda_ms(lambda: plain_sigs.extend(
        minhash_signatures_plain(t, l, params) for t, l in tok_d))
    assert all(same(x, y) for x, y in zip(sigs, plain_sigs)), "minhash_sig differs from plain"
    sig_ops_ms, sig_bytes_ms = bound_ms(
        int_ops, sum(t.numel() + 4 * l.numel() + 512 * l.numel() for t, l in tok_d), clock_mhz)
    log("kernel_timing", name="minhash_sig", tiles=len(tok_d), shingles=shingles,
        ops_bound_ms=sig_ops_ms, bytes_bound_ms=sig_bytes_ms, ms=sig_ms,
        event_ms=sig_event_ms, share_of_bound=max(sig_ops_ms, sig_bytes_ms) / sig_ms, plain_ms=sig_plain_ms,
        card=card)
    del tok_d, sigs, plain_sigs, raw_tiles, seg_running

    # -- the dispatcher's knobs and OOM ladder, the legacy transport, the feed --
    dispatched = dispatch_path(docs, main_reps, warm, card)
    legacy_tiles = legacy_transport_path(docs, main_reps, warm, card)
    fed = feed_path(docs, card)
    oph_kernels = oph_path(docs, planted, warm, card, clock_mhz, dev)
    obs_path(card, dev)
    meshed = mesh_path(docs, main_reps, engine, card)

    kernels = [
        kernel_entry("minhash_fold_segments", seg_launches, seg_ms, seg_plain_ms,
                     seg_ops_ms, seg_bytes_ms, dispatch_path=dispatched),
        kernel_entry("minhash_fold", fold_launches, fold_ms, fold_plain_ms,
                     fold_ops_ms, fold_bytes_ms),
        kernel_entry("minhash_sig", sig_launches, sig_ms, sig_plain_ms,
                     sig_ops_ms, sig_bytes_ms, legacy_transport_path=legacy_tiles,
                     feed_path=fed),
    ]

    # -- the default engine: the rerank tier, exact verify at 0.72 ----------
    default = NearDupEngine(DedupConfig(), device=dev)
    rng = np.random.RandomState(11)
    rwarm = rerank_corpus(rng, RERANK_ARTICLES)
    rcorpora = [rerank_corpus(rng, RERANK_ARTICLES) for _ in range(RERANK_CORPORA)]
    run = run_corpora(default, rwarm, rcorpora, settles=1)
    n_rerank = RERANK_ARTICLES * RERANK_CORPORA
    log("rerank_path", articles=n_rerank, corpora=RERANK_CORPORA, seconds=run["seconds"],
        articles_per_s=n_rerank / run["seconds"], launches=run["launches"],
        per_corpus=run["corpora"], card=card)
    rerank_launches = run["launches"]["rerank_settle"]
    last = run["corpora"][-1]
    log("rerank_breakdown", corpus=RERANK_CORPORA - 1,
        host_s={**last["engine_seconds"], **last["tier_seconds"]},
        device_ms={**last["engine_device_ms"], **last["tier_device_ms"]}, card=card)
    st = settle_timing(default.rerank_tier, clock_mhz)
    log("kernel_timing", name="rerank_settle", shape="rerank_path", launches=rerank_launches,
        **st, card=card)

    certified = NearDupEngine(DedupConfig(rerank=False), device=dev)
    run = run_corpora(certified, rwarm, rcorpora, settles=0)
    log("exact_verify_path", articles=n_rerank, corpora=RERANK_CORPORA,
        seconds=run["seconds"], articles_per_s=n_rerank / run["seconds"],
        launches=run["launches"], per_corpus=run["corpora"], card=card)
    del certified, rwarm

    # the default engine once over the estimator-only path's corpus
    reset_launches()
    t0 = time.perf_counter()
    reps = default.dedup_reps(docs)
    seconds = time.perf_counter() - t0
    got = read_launches()
    assert got["rerank_settle"] == 1 and got["minhash_fold_segments"] == default.last_chunks, got
    check_roots(reps, MAIN_ARTICLES)
    missed = [i for i, s in planted.items() if reps[i] != reps[s]]
    assert not missed, f"{len(missed)} planted dups unresolved, first {missed[:5]}"
    stats = default.rerank_tier.stats
    log("default_engine_main_corpus", articles=MAIN_ARTICLES, seconds=seconds,
        articles_per_s=MAIN_ARTICLES / seconds, pairs=stats["pairs"],
        overflow_pairs=stats["overflow_pairs"], launches=got, stats=stats,
        engine_seconds=default.last_clock.seconds,
        tier_seconds=default.rerank_tier.last_clock.seconds,
        engine_device_ms=default.last_clock.device_ms(),
        tier_device_ms=default.rerank_tier.last_clock.device_ms(),
        planted=len(planted), dups=int((reps != np.arange(MAIN_ARTICLES)).sum()), card=card)
    del reps
    # -- the stream backend and the exact dedup ---------------------------------
    stream_launches, stream_batches = stream_path(docs, planted, card)
    persist_launches, persist_batches, local = persist_path(docs, planted, card)
    fleet_launches, fleet_batches = fleet_path(docs, card, local)
    shutil.rmtree(local["session1"], ignore_errors=True)  # reshard_path's copy: --fleet
    del docs, local
    exact_path(card)
    cross_launches, cross_batches = cross_source_path(card)
    scrape_launches, scrape_batches = scrape_path(card)
    kernels[0]["stream_path"] = {"launches": stream_launches, "batches": stream_batches}
    kernels[0]["persist_path"] = {"launches": persist_launches, "batches": persist_batches}
    kernels[0]["fleet_path"] = {"launches": fleet_launches, "batches": fleet_batches}
    kernels[0]["cross_source_path"] = {"launches": cross_launches, "batches": cross_batches}
    kernels[0]["scrape_path"] = {"launches": scrape_launches, "batches": scrape_batches}
    st_main = settle_timing(default.rerank_tier, clock_mhz)
    log("kernel_timing", name="rerank_settle", shape="default_engine_main_corpus",
        launches=got["rerank_settle"], **st_main, card=card)
    main_shape = {k: st_main[k] for k in ("pairs", "sketches", "ms", "plain_ms",
                                          "launch_floor_ms", "share_of_bound")}
    main_shape.update(launches=got["rerank_settle"],
                      bound_ms=max(st_main["ops_bound_ms"], st_main["bytes_bound_ms"]),
                      bound_by=bound_by(st_main["ops_bound_ms"], st_main["bytes_bound_ms"]))
    kernels.append(kernel_entry(
        "rerank_settle", rerank_launches, st["ms"], st["plain_ms"], st["ops_bound_ms"],
        st["bytes_bound_ms"], source="advanced_scrapper_tpu_torch/csrc/rerank.cu",
        replaces="advanced_scrapper_tpu/ops/rerank.py:163 (_pair_jq, jnp)",
        pairs=st["pairs"], launch_floor_ms=st["launch_floor_ms"],
        default_engine_main_corpus=main_shape))

    # -- phase 5: card engines vs CPU engines --------------------------------
    small, _ = ragged_corpus(np.random.RandomState(11), PARITY_ARTICLES)
    cpu = NearDupEngine(cfg, device="cpu")
    t0 = time.perf_counter()
    sig_equal = bool((engine.signatures(small) == cpu.signatures(small)).all())
    reps_equal = bool((engine.dedup_reps(small) == cpu.dedup_reps(small)).all())
    rsmall = rerank_corpus(np.random.RandomState(12), PARITY_ARTICLES)
    cpu_default = NearDupEngine(DedupConfig(), device="cpu")
    cpu_default_reps = cpu_default.dedup_reps(rsmall)
    default_equal = bool((default.dedup_reps(rsmall) == cpu_default_reps).all())
    card_stats, cpu_stats = default.rerank_tier.stats, cpu_default.rerank_tier.stats
    stats_equal = all(card_stats[k] == cpu_stats[k] for k in TIER_KEYS)
    async_equal = bool((default.dedup_reps_async(rsmall).cpu()
                        == cpu_default.dedup_reps_async(rsmall)).all())
    card_cert = NearDupEngine(DedupConfig(rerank=False), device=dev)
    cpu_cert = NearDupEngine(DedupConfig(rerank=False), device="cpu")
    cert_equal = bool((card_cert.dedup_reps(rsmall) == cpu_cert.dedup_reps(rsmall)).all())
    checks_equal = card_cert.last_exact_checks == cpu_cert.last_exact_checks
    log("card_vs_cpu", articles=PARITY_ARTICLES, signatures_equal=sig_equal,
        reps_equal=reps_equal, default_reps_equal=default_equal,
        default_async_equal=async_equal, tier_stats_equal=stats_equal,
        tier_stats=card_stats, rerank_off_reps_equal=cert_equal,
        exact_checks_equal=checks_equal, exact_checks=card_cert.last_exact_checks,
        seconds=time.perf_counter() - t0)
    assert sig_equal and reps_equal, "card and CPU engines disagree"
    assert default_equal and async_equal and stats_equal, "card and CPU default engines disagree"
    assert cert_equal and checks_equal, "card and CPU exact-verify engines disagree"
    warmed = prewarm_path(default, rsmall, cpu_default_reps, card)
    kernels[0]["prewarm_path"] = {"launches": warmed["fold_segments"]}
    settle_row = next(k for k in kernels if k["name"] == "rerank_settle")
    settle_row["prewarm_path"] = {"launches": warmed["rerank_settle"]}
    quality = quality_path(card, dev)
    kernels[0]["quality_path"] = {"launches": quality["launches"]["minhash_fold_segments"]}
    settle_row["quality_path"] = {"launches": quality["launches"]["rerank_settle"]}

    cli_path(card)

    # -- the matcher at S&P scale -------------------------------------------
    timing, match_launches, legacy = matcher_path(clock_mhz, card)
    for t, source, replaces in zip(
        timing, ("advanced_scrapper_tpu_torch/csrc/match.cu",
                 "advanced_scrapper_tpu_torch/csrc/editdist.cu"),
        ("advanced_scrapper_tpu/ops/match.py:93 (_screen_core, jnp)",
         "advanced_scrapper_tpu/ops/editdist.py:144 (semiglobal_dist_shared, jnp)")):
        ops_ms = t["ops_bound_ms"] if t.get("restated_ops_bound_ms") is None \
            else t["restated_ops_bound_ms"]
        kernels.append(kernel_entry(
            t["name"], match_launches[t["name"]], t["ms"], t["plain_ms"], ops_ms,
            t["bytes_bound_ms"], source=source, replaces=replaces, rows=t["rows"]))
    kernels.append(kernel_entry(
        "myers_pairs", legacy["launches"], legacy["ms"], legacy["plain_ms"],
        legacy["ops_bound_ms"], legacy["bytes_bound_ms"],
        source="advanced_scrapper_tpu_torch/csrc/editdist.cu",
        replaces="advanced_scrapper_tpu/ops/editdist.py:66 (_semiglobal_core under "
        "semiglobal_dist :120, jnp)", pairs=legacy["pairs"], batches=legacy["batches"],
        launch_floor_ms=legacy["launch_floor_ms"], chain_floor_ms=legacy["chain_floor_ms"],
        share_of_floor=legacy["share_of_floor"], per=legacy["per"]))
    kernels.extend(oph_kernels)
    assert len(kernels) == 11, [k["name"] for k in kernels]
    for row in kernels:
        if row["name"] in ("minhash_fold", "minhash_sig", "oph_fold", "oph_densify"):
            row["mesh_path"] = {"launches": meshed[row["name"]]}

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def scrape_main() -> int:
    """``--scrape``: the scrape plane alone at full depth (``scrape_path``
    over 8,192 pages, parity on 1,024), with Kernel A built first; kept
    out of the default run for the run's time."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from advanced_scrapper_tpu_torch.ops import _build

    card = nvidia_smi("name,power.limit")
    log("device", card=card, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        host_cpu=host_cpu(), host_cores=os.cpu_count())
    t0 = time.perf_counter()
    _build.build("minhash")
    log("build", seconds=time.perf_counter() - t0, built=["minhash"])
    scrape_path(card, pages_n=SCRAPE_PAGES, parity_n=SCRAPE_PARITY)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


HARVEST_ROWS = 256        # CDX rows a shard: 1,521 shards, 389,376 rows
HARVEST_UNIQUE = 262144   # distinct articles among them: the exact cell's urls
HARVEST_WORKERS = 10      # HarvestConfig's default num_workers
HARVEST_TRAP_SHARDS = 8   # shards with a double-space row and a short row
HARVEST_RESUME = 0.10     # share of the checkpoints deleted before the resume
LEASE_PAGES = 8192        # the scrape cell's pages (seed 41)
LEASE_CLIENTS = 4
LEASE_THREADS = 2         # fetch threads a client
CONTROL_SYNC, CONTROL_ASYNC = 256, 64
PIPE_WORKERS, PIPE_URLS = 3, 1024
#: the control server's template: the yfin fields its extractor reads
CONTROL_TEMPLATE = {
    "title": "div.cover-title",
    "author": "div.byline-attr-author",
    "date": {"selector": "time", "attribute": "datetime", "index": [0]},
    "source": {"selector": "a.subtle-link.fin-size-small", "attribute": "href"},
    "article": "div.body",
    "quotes": {"selector": "div.body p a", "attribute": "href"},
}


def cdx_site(seed: int) -> tuple[dict[str, str], list[str]]:
    """A CDX dump for each of the 1,521 prefixes, ``HARVEST_ROWS`` rows each
    inside an HTML page, keyed by prefix; and the urls the merge must keep,
    in their first-seen order over the shards' sorted file names.  Rows draw
    from ``HARVEST_UNIQUE`` articles (each at least once, the rest repeats
    across shards) as ``https``, ``http``, ``http`` with ``:80`` or with a
    query; 2% ``news/%`` and 2% ``news/'`` junk, 3% without ``.html``;
    ``HARVEST_TRAP_SHARDS`` shards hold a double-space row (its fields
    shift: that shard's ``date_time`` turns float) and a short row."""
    from advanced_scrapper_tpu_torch.pipeline.harvest import CHAR_LIST

    rng = np.random.RandomState(seed)
    prefixes = [a + b for a in CHAR_LIST for b in CHAR_LIST]
    n = len(prefixes) * HARVEST_ROWS
    ids = np.concatenate([np.arange(HARVEST_UNIQUE),
                          rng.randint(0, HARVEST_UNIQUE, n - HARVEST_UNIQUE)])
    rng.shuffle(ids)
    kinds = rng.rand(n)
    variants = rng.randint(0, 4, n)
    stamps = 20150101000000 + rng.randint(0, 10 ** 9, n)
    traps = set(rng.choice(len(prefixes), HARVEST_TRAP_SHARDS, replace=False).tolist())
    host = "finance.yahoo.com"
    pages, kept = {}, {}
    for s, prefix in enumerate(prefixes):
        lines, urls = [], []
        for r in range(s * HARVEST_ROWS, (s + 1) * HARVEST_ROWS):
            slug = f"story-{ids[r]}"
            u, keep = kinds[r], None
            if u < 0.02:
                url = f"https://{host}/news/%20{slug}.html"
            elif u < 0.04:
                url = f"https://{host}/news/'{slug}.html"
            elif u < 0.07:
                url = f"https://{host}/news/{slug}.jpg"
            else:
                url = (f"https://{host}/news/{slug}.html", f"http://{host}/news/{slug}.html",
                       f"http://{host}:80/news/{slug}.html",
                       f"https://{host}/news/{slug}.html?src=rss")[variants[r]]
                keep = f"https://{host}/news/{slug}.html"
            key = f"com,yahoo,finance)/news/{slug}"
            line = f"{key} {stamps[r]} {url} text/html 200 D{ids[r]:X} {700 + r % 900}"
            if s in traps and r % HARVEST_ROWS == 5:
                line, keep = f"{key}  {stamps[r]} {url} text/html 200", None
            elif s in traps and r % HARVEST_ROWS == 9:
                line, keep = f"{key} {stamps[r]}", None
            lines.append(line)
            urls.append(keep)
        pages[prefix] = "<html><body><pre>" + "\n".join(lines) + "\n</pre></body></html>"
        kept[prefix] = urls
    seen: dict[str, None] = {}
    for prefix in sorted(prefixes):
        for url in kept[prefix]:
            if url is not None:
                seen.setdefault(url)
    return pages, list(seen)


def harvest_path(card: str, dev=None) -> None:
    """The CDX harvest plane: ``run_harvest`` over all 1,521 prefixes served
    by ``MockTransport`` (``cdx_site``), 10 worker threads, then the merge's
    ``ExactDedup`` on ``dev`` (``None``: the card).  Checks: the merged CSV
    byte-equal to a ``device="cpu"`` merge of the same shard directory and
    its urls the first-seen ones the generator planted; the async engine
    (``harvest_shards_async`` with an injected fetch over the same pages)
    writes shard files byte-equal to the threaded engine's; a resume after
    deleting 10% of the ``.txt`` checkpoints fetches exactly those shards
    and leaves the output byte-equal."""
    import asyncio
    import contextlib
    import csv
    import dataclasses
    import io
    import tempfile

    from advanced_scrapper_tpu_torch.config import HarvestConfig
    from advanced_scrapper_tpu_torch.net.transport import MockTransport
    from advanced_scrapper_tpu_torch.pipeline import dedup, harvest, harvest_async

    t_phase = time.perf_counter()
    pages, want_urls = cdx_site(43)
    generate_s = time.perf_counter() - t_phase
    rows = len(pages) * HARVEST_ROWS

    def page_of(url: str) -> str:
        return pages[url.rsplit("news/", 1)[1].rstrip("*")]

    made, merges = [], []
    exact, merge = dedup.ExactDedup, harvest.merge_shards

    class Recorded(exact):  # keeps the merge's instance for its last_path
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def timed_merge(*a, **kw):
        t0 = time.perf_counter()
        n = merge(*a, **kw)
        merges.append(time.perf_counter() - t0)
        return n

    console = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(console):
        cfg = HarvestConfig(shard_dir=os.path.join(tmp, "threads"),
                            output_csv=os.path.join(tmp, "yfin_urls.csv"),
                            num_workers=HARVEST_WORKERS)
        dedup.ExactDedup, harvest.merge_shards = Recorded, timed_merge
        try:
            t0 = time.perf_counter()
            assert harvest.run_harvest(cfg, transport=MockTransport(page_of), device=dev) == 0
            run_s = time.perf_counter() - t0
            card_merge_s = merges[-1]
            out = open(cfg.output_csv, "rb").read()
            t0 = time.perf_counter()
            cpu_cfg = dataclasses.replace(cfg, output_csv=os.path.join(tmp, "cpu.csv"))
            unique = harvest.merge_shards(cpu_cfg, device="cpu")
            cpu_merge_s = time.perf_counter() - t0
            assert open(cpu_cfg.output_csv, "rb").read() == out, "card and CPU merges differ"
            with open(cfg.output_csv, newline="", encoding="utf-8") as f:
                got_rows = list(csv.DictReader(f))
            assert [r["url"] for r in got_rows] == want_urls, "merged urls differ from the plan"
            threads_tree = tree_bytes(cfg.shard_dir)
            assert len(threads_tree) == 2 * len(pages), len(threads_tree)

            acfg = dataclasses.replace(cfg, shard_dir=os.path.join(tmp, "async"))

            async def fetch(url: str) -> str:
                return page_of(url)

            t0 = time.perf_counter()
            n_async = asyncio.run(harvest_async.harvest_shards_async(acfg, fetch=fetch))
            async_s = time.perf_counter() - t0
            assert n_async == len(pages), n_async
            assert tree_bytes(acfg.shard_dir) == threads_tree, "async shards differ"

            rng = np.random.RandomState(44)
            gone = sorted(rng.choice(sorted(pages), int(len(pages) * HARVEST_RESUME),
                                     replace=False).tolist())
            for prefix in gone:
                os.remove(os.path.join(cfg.shard_dir, f"yahoo_{prefix}.txt"))
            again = MockTransport(page_of)
            t0 = time.perf_counter()
            assert harvest.run_harvest(cfg, transport=again, device=dev) == 0
            resume_s = time.perf_counter() - t0
            assert sorted(again.fetched) == sorted(harvest.cdx_query_url(p, cfg) for p in gone)
            assert open(cfg.output_csv, "rb").read() == out, "the resume changed the output"
            assert tree_bytes(cfg.shard_dir) == threads_tree
        finally:
            dedup.ExactDedup, harvest.merge_shards = exact, merge
    sweep_s = run_s - card_merge_s
    log("harvest_path", shards=len(pages), rows=rows, unique_urls=unique,
        planned_articles=HARVEST_UNIQUE, workers=HARVEST_WORKERS, generate_s=generate_s,
        sweep_s=sweep_s, shards_per_s=len(pages) / sweep_s, rows_per_s=rows / sweep_s,
        async_s=async_s, async_shards_per_s=len(pages) / async_s,
        merge_s=card_merge_s,
        merge_cpu_s=cpu_merge_s, exact_path=made[0].last_path,
        date_time_float=got_rows[0]["date_time"].endswith(".0"),
        resume=dict(deleted=len(gone), fetched=len(again.fetched), seconds=resume_s),
        card_equals_cpu=True, async_equals_threads=True, phase_s=time.perf_counter() - t_phase,
        card=card)


def lease_path(card: str, dev=None) -> tuple[int, int]:
    """The lease plane: 8,192 yfin pages (``scrape_pages``, seed 41) through
    a ``LeaseServer`` and 4 ``LeaseClient``s of 2 fetch threads each on
    loopback; the first client's socket is shut down once a quarter of the
    pages are in, so the server requeues its leases.  ``process_results``
    then parses every result centrally, streaming its successes into
    ``TpuBatchBackend(DedupConfig())`` on ``dev``.  Checks: every url
    answered exactly once; one ``minhash_fold_segments`` launch a batch of
    successes and no other launch; replaying ``server.results`` in arrival
    order through ``process_results`` into a CPU backend writes byte-equal
    success and failed CSVs and equal annotations.  Returns the launches and
    the batches."""
    import socket
    import tempfile
    import threading

    from advanced_scrapper_tpu_torch.config import DedupConfig, FeedConfig
    from advanced_scrapper_tpu_torch.extractors import load_extractor
    from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend
    from advanced_scrapper_tpu_torch.net.lease import LeaseClient, LeaseServer
    from advanced_scrapper_tpu_torch.net.transport import MockTransport

    t_phase = time.perf_counter()
    urls, pages, planted, titleless, limited = scrape_pages(np.random.RandomState(41), LEASE_PAGES)
    generate_s = time.perf_counter() - t_phase
    cfg = FeedConfig(host="127.0.0.1", port=0, batch_size=64, min_queue_length=32,
                     client_threads=LEASE_THREADS, client_rate=200.0)
    server = LeaseServer(cfg, urls, status_port=0).start()
    dialled = []

    def dial(addr):
        sock = socket.create_connection(addr, timeout=10)
        dialled.append(sock)
        return sock

    clients = [LeaseClient(cfg, lambda: MockTransport(pages), port=server.port,
                           connect=dial if i == 0 else None) for i in range(LEASE_CLIENTS)]
    sent = [0] * LEASE_CLIENTS

    def work(i):
        sent[i] = clients[i].run(max_seconds=300.0)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(LEASE_CLIENTS)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 300.0
    while len(server.results) < LEASE_PAGES // 4 and time.monotonic() < deadline:
        time.sleep(0.005)
    cut_at = len(server.results)
    dialled[0].shutdown(socket.SHUT_RDWR)  # the first client's link dies mid-run
    done = server.wait_done(300.0)
    round_trip_s = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=60)
    status = server.fleet_status()
    requeued = server._m_requeued.value
    server.stop()
    assert done, f"{server._pending} urls never answered"
    answered = [r["url"] for r in server.results]
    assert sorted(answered) == sorted(urls) and len(set(answered)) == len(answered)
    assert requeued > 0, "the dead client's leases were never requeued"

    extractor = load_extractor("yfin")
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for where in ("card", "cpu"):
            ann: list[dict] = []
            backend = TpuBatchBackend(DedupConfig(), sink=ann.append,
                                      device=dev if where == "card" else "cpu")
            replay = server
            if where == "cpu":
                replay = LeaseServer(cfg, [])
                replay.results = list(server.results)
            ok_csv, bad_csv = (os.path.join(tmp, f"{where}_{k}.csv") for k in ("ok", "bad"))
            busy_ms = None
            with contextlib.ExitStack() as stack:
                prof = None
                if where == "card" and dev != "cpu":
                    from torch.profiler import ProfilerActivity, profile

                    prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
                reset_launches()
                t0 = time.perf_counter()
                ok, bad = replay.process_results(extractor, ok_csv, bad_csv,
                                                 on_success=backend.submit)
                backend.flush()
                seconds = time.perf_counter() - t0
                launches = read_launches()
                if prof is not None:
                    torch.cuda.synchronize()
            if prof is not None:
                seen = [e for e in prof.key_averages() if e.device_time_total > 0]
                busy_ms = sum(e.device_time_total for e in seen) / 1e3 or None
            backend.close()
            out[where] = dict(ok=ok, bad=bad, seconds=seconds, launches=launches, ann=ann,
                              busy_ms=busy_ms, csvs=(open(ok_csv, "rb").read(),
                                                     open(bad_csv, "rb").read()))
    card_run, cpu_run = out["card"], out["cpu"]
    assert card_run["csvs"] == cpu_run["csvs"], "card and CPU CSVs differ"
    assert card_run["ann"] == cpu_run["ann"], "card and CPU annotations differ"
    assert card_run["ok"] + card_run["bad"] == LEASE_PAGES
    assert card_run["bad"] == len(titleless) + 1, (card_run["bad"], len(titleless))
    batches = -(-card_run["ok"] // DedupConfig().batch_size)
    got = card_run["launches"]
    if dev != "cpu":
        assert got["minhash_fold_segments"] == batches > 0, (got, batches)
        assert sum(got.values()) == batches, got
    near = {r["url"]: r["near_dup_of"] for r in card_run["ann"]}
    missed = [c for c, s in planted.items() if near.get(c) != s and near.get(s) != c]
    assert not missed, f"{len(missed)} of {len(planted)} planted copies not annotated"
    busy_ms = card_run["busy_ms"]
    log("lease_path", pages=LEASE_PAGES, clients=LEASE_CLIENTS, fetch_threads=LEASE_THREADS,
        batch_size=cfg.batch_size, generate_s=generate_s, round_trip_s=round_trip_s,
        pages_per_s=LEASE_PAGES / round_trip_s, sent=sent, cut_at=cut_at, requeued=requeued,
        fleet_status=status, succeeded=card_run["ok"], failed=card_run["bad"],
        planted=len(planted), process_results_s=card_run["seconds"],
        process_results_pages_per_s=LEASE_PAGES / card_run["seconds"],
        cpu_replay_s=cpu_run["seconds"], batches=batches, launches=got, card_busy_ms=busy_ms,
        card_busy_share=None if busy_ms is None else busy_ms / 1e3 / card_run["seconds"],
        card_equals_cpu=True, phase_s=time.perf_counter() - t_phase, card=card)
    return got["minhash_fold_segments"], batches


def http_json(url: str, obj=None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def control_path(card: str) -> None:
    """The control server on an ephemeral loopback port over the scrape
    cell's first pages: ``add_template``, 256 synchronous
    ``extract_and_get_article`` calls and 64 asynchronous ones polled to
    their result.  Checks: every answer's fields equal the template applied
    in this process (``extract_with_template`` on the tree), and each page
    was persisted."""
    import tempfile

    from advanced_scrapper_tpu_torch.core.soup import Soup
    from advanced_scrapper_tpu_torch.extractors.template import extract_with_template
    from advanced_scrapper_tpu_torch.net.control import ControlPlane, ControlServer
    from advanced_scrapper_tpu_torch.net.transport import MockTransport

    t_phase = time.perf_counter()
    urls, pages, _planted, _titleless, _limited = scrape_pages(
        np.random.RandomState(41), CONTROL_SYNC + CONTROL_ASYNC)
    want = {u: extract_with_template(Soup(pages[u]), CONTROL_TEMPLATE) for u in urls}
    with tempfile.TemporaryDirectory() as tmp:
        plane = ControlPlane(lambda: MockTransport(pages),
                             templates_path=os.path.join(tmp, "templates.json"), out_root=tmp)
        server = ControlServer(plane).start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            assert http_json(base + "/add_template", {"name": "yfin_tpl",
                                                     "template": CONTROL_TEMPLATE})[0] == 200
            t0 = time.perf_counter()
            for u in urls[:CONTROL_SYNC]:
                code, got = http_json(base + "/extract_and_get_article",
                                      {"url": u, "template": "yfin_tpl"})
                assert code == 200 and got == want[u], u
            sync_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rids = {u: http_json(base + "/extract_and_get_article",
                                 {"url": u, "template": "yfin_tpl", "async": True})[1]["request_id"]
                    for u in urls[CONTROL_SYNC:]}
            for u, rid in rids.items():
                deadline = time.monotonic() + 60
                while (res := http_json(f"{base}/get_result/{rid}"))[0] == 202:
                    assert time.monotonic() < deadline, rid
                    time.sleep(0.002)
                assert res == (200, want[u]), u
            async_s = time.perf_counter() - t0
            status = http_json(base + "/status")[1]["control"]
        finally:
            server.stop()
        persisted = len(os.listdir(os.path.join(tmp, "yfin_tpl")))
    assert persisted == len(urls), persisted
    assert status["results_done"] == CONTROL_ASYNC, status
    log("control_path", sync=CONTROL_SYNC, sync_s=sync_s, sync_per_s=CONTROL_SYNC / sync_s,
        asynchronous=CONTROL_ASYNC, async_s=async_s, async_per_s=CONTROL_ASYNC / async_s,
        persisted=persisted, fields_equal=True, phase_s=time.perf_counter() - t_phase, card=card)


def pipe_path(card: str) -> None:
    """A ``PipePool`` of 3 ``pipe_worker`` processes over 1,024 urls with a
    template extractor and the mock transport (the pages travel in the
    worker's argv, so they are small).  Checks: every url answered once,
    each result's fields equal the template applied in this process, and no
    worker loaded torch."""
    from advanced_scrapper_tpu_torch.core.soup import Soup
    from advanced_scrapper_tpu_torch.extractors.template import extract_with_template
    from advanced_scrapper_tpu_torch.net.pipe_pool import PipePool

    t_phase = time.perf_counter()
    rng = np.random.RandomState(45)
    template = {"title": "b", "tags": {"selector": "i", "attribute": "text"}}
    pages = {f"u{i}": f"<b>t{i} {letters(rng, 2, 6)}</b><i>{rng.randint(99)}</i>"
             for i in range(PIPE_URLS)}
    want = {u: {**extract_with_template(Soup(p), template), "url": u} for u, p in pages.items()}
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    pool = PipePool(num_workers=PIPE_WORKERS,
                    config={"transport": "mock", "pages": pages, "template": template}).start()
    try:
        t0 = time.perf_counter()
        for u in pages:
            assert pool.dispatch(u, timeout=60)
        got = pool.drain(len(pages), timeout=120)
        seconds = time.perf_counter() - t0
        loaded = []
        for p in pool._procs:
            with open(f"/proc/{p.pid}/maps") as f:
                loaded.append(torch_lib in f.read())
    finally:
        pool.stop()
    assert len(got) == len(pages) and {r["url"]: r for r in got} == want
    assert loaded == [False] * PIPE_WORKERS, "a pipe worker loaded torch"
    log("pipe_path", workers=PIPE_WORKERS, urls=PIPE_URLS, seconds=seconds,
        urls_per_s=PIPE_URLS / seconds, fields_equal=True, torch_in_workers=False,
        phase_s=time.perf_counter() - t_phase, card=card)


def hostplanes_main() -> int:
    """``--hostplanes``: the harvest and lease planes at the users' sizes
    (``harvest_path``, ``lease_path``), then ``control_path`` and
    ``pipe_path``; kept out of the default run for the run's time."""
    card = card_start(("minhash",))
    if card is None:
        return 2
    t0 = time.perf_counter()
    harvest_path(card)
    launches, batches = lease_path(card)
    control_path(card)
    pipe_path(card)
    log("hostplanes", kernel="minhash_fold_segments",
        lease_path={"launches": launches, "batches": batches},
        seconds=time.perf_counter() - t0, card=card)
    return card_end(card)


def card_start(sources: tuple[str, ...]) -> str | None:
    """The card's name and power limit after the device line and the
    build of ``sources`` (one ``nvcc`` each, all at once); ``None`` without
    a card."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on the card",
              file=sys.stderr)
        return None
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from advanced_scrapper_tpu_torch.ops import _build

    card = nvidia_smi("name,power.limit")
    log("device", card=card, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        host_cpu=host_cpu(), host_cores=os.cpu_count())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    log("build", seconds=time.perf_counter() - t0, built=list(sources))
    return card


def card_end(card: str) -> int:
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def fleet_main() -> int:
    """``--fleet``: the persist mode's two sessions (``persist_path``, whose
    session 1 the elastic fleet reuses), ``fleet_path``, then
    ``reshard_path`` and ``gateway_path`` on one ``ShardFleet``
    (``elastic_paths``), at the default run's depth; kept out of the
    default run for the run's time."""
    card = card_start(("minhash",))
    if card is None:
        return 2
    t0 = time.perf_counter()
    docs, planted = ragged_corpus(np.random.RandomState(7), MAIN_ARTICLES)
    persist_launches, persist_batches, local = persist_path(docs, planted, card)
    fleet_launches, fleet_batches = fleet_path(docs, card, local)
    (reshard_launches, reshard_batches), (gateway_launches, gateway_batches) = elastic_paths(
        docs, card, local)
    log("fleet_launches", kernel="minhash_fold_segments",
        persist_path={"launches": persist_launches, "batches": persist_batches},
        fleet_path={"launches": fleet_launches, "batches": fleet_batches},
        reshard_path={"launches": reshard_launches, "batches": reshard_batches},
        gateway_path={"launches": gateway_launches, "batches": gateway_batches},
        seconds=time.perf_counter() - t0, card=card)
    return card_end(card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(*sys.argv[2:]))
    if sys.argv[1:] == ["--scrape"]:
        sys.exit(scrape_main())
    if sys.argv[1:] == ["--fleet"]:
        sys.exit(fleet_main())
    if sys.argv[1:] == ["--hostplanes"]:
        sys.exit(hostplanes_main())
    sys.exit(main())
