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
- the default engine once over the 65,536 ragged articles: every planted
  duplicate resolves to its source; the settle kernel timed on the tier's
  inputs there as well (the ``rerank_settle`` row's
  ``default_engine_main_corpus`` fields).

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
the CPU.  And ``ExactDedup`` over ``bench.py``'s 262,144 urls
(``exact_path``): the default tier (which one served), the blob tier and
the grouping path with its hash on the card, best of 5, each equal to a
first-seen dict.  Then ``cross_source_dedup`` (``cross_source_path``)
over three sources made from the ragged corpus: a success CSV of 32,768
articles, a second CSV and a sqlite store of 16,384 each, 10% of the last
two copies of first-source articles under other urls: every planted copy
of an eligible source is a dup in the manifest, one launch per batch;
card and CPU manifests byte-equal on a 2,048-article cut.

Then the card engines and the CPU engines (estimator-only, default,
``rerank=False``) must agree on 2,048 articles.

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

import json
import os
import re
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
                       windows: int = 3) -> dict[str, tuple[float, int]]:
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
    sass["pipe_floor_ms"] = {
        pipe: pair_steps * sass["by_pipe_per_step"].get(pipe, 0.0)
        / (lanes * CARD_SMS * clock_mhz * 1e6) * 1e3
        for pipe, lanes in PIPE_LANES_PER_SM.items()}
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
    from advanced_scrapper_tpu_torch.ops import editdist_cuda, match_cuda, minhash_cuda, rerank_cuda

    return {f.__name__: f for f in (
        minhash_cuda.minhash_fold_segments, minhash_cuda.minhash_fold,
        minhash_cuda.minhash_sig, rerank_cuda.rerank_settle, match_cuda.match_screen,
        editdist_cuda.myers_bound, editdist_cuda.myers_pairs)}


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


PERSIST_SPLIT = 32768  # session 1 takes the first half of the stream
PERSIST_PARITY_SPLIT = 1024  # the 2,048 parity records: two sessions
AGAINST_INDEX_ARTICLES = 4096


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _dirs, files in os.walk(path) for f in files)


def persist_path(docs: list[bytes], planted: dict[int, int], card: str) -> tuple[int, int]:
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
    kernel's launches over the two sessions and the batches."""
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
        for part in (records[:PERSIST_SPLIT], records[PERSIST_SPLIT:]):
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
    return launches, batches


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

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log("device", card=card, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        numpy=np.__version__, host_cpu=host_cpu(), host_cores=os.cpu_count())

    t0 = time.perf_counter()
    sources = ("minhash", "rerank", "match", "editdist")
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
    log("main_path", articles=MAIN_ARTICLES, text_bytes=text_bytes, seconds=seconds,
        articles_per_s=MAIN_ARTICLES / seconds, first_call_seconds=first_call_seconds,
        pinned_alloc_ms=pinned_alloc_ms, chunks=chunks,
        chunk_bytes=dedup.CHUNK_BYTES, segment_shingles=SEGMENT_SHINGLES,
        h2d_bytes=h2d, fold_segments_launches=seg_launches, planted=len(planted),
        dups=int((reps != idx).sum()), card=card)

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

    kernels = [
        kernel_entry("minhash_fold_segments", seg_launches, seg_ms, seg_plain_ms,
                     seg_ops_ms, seg_bytes_ms),
        kernel_entry("minhash_fold", fold_launches, fold_ms, fold_plain_ms,
                     fold_ops_ms, fold_bytes_ms),
        kernel_entry("minhash_sig", sig_launches, sig_ms, sig_plain_ms,
                     sig_ops_ms, sig_bytes_ms),
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
    persist_launches, persist_batches = persist_path(docs, planted, card)
    del docs
    exact_path(card)
    cross_launches, cross_batches = cross_source_path(card)
    kernels[0]["stream_path"] = {"launches": stream_launches, "batches": stream_batches}
    kernels[0]["persist_path"] = {"launches": persist_launches, "batches": persist_batches}
    kernels[0]["cross_source_path"] = {"launches": cross_launches, "batches": cross_batches}
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
    default_equal = bool((default.dedup_reps(rsmall) == cpu_default.dedup_reps(rsmall)).all())
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
    assert len(kernels) == 7, [k["name"] for k in kernels]

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
