"""Variants of the matcher's kernels on the card: a tuning probe.

    python3 myers_probe.py [--parent DIR]
    python3 myers_probe.py --pairs [--parent DIR]

Builds copies of ``advanced_scrapper_tpu_torch/csrc/editdist.cu`` (the
Myers bound) with other values of its constants (chains a thread, unroll,
blocks an SM; :data:`VARIANTS`) and of ``csrc/match.cu`` (the q-gram
screen) with other row-slice widths and block sizes
(:data:`SCREEN_VARIANTS`), applied by text substitution, into
``build/kernels/probe/``, and, with ``--parent``, both sources of another
checkout (an earlier design, e.g. the parent commit unpacked with ``git
archive``), all at once, one nvcc each.  Then, on the matcher cell's chunk
of ``chip_smoke.py`` (S&P scale: 500 tickers, 20,000 articles), it holds
the shipped kernels bit-equal to their plain versions on the edge cases of
``chip_smoke.check_match_vs_plain`` and on the chunk (the bound on its
first rows), holds every variant's output equal to the shipped kernel's
(the bound's mask bits and distances, the screen's mask; not the screen's
phase cuts, :data:`SCREEN_PHASE_CUTS`, which skip a phase to show what
it costs), and times each with CUDA events over 5 launches after a warm
one, queued behind a spin of the card so that they run back to back,
twice (every variant in order, then in reverse), the SM clock read before
and after each; the screens also by the profiler (ms per recorded launch
of 5).  One JSON line per variant, with its SASS instructions per step of
its inner loop (``ops/sass.py``): a Myers step, or a screen probe, per
(row, gram) and per written pair.

With ``--pairs`` it takes the per-pair kernel ``myers_pairs`` alone: the
shipped source and its variants (:data:`PAIRS_VARIANTS`: steps a mask is
read ahead, warps a block, steps a window, a window's steps as a loop)
and, with ``--parent``, the other checkout's ``editdist.cu``, each held bit-equal to ``semiglobal_dist_plain`` on the
S&P chunk's legacy batches (``chip_smoke.legacy_batches``: 157 launches
of a few hundred pairs) and timed over them by CUDA events, 5 passes
queued behind a ~100 ms spin of the card, in turns (parent, shipped, the
variants, then the same in reverse), the SM clock read before and after
each, then by the profiler (ms per recorded launch) beside a lone pair on
a 543-byte and on a 1-byte text (their slope: the time of a step of a
lone chain, ``chip_smoke.lone_step_ms``), with the SASS instructions a
step of its step loop (``ops/sass.py:pairs_sass``).  Needs one card and ``nvcc``; run it from
the repo's root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops import _build
from advanced_scrapper_tpu_torch.ops.sass import screen_sass

CHAINS = "constexpr int kChains = 4;"
UNROLL = "constexpr int kUnroll = 8;"
MIN_BLOCKS = "constexpr int kMinBlocks = 4;"

#: editdist.cu variants: name -> [(text in the source, its replacement)];
#: "shipped" is the source
VARIANTS = {
    "shipped": [],
    "t2": [(CHAINS, "constexpr int kChains = 2;")],
    "t5": [(CHAINS, "constexpr int kChains = 5;")],
    "t8": [(CHAINS, "constexpr int kChains = 8;"), (MIN_BLOCKS, "constexpr int kMinBlocks = 3;")],
    "unroll_4": [(UNROLL, "constexpr int kUnroll = 4;")],
}

PAIR_WARPS = "constexpr int kPairWarps = 4;"
WINDOW = "constexpr int kWindow = 64;"
AHEAD = "constexpr int kAhead = 8;"

UNROLL_PASS = "#pragma unroll\n  for (int u0 = 0;"

#: editdist.cu variants of myers_pairs: masks read 4 and 16 steps ahead
#: (passes of as many steps); 2 warps a block (a pair of 65,536 bytes then
#: takes 2 rounds); windows of 32 steps (a refill twice as often,
#: less shared memory); a window's steps a loop of kAhead-step passes
#: (~8x less code than the window unrolled whole)
PAIRS_VARIANTS = {
    "shipped": [],
    "pairs_ahead4": [(AHEAD, "constexpr int kAhead = 4;")],
    "pairs_ahead16": [(AHEAD, "constexpr int kAhead = 16;")],
    "pairs_w2": [(PAIR_WARPS, "constexpr int kPairWarps = 2;")],
    "pairs_window32": [(WINDOW, "constexpr int kWindow = 32;")],
    "pairs_passes": [(UNROLL_PASS, "#pragma unroll 1\n  for (int u0 = 0;")],
}
#: GPU clocks the card spins before a queued pass of the chunk's launches
#: (~100 ms at 1980 MHz: the host makes 785 launches meanwhile)
PAIRS_AHEAD_CYCLES = 200_000_000

ENTRY = "using Entry = uint32_t;"
THREADS = "constexpr int kThreads = 1024;"
SCREEN_MIN_BLOCKS = "constexpr int kMinBlocks = 1;"

#: match.cu variants: 32 rows a block at 512 threads; 16 rows (2 blocks of
#: 512 an SM) and 8 rows (4 blocks of 256) over smaller bitmaps
SCREEN_VARIANTS = {
    "shipped": [],
    "t512": [(THREADS, "constexpr int kThreads = 512;")],
    "r16": [(ENTRY, "using Entry = uint16_t;"), (THREADS, "constexpr int kThreads = 512;"),
            (SCREEN_MIN_BLOCKS, "constexpr int kMinBlocks = 2;")],
    "r8": [(ENTRY, "using Entry = uint8_t;"), (THREADS, "constexpr int kThreads = 256;"),
           (SCREEN_MIN_BLOCKS, "constexpr int kMinBlocks = 4;")],
}

#: match.cu with one phase cut out (or, ``plain_or``, the bitmap's atomic
#: ORs made plain read-modify-writes that race): timed beside the others to
#: show where the shipped kernel's time goes; their masks are not the
#: screen's and are not checked
SCREEN_PHASE_CUTS = {
    "cut_windows": [("q < chunks; q += kThreads", "q < 0; q += kThreads")],
    "cut_probes": [("a < len; a += kFlush", "a < 0; a += kFlush")],
    "cut_writes": [("rr < nrows; ++rr) o[", "rr < 0; ++rr) o[")],
    "plain_or": [("atomicOr(&words[bit / kPerWord], row_bit << ((bit % kPerWord) * kRows));",
                  "words[bit / kPerWord] |= row_bit << ((bit % kPerWord) * kRows);")],
}

#: source -> its variants
SOURCES = {"editdist": VARIANTS, "match": {**SCREEN_VARIANTS, **SCREEN_PHASE_CUTS}}


def patched(source: str, edits: list[tuple[str, str]]) -> str:
    """``source`` with each edit applied; raises if a text is not there
    exactly once."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"not once in the source: {old!r}")
        source = source.replace(old, new)
    return source


def build_sources(srcs: dict[tuple[str, str], Path]) -> dict[tuple[str, str], Path]:
    """Each ``(source, variant) -> .cu`` compiled into
    ``build/kernels/probe/`` at once, one nvcc each; the same keys -> their
    libraries.  Prints each one's registers."""
    outdir = _build.BUILD_DIR / "probe"
    outdir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for key, src in srcs.items():
        libs[key] = outdir / f"lib{key[0]}-{key[1]}.so"
        procs[key] = subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-o", str(libs[key]),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{out[-2000:]}")
        regs = re.findall(r"Used (\d+) registers", out)
        print(json.dumps({"source": key[0], "variant": key[1],
                          "registers": [int(r) for r in regs]}), flush=True)
    return libs


def build_variants(parent: Path | None, sources: dict = SOURCES) -> dict[tuple[str, str], Path]:
    """Every variant of ``sources`` (and the parent's sources) compiled at
    once; ``(source, variant) -> library``."""
    outdir = _build.BUILD_DIR / "probe"
    outdir.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for source, variants in sources.items():
        text = (_build.CSRC_DIR / f"{source}.cu").read_text()
        for name, edits in variants.items():
            srcs[source, name] = outdir / f"{source}-{name}.cu"
            srcs[source, name].write_text(patched(text, edits))
        if parent is not None:
            srcs[source, "parent"] = parent_source(parent, source)
    return build_sources(srcs)


def parent_source(parent: Path, source: str) -> Path:
    return parent / "advanced_scrapper_tpu_torch" / "csrc" / f"{source}.cu"


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    lib.astt_myers_bound.argtypes = [p, p, p, p, p, ctypes.c_longlong, p, p, p, p,
                                     ctypes.c_int, ctypes.c_float, p, ctypes.c_int, p, p]
    lib.astt_myers_bound.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, t: dict, mask: torch.Tensor, dist: torch.Tensor | None) -> None:
    """One launch of a bound variant on the tensors ``t`` (checked once by
    the shipped wrapper on the same tensors)."""
    hmt = np.float32(100.0) - np.float32(t["threshold"])
    err = lib.astt_myers_bound(
        t["text"].data_ptr(), t["off"].data_ptr(), t["len"].data_ptr(), t["tl"].data_ptr(),
        t["fl"].data_ptr(), t["off"].numel(), t["masks"].data_ptr(), t["plens"].data_ptr(),
        t["ok"].data_ptr(), t["cols"].data_ptr(), t["plens"].numel(), float(hmt),
        mask.data_ptr(), mask.shape[1], None if dist is None else dist.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")


def load_screen(path: Path, source: Path) -> tuple[ctypes.CDLL, bool]:
    """A built ``match.cu`` and whether it takes the CSR of the names
    (the earlier block-per-row design) rather than the sorted layout of
    ``ops/match.py:screen_layout``, as its ``source`` says."""
    lib = ctypes.CDLL(str(path))
    csr = "slot_col" not in source.read_text()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.astt_match_screen.argtypes = (
        [p, p, p, p, p, ctypes.c_longlong, p, p, p, p, p, p, i, ctypes.c_float, p, p] if csr
        else [p, p, p, p, p, ctypes.c_longlong, p, p, p, p, i, p, p, p, p, i, ctypes.c_float,
              p, p])
    lib.astt_match_screen.restype = i
    return lib, csr


def launch_screen(lib: ctypes.CDLL, csr: bool, t: dict, out: torch.Tensor) -> None:
    """One launch of a screen variant on the rows of ``t``, its name
    tables ``t["screen"]`` and ``t["frac"]`` (``ops.match.screen_frac``;
    all checked once by the shipped wrapper)."""
    from advanced_scrapper_tpu_torch.ops.match import SCREEN_TILE_COLS

    s = t["screen"]
    rows = [t[k].data_ptr() for k in ("text", "off", "len", "tl", "ttl")]
    names = [s[k].data_ptr() for k in ("kept", "total", "name_len", "fuzzy")]
    frac, stream = float(t["frac"]), torch.cuda.current_stream().cuda_stream
    n = s["kept"].numel()
    if csr:
        err = lib.astt_match_screen(*rows, t["off"].numel(), s["gram_off"].data_ptr(),
                                    s["grams"].data_ptr(), *names, n, frac, out.data_ptr(),
                                    stream)
    else:
        err = lib.astt_match_screen(
            *rows, t["off"].numel(),
            *[s[k].data_ptr() for k in ("slot_col", "group_off", "grams_il", "tile_groups")],
            SCREEN_TILE_COLS, *names, n, frac, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"screen variant launch failed: CUDA error {err}")


def load_pairs(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.astt_myers_pairs.argtypes = [p, ctypes.c_longlong, p, p, i, p, p, i, p, p, i, p, p]
    lib.astt_myers_pairs.restype = i
    return lib


def launch_pairs(lib: ctypes.CDLL, pmasks: torch.Tensor, plens: torch.Tensor, batch: tuple,
                 out: torch.Tensor) -> None:
    """One ``myers_pairs`` launch of a built library on one legacy batch
    (``chip_smoke.pair_inputs``; checked once by the shipped wrapper)."""
    text, off, tl, pt, pp = batch
    err = lib.astt_myers_pairs(
        text.data_ptr(), text.numel(), off.data_ptr(), tl.data_ptr(), off.numel(),
        pmasks.data_ptr(), plens.data_ptr(), plens.numel(), pt.data_ptr(), pp.data_ptr(),
        pt.numel(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"myers_pairs variant launch failed: CUDA error {err}")


def pairs_main(parent: Path | None, card: str) -> int:
    """``--pairs``: see the module's docstring."""
    import chip_smoke as cs

    from advanced_scrapper_tpu_torch.ops import editdist_cuda
    from advanced_scrapper_tpu_torch.ops.editdist import semiglobal_dist_plain
    from advanced_scrapper_tpu_torch.ops.sass import pairs_sass
    from advanced_scrapper_tpu_torch.pipeline.matcher import EntityIndex, process_json_data

    libs = build_variants(parent, {"editdist": PAIRS_VARIANTS})
    text = (_build.CSRC_DIR / "editdist.cu").read_text()
    texts = {name: patched(text, edits) for name, edits in PAIRS_VARIANTS.items()}
    if parent is not None:
        texts["parent"] = parent_source(parent, "editdist").read_text()
    libs = {name: path for (_s, name), path in sorted(libs.items(),
                                                      key=lambda x: x[0][1] != "parent")}
    dev = torch.device("cuda")
    rng = np.random.RandomState(17)
    entities = cs.sp500_entities(rng)
    records, _planted = cs.sp500_articles(rng, entities, cs.MATCH_ARTICLES)
    index = EntityIndex(process_json_data(entities))
    _screened, batches = cs.legacy_batches(records, index, dev)
    inputs, work = cs.pair_inputs(batches, dev)
    _screen, (pmasks, plens, _ok, _cols) = index.device_tables(dev)
    want = semiglobal_dist_plain(pmasks, plens, *cs.joined_pairs(inputs), pairs_per_batch=1 << 16)
    shipped = torch.cat([editdist_cuda.myers_pairs(pmasks, plens, *b) for b in inputs])
    torch.cuda.synchronize()
    assert torch.equal(shipped, want), "myers_pairs differs from semiglobal_dist_plain on the chunk"
    outs = [torch.empty(b[3].numel(), dtype=torch.int32, device=dev) for b in inputs]
    lone_out = torch.empty(1, dtype=torch.int32, device=dev)

    def lone(n: int) -> tuple:
        """One pair on a text of n bytes (one tile)."""
        return (torch.randint(97, 123, (n,), dtype=torch.uint8, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.full((1,), n, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))

    lones = {n: lone(n) for n in (1, cs.LONE_STEPS)}
    runs, lone_runs = {}, {}
    for name, path in libs.items():
        lib = load_pairs(path)
        for o in outs:
            o.fill_(-7)
        runs[name] = lambda lib=lib: [launch_pairs(lib, pmasks, plens, b, o)
                                      for b, o in zip(inputs, outs)]
        lone_runs[name] = {n: lambda lib=lib, x=x: launch_pairs(lib, pmasks, plens, x, lone_out)
                           for n, x in lones.items()}
        runs[name]()
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(outs), want), f"myers_pairs {name} differs from plain"
    times = timed_twice(cs, runs, ahead=PAIRS_AHEAD_CYCLES)
    n = len(inputs)
    for name, path in libs.items():
        ms = [x[0] / n for x in times[name]]
        prof_ms, prof_n = cs.per_launch_ms(cs.profiler_device_ms(runs[name], ("pairs_kernel",)),
                                           "pairs_kernel")
        lone_ms = {size: cs.profiled_ms(fn, "pairs_kernel", reps=20)[0]
                   for size, fn in lone_runs[name].items()}
        step_ms = cs.lone_step_ms(lone_ms[cs.LONE_STEPS], lone_ms[1], window_of(texts[name]))
        print(json.dumps({
            "kernel": "myers_pairs", "variant": name, "ms": ms, "ms_mean": sum(ms) / len(ms),
            "profiler_ms": prof_ms or None, "profiler_launches": prof_n,
            "lone_ms": lone_ms[cs.LONE_STEPS], "lone_1_byte_ms": lone_ms[1],
            "lone_step_ns": step_ms * 1e6, "equal_to_plain": True,
            "clock_sm": [c for x in times[name] for c in x[1:]], "launches": n,
            "pairs": work["pairs"], "pair_steps": work["steps"],
            "longest_steps_mean": sum(work["longest"]) / n, "card": card,
            "sass": pairs_sass(path) if name != "parent" else sass_of(
                path, step="LDG.E.U8", global_loads=True, function="pairs_kernel")}),
            flush=True)
    return 0


def window_of(text: str) -> int:
    """The steps a warp of an ``editdist.cu``'s ``myers_pairs`` runs at a
    time (``kWindow``); 1 for a design without windows, whose chains step
    their live bytes only."""
    m = re.search(r"constexpr int kWindow = (\d+);", text)
    return int(m.group(1)) if m else 1


def timed_twice(cs, runs: dict, ahead: int | None = None) -> dict[str, list]:
    """Each ``name -> fn`` timed by CUDA events over 5 calls queued behind
    a spin of the card (``chip_smoke.cuda_ms``, ``ahead`` clocks if given),
    in order and then in reverse, so that a drift of the card's speed over
    the call shows as a spread; ``name -> [(ms, clock before, clock
    after), ...]``."""
    times = {name: [] for name in runs}
    spin = {} if ahead is None else {"ahead": ahead}
    for name in [*runs, *reversed(runs)]:
        clock_before = cs.nvidia_smi("clocks.sm")
        ms = cs.cuda_ms(runs[name], 5, queued=True, **spin)
        times[name].append((ms, clock_before, cs.nvidia_smi("clocks.sm")))
    return times


def sass_of(path: Path, **kw) -> dict:
    from advanced_scrapper_tpu_torch.ops.sass import sass_step_counts

    try:
        return sass_step_counts(path, **kw)
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        return {"error": str(e)[:200]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="a checkout whose kernels to time beside")
    ap.add_argument("--pairs", action="store_true", help="the per-pair kernel myers_pairs only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("myers_probe runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs  # the chunk, the edge cases and the timers of the smoke run

    if args.pairs:
        card = cs.nvidia_smi("name,power.limit")
        print(json.dumps({"card": card}), flush=True)
        return pairs_main(args.parent, card)

    from advanced_scrapper_tpu_torch.ops import editdist_cuda, match_cuda
    from advanced_scrapper_tpu_torch.ops.editdist import myers_bound_plain
    from advanced_scrapper_tpu_torch.ops.match import screen_frac, screen_plain
    from advanced_scrapper_tpu_torch.pipeline.matcher import (
        EntityIndex,
        join_rows,
        process_json_data,
    )

    card = cs.nvidia_smi("name,power.limit")
    print(json.dumps({"card": card}), flush=True)
    libs = build_variants(args.parent)
    dev = torch.device("cuda")
    print(json.dumps({"phase": "match_kernel_vs_plain", **cs.check_match_vs_plain(dev)}),
          flush=True)

    rng = np.random.RandomState(17)
    entities = cs.sp500_entities(rng)
    records, _planted = cs.sp500_articles(rng, entities, cs.MATCH_ARTICLES)
    index = EntityIndex(process_json_data(entities))
    rows = [(r["article_text"], r["title"], None, r) for r in records]
    eligible, text, off, ln, tl, ttl, fl = join_rows(rows, 1 << 16, dev)
    screen, (masks, plens, ok, cols) = index.device_tables(dev)
    n_names = screen["kept"].numel()
    t = dict(text=text, off=off, len=ln, tl=tl, ttl=ttl, fl=fl, masks=masks, plens=plens,
             ok=ok, cols=cols, screen=screen, threshold=95.0, frac=screen_frac(95.0))
    base = (torch.rand((eligible.size, n_names), device=dev) < 0.05).to(torch.uint8)

    # the shipped bound against the plain version on the chunk's first rows
    few = 256
    sub = [x[:few].contiguous() for x in (off, ln, tl, fl)]
    got, want = base[:few].clone(), base[:few].clone()
    editdist_cuda.myers_bound(text, *sub, masks, plens, ok, cols, 95.0, got)
    myers_bound_plain(text, *sub, masks, plens, ok, cols, 95.0, want, rows_per_batch=256)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "myers_bound differs from plain on the chunk's first rows"
    # the shipped screen against the plain version on the whole chunk
    shipped_e = match_cuda.match_screen(text, off, ln, tl, ttl, screen, screen_frac(95.0))
    plain_e = screen_plain(text, off, ln, tl, ttl, screen, 95.0).to(torch.uint8)
    torch.cuda.synchronize()
    assert torch.equal(shipped_e, plain_e), "match_screen differs from plain on the chunk"

    shipped = base.clone()
    editdist_cuda.myers_bound(text, off, ln, tl, fl, masks, plens, ok, cols, 95.0, shipped)
    want_dist = torch.empty((eligible.size, plens.numel()), dtype=torch.int32, device=dev)
    launch(load(libs["editdist", "shipped"]), t, base.clone(), want_dist)
    torch.cuda.synchronize()
    runs, screen_out = {}, torch.empty_like(shipped_e)
    for (source, name), path in libs.items():
        if source == "editdist":
            lib = load(path)
            mask, dist = base.clone(), torch.empty_like(want_dist)
            launch(lib, t, mask, dist)
            torch.cuda.synchronize()
            equal = bool(torch.equal(mask, shipped)) and bool(torch.equal(dist, want_dist))
            runs[source, name] = lambda lib=lib: launch(lib, t, base, None)
        else:
            src = (parent_source(args.parent, source) if name == "parent"
                   else path.parent / f"{source}-{name}.cu")
            lib, csr = load_screen(path, src)
            out = torch.zeros_like(shipped_e)
            launch_screen(lib, csr, t, out)
            torch.cuda.synchronize()
            equal = bool(torch.equal(out, shipped_e)) or name in SCREEN_PHASE_CUTS
            runs[source, name] = lambda lib=lib, csr=csr: launch_screen(lib, csr, t, screen_out)
        assert equal, f"{source} variant {name} differs from the shipped kernel"
    times = timed_twice(cs, runs)
    windows = int(np.maximum(ln.cpu().numpy().astype(np.int64) - 2, 0).sum())
    probes = int(eligible.size) * int(screen["kept"].sum())
    for (source, name), path in libs.items():
        ms = [x[0] for x in times[source, name]]
        rec = {"source": source, "variant": name, "ms": ms, "ms_mean": sum(ms) / len(ms),
               "equal_to_shipped": name not in SCREEN_PHASE_CUTS,
               "clock_sm": [c for x in times[source, name] for c in x[1:]],
               "rows": int(eligible.size), "card": card}
        if source == "editdist":
            rec.update(patterns=int(plens.numel()), sass=sass_of(path))
        else:
            seen = cs.profiler_device_ms(runs[source, name], ("screen_kernel",))
            prof_ms, prof_n = cs.per_launch_ms(seen, "screen_kernel")
            rec.update(names=n_names, windows=windows, probes=probes,
                       profiler_ms=prof_ms or None, profiler_launches=prof_n)
            if name != "parent" and name not in SCREEN_PHASE_CUTS:
                rec["sass"] = screen_sass(path)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
