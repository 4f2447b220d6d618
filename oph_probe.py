"""Variants of the OPH fold kernel on the card: a design probe.

    python3 oph_probe.py [--parent DIR]
    python3 oph_probe.py --edges
    python3 oph_probe.py --path --parent DIR
    python3 oph_probe.py --checked [--parent DIR]

Builds copies of ``advanced_scrapper_tpu_torch/csrc/oph.cu`` with other
values of its walk's constants and other forms of its hash loop
(:data:`VARIANTS`: shingles a lane hashes at a time, ranges per resident
warp, the tile modes' pieces, the shared minimum filtered by a read of
the bin, fmix32's shifts as high multiplies), applied by text
substitution, and,
with ``--parent``, the ``oph.cu`` of another checkout (an earlier design,
e.g. the parent commit unpacked with ``git archive``), into
``build/kernels/probe/``, all at once, one nvcc each.  Every library
keeps the C interface that ``ops/oph_cuda.py`` calls.

Each one, except the phase cuts (:data:`CUTS`: the flush's global atomics
or the whole shared minimum left out, to show what each costs), is held
bit-equal to the plain versions on the edge cases of
``chip_smoke.check_oph_vs_plain`` and on the 65,536-article corpus of
``chip_smoke.py`` (7 resident chunks for ``oph_fold_segments``, the
reference chunker's 129 tiles for ``oph_fold`` and ``oph_sig``).  Then each
mode of each library is timed over the corpus by CUDA events, 5 passes
queued behind a ~100 ms spin of the card, in turns (the parent, the
shipped kernel, the variants, the cuts, then the same in reverse), the SM
clock read before and after each, and by the profiler (ms per recorded
launch times the launches of a pass).  One JSON line per (library, mode),
with its SASS instructions per shingle, by opcode and by pipe, and the
floor each pipe sets (``ops/sass.py:oph_sass``).

Where the toolkit has ``compute-sanitizer``, a last step reruns this
script with ``--edges`` (the edge cases alone, through the shipped
wrappers, PyTorch's caching allocator off so that each text ends its
allocation) under its memcheck, limited to the fold kernel, and prints
its verdict.

With ``--path`` it runs ``chip_smoke.oph_path`` (the OPH engine over the
65,536 articles, its checks, its kernels timed) of DIR and of this
checkout in turns, DIR, this, this, DIR, each turn a fresh process started
in its checkout's root with that checkout's ``chip_smoke.py`` and package,
and prints one JSON line a turn: articles/s and the chunk loop's pack and
dispatch seconds a chunk.

With ``--checked`` it builds ``oph.cu`` and ``minhash.cu`` with
``ASTT_CHECK_BOUNDS`` defined (:data:`CHECKED`: every unguarded word load
and byte load of the text tests its address against the text, or the
tile's rows, and traps outside), loads them in place of the shipped
libraries and runs, through the shipped wrappers, the edge cases of
``chip_smoke.check_oph_vs_plain``, ``check_kernels_vs_plain`` and
``check_segments_vs_plain``, then every OPH and MinHash fold mode over the
65,536-article corpus, each held to its plain version; a trap fails the
run.  A control build whose check fails on every unguarded load
(:data:`CONTROL`) must trap, in a process of its own.  With ``--parent``
the shipped sources' SASS (built without the macro) is compared with
DIR's.  Needs one card and ``nvcc``; run it from the repo's root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

LANE = "constexpr int kLaneShingles = 8;"
RANGES = "constexpr int kRangesPerWarp = 4;"
PIECE = "constexpr int kMinPiece = 256;"
TILE_FIT = "rows) * most / (fit > 0 ? fit : 1);"
BIN_MIN = "  atomicMin(table + (h >> shift), h);"
FMIX = """  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;"""
FMIX_MULHI = """  h ^= __umulhi(h, 1u << 16);
  h *= 0x85EBCA6Bu;
  h ^= __umulhi(h, 1u << 19);
  h *= 0xC2B2AE35u;
  h ^= __umulhi(h, 1u << 16);"""

#: oph.cu variants: name -> [(text in the source, its replacement)]; 4 and
#: 16 shingles a lane; 1, 8 and 16 ranges a resident warp (one wave, or
#: more waves that the block scheduler balances); tile pieces of at least
#: 1,024 and 2,048 shingles (fewer flushes, fewer warps on a small tile),
#: or planned for twice the resident warps; the shared atomic filtered by
#: a read of the bin (taken only when the hash is below it);
#: fmix32's right shifts as IMAD.HI on the FMA pipe instead of SHF on the
#: ALU pipe
VARIANTS = {
    "shipped": [],
    "lane4": [(LANE, "constexpr int kLaneShingles = 4;")],
    "lane16": [(LANE, "constexpr int kLaneShingles = 16;")],
    "ranges1": [(RANGES, "constexpr int kRangesPerWarp = 1;")],
    "ranges8": [(RANGES, "constexpr int kRangesPerWarp = 8;")],
    "ranges16": [(RANGES, "constexpr int kRangesPerWarp = 16;")],
    "piece1024": [(PIECE, "constexpr int kMinPiece = 1024;")],
    "piece2048": [(PIECE, "constexpr int kMinPiece = 2048;")],
    "tilefit2": [(TILE_FIT, "rows) * most / (fit > 0 ? 2 * fit : 1);")],
    "filter": [(BIN_MIN, "  uint32_t* slot = table + (h >> shift);\n"
                         "  if (h < *slot) atomicMin(slot, h);")],
    "mulhi": [(FMIX, FMIX_MULHI)],
}

#: oph.cu with one phase cut out, timed only (their outputs are not the
#: fold's): the flush's global atomics; the shared minimum (a compare that
#: keeps the hash live in its place)
CUTS = {
    "cut_flush": [("      atomicMin(row + j, v);\n", "")],
    "cut_min": [(BIN_MIN, "  if (h == 0u) *table = h;")],
}

#: the bounds-checked build (``--checked``): the macro defined ahead of the source
CHECKED = [("#include <cstdint>\n", "#define ASTT_CHECK_BOUNDS 1\n#include <cstdint>\n")]
#: the control: checked, and the unguarded word load's test made to fail
CONTROL = CHECKED + [("ASTT_CHECK(base + 4 * i >= lo && base + 4 * i + 4 <= hi);",
                      "ASTT_CHECK(base + 4 * i + 4 <= lo);")]

#: the three fold entry points and their unit type in the kernel's name
MODES = (("oph_fold_segments", "SegmentUnits"), ("oph_fold", "TileUnits"),
         ("oph_sig", "TileUnits"))
#: GPU clocks the card spins before a queued pass (~100 ms at 1980 MHz:
#: the host makes a tile pass's 129 launches meanwhile)
AHEAD_CYCLES = 200_000_000


class Kernels:
    """The fold entry points of one built ``oph.cu``, called as
    ``ops/oph_cuda.py``'s wrappers call them (the same C interface; the
    inputs are the ones the wrappers check in the smoke run)."""

    def __init__(self, path: Path):
        self.lib = lib = ctypes.CDLL(str(path))
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.astt_oph_sig.argtypes = [p, p, i, i, i, i, p, p]
        lib.astt_oph_fold.argtypes = [p, i, i, i, i, p, i, p]
        lib.astt_oph_fold_segments.argtypes = [p, i64, p, p, p, i64, i, i, p, i, p]
        for fn in (lib.astt_oph_sig, lib.astt_oph_fold, lib.astt_oph_fold_segments):
            fn.restype = i

    @staticmethod
    def _raise_on(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what} variant launch failed: CUDA error {err}")

    def oph_fold_segments(self, running, text, start, shingles, owner, k):
        dev = running.device
        start, shingles, owner = (t.to(dev, non_blocking=True) for t in (start, shingles, owner))
        self._raise_on(self.lib.astt_oph_fold_segments(
            text.data_ptr(), text.numel(), start.data_ptr(), shingles.data_ptr(),
            owner.data_ptr(), start.numel(), k, running.shape[1], running.data_ptr(),
            running.shape[0], torch.cuda.current_stream().cuda_stream), "oph_fold_segments")
        return running

    def oph_fold(self, running, packed, *, rows, width, k):
        self._raise_on(self.lib.astt_oph_fold(
            packed.data_ptr(), rows, width, k, running.shape[1], running.data_ptr(),
            running.shape[0], torch.cuda.current_stream().cuda_stream), "oph_fold")
        return running

    def oph_sig(self, tokens, lengths, bins, k):
        out = torch.full((tokens.shape[0], bins), -1, dtype=torch.int32, device=tokens.device)
        self._raise_on(self.lib.astt_oph_sig(
            tokens.data_ptr(), lengths.data_ptr(), tokens.shape[0], tokens.shape[1], k, bins,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream), "oph_sig")
        return out.view(torch.uint32)


def corpus_inputs(dev: torch.device) -> dict:
    """The 65,536 ragged articles of ``chip_smoke.py`` at the OPH engine's
    defaults: the resident chunks, the reference chunker's tiles (packed
    and unpacked), each mode's plain result, the shingles."""
    import chip_smoke as cs

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.ops import oph
    from advanced_scrapper_tpu_torch.ops.minhash import fold_segments_plain
    from advanced_scrapper_tpu_torch.ops.pack import pack_tile
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    docs, _planted = cs.ragged_corpus(np.random.RandomState(7), cs.MAIN_ARTICLES)
    eng = NearDupEngine(DedupConfig(backend="oph", rerank=False, exact_verify_band=0.0),
                        device=dev)
    params = eng.params
    n_bucket = 1 << max(len(docs) - 1, 0).bit_length()
    resident = [[x.to(dev) for x in c] for c in eng._host_chunks(docs)]
    raw_tiles = list(eng._host_tiles(docs))
    packed = [torch.from_numpy(pack_tile(t, l, o)).to(dev) for t, l, o in raw_tiles]
    tok = [(torch.from_numpy(t).to(dev), torch.from_numpy(l).to(dev)) for t, l, _o in raw_tiles]
    shapes = [t.shape for t, _l, _o in raw_tiles]
    fresh = lambda: torch.full((n_bucket, params.num_perm), -1, dtype=torch.int32,  # noqa: E731
                               device=dev).view(torch.uint32)
    want_seg, want_fold = fresh(), fresh()
    for text, st, ns, ow in resident:
        fold_segments_plain(want_seg, text, st, ns, ow, params,
                            signatures=oph.oph_raw_signatures_plain)
    for pk, (rows, w) in zip(packed, shapes):
        oph.oph_fused_tile_step_plain(want_fold, pk, rows=rows, width=w, params=params)
    want_sig = [oph.oph_raw_signatures_plain(t, l, params) for t, l in tok]
    lens = np.fromiter(map(len, docs), np.int64, count=len(docs))
    torch.cuda.synchronize()
    return dict(params=params, cfg=eng.cfg, fresh=fresh, resident=resident, packed=packed,
                tok=tok, shapes=shapes, want_seg=want_seg, want_fold=want_fold,
                want_sig=want_sig, shingles=int(np.maximum(lens - (params.shingle_k - 1), 0).sum()))


def mode_runs(kern: Kernels, c: dict) -> dict:
    """``mode -> (pass, equal)``: a pass of each mode over the corpus with
    ``kern``, and a check of a fresh pass against the plain result."""
    k, P = c["params"].shingle_k, c["params"].num_perm
    run_seg, run_fold = c["fresh"](), c["fresh"]()

    def seg_pass():
        for text, st, ns, ow in c["resident"]:
            kern.oph_fold_segments(run_seg, text, st, ns, ow, k)

    def fold_pass():
        for pk, (rows, w) in zip(c["packed"], c["shapes"]):
            kern.oph_fold(run_fold, pk, rows=rows, width=w, k=k)

    def sig_pass():
        return [kern.oph_sig(t, l, P, k) for t, l in c["tok"]]

    def same(x, y) -> bool:
        return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))

    def seg_equal():
        run_seg.fill_(-1)
        seg_pass()
        return same(run_seg, c["want_seg"])

    def fold_equal():
        run_fold.fill_(-1)
        fold_pass()
        return same(run_fold, c["want_fold"])

    def sig_equal():
        return all(same(x, y) for x, y in zip(sig_pass(), c["want_sig"]))

    return {"oph_fold_segments": (seg_pass, seg_equal), "oph_fold": (fold_pass, fold_equal),
            "oph_sig": (sig_pass, sig_equal)}


def sanitize(card: str) -> dict:
    """This script's ``--edges`` under ``compute-sanitizer``'s memcheck,
    limited to the fold kernel, where the toolkit has it."""
    from advanced_scrapper_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "compute-sanitizer"
    if not tool.exists():
        return {"sanitizer": "absent", "card": card}
    cmd = [str(tool), "--tool", "memcheck", "--error-exitcode", "3",
           "--kernel-name", "kns=oph_fold_kernel", sys.executable, os.path.abspath(__file__),
           "--edges"]
    env = {**os.environ, "PYTORCH_NO_CUDA_MEMORY_CACHING": "1"}
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=420, env=env)
    except subprocess.TimeoutExpired as e:
        return {"sanitizer": "memcheck", "rc": None, "timeout_s": e.timeout, "card": card}
    out = proc.stdout + proc.stderr
    return {"sanitizer": "memcheck", "rc": proc.returncode, "head": out[:1500],
            "tail": out[-1500:], "card": card}


def sass_of(lib: Path) -> list:
    from advanced_scrapper_tpu_torch.ops import sass

    return sass.parse_sass(sass.dump_sass(lib))


def minhash_corpus_equal(dev: torch.device, c: dict) -> dict:
    """Each MinHash fold mode over the corpus, through the shipped wrappers,
    against its plain version: the segment fold on the resident chunks,
    ``minhash_fold`` on the packed tiles, ``minhash_sig`` on the tiles."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.ops import minhash_cuda
    from advanced_scrapper_tpu_torch.ops.minhash import (
        fold_segments_plain,
        fused_tile_step_plain,
        make_fused_tile_step,
        minhash_signatures,
        minhash_signatures_plain,
        perm_tensors,
    )

    params = make_params()
    a, b = perm_tensors(params, dev)
    k = params.shingle_k

    def same(x, y) -> bool:
        return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))

    run, want = c["fresh"](), c["fresh"]()
    for text, st, ns, ow in c["resident"]:
        minhash_cuda.minhash_fold_segments(run, text, st, ns, ow, a, b, k)
        fold_segments_plain(want, text, st, ns, ow, params)
    out = {"minhash_fold_segments": same(run, want)}
    step = make_fused_tile_step(params, "scan", dev)
    run, want = c["fresh"](), c["fresh"]()
    for pk, (rows, w) in zip(c["packed"], c["shapes"]):
        step(run, pk, rows=rows, width=w)
        fused_tile_step_plain(want, pk, rows=rows, width=w, params=params)
    out["minhash_fold"] = same(run, want)
    out["minhash_sig"] = all(same(minhash_signatures(t, l, params),
                                  minhash_signatures_plain(t, l, params)) for t, l in c["tok"])
    torch.cuda.synchronize()
    return out


def checked_control(lib: str) -> int:
    """``--checked-control LIB``: one OPH segment fold with the control
    build; prints whether the card reported the trap."""
    dev = torch.device("cuda")
    kern = Kernels(Path(lib))
    text = torch.randint(32, 127, (4096,), dtype=torch.uint8, device=dev)
    start = torch.zeros((1,), dtype=torch.int64)
    shingles = torch.full((1,), 2048, dtype=torch.int32)
    owner = torch.zeros((1,), dtype=torch.int32)
    running = torch.full((1, 128), -1, dtype=torch.int32, device=dev).view(torch.uint32)
    try:
        kern.oph_fold_segments(running, text, start, shingles, owner, 5)
        torch.cuda.synchronize()
    except RuntimeError as e:  # the launch's or the sync's CUDA error
        print(json.dumps({"trapped": True, "error": str(e)[:300]}), flush=True)
        return 0
    print(json.dumps({"trapped": False}), flush=True)
    return 1


def checked(parent: Path | None, card: str) -> int:
    """``--checked``: see the module's docstring."""
    import chip_smoke as cs
    import myers_probe as mp

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.ops import _build

    t0 = time.perf_counter()
    builds = {"oph": {"shipped": [], "checked": CHECKED, "control": CONTROL},
              "minhash": {"shipped": [], "checked": CHECKED}}
    libs = mp.build_variants(parent, builds)
    report: dict = {"card": card, "build_seconds": time.perf_counter() - t0}
    for source in builds:
        shipped = sass_of(libs[source, "shipped"])
        guarded = sass_of(libs[source, "checked"])
        report[f"{source}_traps"] = {
            "shipped": sum(op.startswith("BPT.TRAP") for _a, op, _o in shipped),
            "checked": sum(op.startswith("BPT.TRAP") for _a, op, _o in guarded)}
        if parent is not None:
            report[f"{source}_sass_equal_to_parent"] = shipped == sass_of(libs[source, "parent"])
    # the shipped wrappers load the checked libraries from here on
    for source in builds:
        _build._loaded[source] = ctypes.CDLL(str(libs[source, "checked"]))
    dev = torch.device("cuda")
    cfg = DedupConfig(backend="oph", rerank=False, exact_verify_band=0.0)
    params = make_params()
    t0 = time.perf_counter()
    report["oph_edges"] = cs.check_oph_vs_plain(params, cfg, dev)
    report["minhash_tile_edges"] = cs.check_kernels_vs_plain(params, cfg, dev)
    report["minhash_segment_edges"] = cs.check_segments_vs_plain(params, dev)
    torch.cuda.synchronize()
    report["edges_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = corpus_inputs(dev)
    kern = Kernels(libs["oph", "checked"])
    report["oph_corpus_equal"] = {mode: fn() for mode, (_p, fn) in mode_runs(kern, c).items()}
    report["minhash_corpus_equal"] = minhash_corpus_equal(dev, c)
    torch.cuda.synchronize()
    report["corpus_seconds"] = time.perf_counter() - t0
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--checked-control",
                           str(libs["oph", "control"])], capture_output=True, text=True,
                          timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    report["control"] = {"rc": proc.returncode, **(json.loads(lines[-1]) if lines else {})}
    ok = (all(report["oph_corpus_equal"].values())
          and all(report["minhash_corpus_equal"].values())
          and report["control"].get("trapped") is True
          and report["oph_traps"]["checked"] > 0 and report["oph_traps"]["shipped"] == 0
          and all(report.get(f"{s}_sass_equal_to_parent", True) for s in builds))
    report["ok"] = ok
    print(json.dumps({"phase": "checked", **report}), flush=True)
    return 0 if ok else 1


def path_turn() -> int:
    """One ``--path`` turn: ``chip_smoke.oph_path`` of the checkout in
    the current directory, as ``chip_smoke.py`` runs it."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    docs, planted = cs.ragged_corpus(np.random.RandomState(7), cs.MAIN_ARTICLES)
    warm, _ = cs.ragged_corpus(np.random.RandomState(8), cs.WARM_ARTICLES)
    cs.oph_path(docs, planted, warm, card, clock_mhz, dev)
    return 0


def path_turns(parent: Path) -> int:
    """``--path``: see the module's docstring."""
    here = Path(__file__).resolve().parent
    for name, tree in (("parent", parent), ("change", here), ("change", here),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, str(here / "oph_probe.py"), "--path-turn"],
                              cwd=tree, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout[-2000:] + proc.stderr[-2000:], file=sys.stderr)
            return 1
        row = next(json.loads(ln) for ln in proc.stdout.splitlines()
                   if ln.startswith('{"phase": "oph_path"'))
        stages = row["staged_lag"]["stages"]
        print(json.dumps({"tree": name, "articles_per_s": row["articles_per_s"],
                          "pack_s": stages["pack"]["mean_s"],
                          "dispatch_s": stages["dispatch"]["mean_s"], "chunks": row["chunks"],
                          "launches": row["launches"], "card": row["card"]}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="a checkout whose oph.cu to time beside")
    ap.add_argument("--edges", action="store_true",
                    help="only the edge cases, through the shipped wrappers")
    ap.add_argument("--path", action="store_true",
                    help="chip_smoke.oph_path of DIR and of this checkout in turns")
    ap.add_argument("--path-turn", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--checked", action="store_true",
                    help="the bounds-checked builds over the edge cases and the corpus")
    ap.add_argument("--checked-control", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("oph_probe runs on the card", file=sys.stderr)
        return 2
    if args.path_turn:
        return path_turn()
    if args.checked_control:
        return checked_control(args.checked_control)
    if args.checked:
        import chip_smoke as cs

        return checked(args.parent.resolve() if args.parent else None,
                       cs.nvidia_smi("name,power.limit"))
    if args.path:
        if args.parent is None:
            ap.error("--path needs --parent DIR")
        return path_turns(args.parent.resolve())
    import chip_smoke as cs  # the corpus, the edge cases and the timers of the smoke run
    import myers_probe as mp  # the variant builder and the timer in turns

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(json.dumps({"card": card}), flush=True)
    cfg = DedupConfig(backend="oph", rerank=False, exact_verify_band=0.0)
    params = NearDupEngine(cfg, device="cpu").params
    if args.edges:
        print(json.dumps({"phase": "oph_vs_plain", **cs.check_oph_vs_plain(params, cfg, dev)}),
              flush=True)
        return 0

    libs = mp.build_variants(args.parent, {"oph": {**VARIANTS, **CUTS}})
    order = sorted(libs, key=lambda key: (key[1] != "parent", key[1] in CUTS))
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    c = corpus_inputs(dev)
    runs, equal = {}, {}
    for key in order:
        name = key[1]
        kern = Kernels(libs[key])
        modes = mode_runs(kern, c)
        if name not in CUTS:
            edges = cs.check_oph_vs_plain(c["params"], cfg, dev, kernels=kern)
            equal[name] = {mode: fn() for mode, (_p, fn) in modes.items()}
            assert all(equal[name].values()), f"oph.cu {name} differs from plain: {equal[name]}"
            print(json.dumps({"variant": name, "edge_cases": edges, "corpus_equal": equal[name]}),
                  flush=True)
        for mode, (fn, _eq) in modes.items():
            fn()
            runs[name, mode] = fn
    torch.cuda.synchronize()
    times = mp.timed_twice(cs, runs, ahead=AHEAD_CYCLES)
    launches = {"oph_fold_segments": len(c["resident"]), "oph_fold": len(c["packed"]),
                "oph_sig": len(c["tok"])}
    for key in order:
        name = key[1]
        sass = {units: cs.oph_fold_sass(c["shingles"], clock_mhz, units, lib=libs[key])
                for units in ("SegmentUnits", "TileUnits")}
        for mode, units in MODES:
            ms = [x[0] for x in times[name, mode]]
            seen = cs.profiler_device_ms(runs[name, mode], ("oph_fold_kernel",))
            hit = {kk: v for kk, v in seen.items() if "oph_fold_kernel" in kk and units in kk}
            n = sum(v[1] for v in hit.values())
            prof_ms = sum(v[0] for v in hit.values()) / n * launches[mode] if n else None
            print(json.dumps({
                "kernel": mode, "variant": name, "ms": ms, "ms_mean": sum(ms) / len(ms),
                "profiler_ms": prof_ms, "profiler_launches": n, "launches": launches[mode],
                "equal_to_plain": name not in CUTS, "clock_sm": [x for t in times[name, mode]
                                                                for x in t[1:]],
                "shingles": c["shingles"], "clock_max_sm_mhz": clock_mhz,
                "sass": sass[units], "card": card}), flush=True)
    print(json.dumps(sanitize(card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
