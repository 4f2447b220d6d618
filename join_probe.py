"""The ring join and the exact hash on the card: the shipped designs beside the parent's.

    python3 join_probe.py [--parent DIR]

Builds ``advanced_scrapper_tpu_torch/csrc/ring.cu`` and ``exact.cu`` as
shipped, copies of both with other forms of their launches and tiles
(:data:`VARIANTS`: the ring join's phases in one cooperative launch, which
the shipped source dropped and :data:`COOPERATIVE` carries as source text,
or in two plain launches, tiles of 512 local positions, no guessed window
(each tile's bounds bracketed), the bounds searched to the exact position,
blocks of 128 threads; the exact hash in blocks of 128 threads, or two
blocks an SM), a cut (:data:`CUTS`: the ring join's gathers at hits left
out, timed only), and, with ``--parent``, the ``ring.cu`` and ``exact.cu``
of another checkout (the parent commit unpacked with ``git archive``; a
ring join without ``astt_ring_join_launches`` reads the local keys and
takes no presort or table), into ``build/kernels/probe/``, all at once,
one nvcc each.

Each build is held bit-equal to the plain versions: ``ring_join`` to
``parallel.ring.join_plain`` on ``chip_smoke.ring_path``'s 64 (hop, shard)
inputs (the 65,536 ragged articles of seed 7 as 1,024-byte rows on 8
shards), ``exact_hash`` to ``ops.exact.exact_hash_plain`` on the grouping
tier's 262,144 urls (``chip_smoke.exact_urls(2)`` through ``doc_inputs``)
and on ``chip_smoke.exact_cases``.  Then each (build, kernel) is timed by
CUDA events, calls queued behind a spin of the card, in turns (the parent,
the shipped build, the variants, then the same in reverse:
``myers_probe.timed_twice``), and by ``torch.profiler`` kernel by kernel.
One JSON line a (build, kernel), with its bound (``chip_smoke.ring_join_work``,
``chip_smoke.exact_bound``) and the card's name and power limit.  Run it
as a process of its own: late in a long process the profiler may record
no device event.  Needs one card and ``nvcc``; run it from the repo's root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

ITEMS = "constexpr int kItems = 1;"
GUARD = "constexpr int kGuard = 256;"
SLACK = "constexpr int kSlack = 64;"
THREADS = "constexpr int kThreads = 256;"

#: the ring join's phases in one cooperative launch, a grid sync between them
#: (the shipped source dropped this form): both phases in the rows' kernel
COOPERATIVE = [
    ("#include <cuda_runtime.h>", "#include <cooperative_groups.h>\n#include <cuda_runtime.h>"),
    ('  asm volatile("griddepcontrol.wait;" ::: "memory");',
     "  cooperative_groups::this_grid().sync();"),
    ("ring_rows_kernel(JoinArgs a) {\n  rows_phase<kVec, kGroup>(a);",
     "ring_rows_kernel(JoinArgs a) {\n  __shared__ int64_t span[kSpanMax];\n"
     "  __shared__ int red[kWarps + 2];\n  tiles_phase(a, span, red);\n"
     "  rows_phase<kVec, kGroup>(a);"),
    ("""  const int tiles = (a.Bl + kTile - 1) / kTile;
  ring_tiles_kernel<<<tiles * a.nb, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.Bl + kThreads / kGroup - 1) / (kThreads / kGroup));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ring_rows_kernel<kVec, kGroup>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();""",
     """  const int tiles = (a.Bl + kTile - 1) / kTile;
  const int tile_blocks = tiles * a.nb;
  const int row_blocks = (a.Bl + kThreads / kGroup - 1) / (kThreads / kGroup);
  auto* kernel = ring_rows_kernel<kVec, kGroup>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int want = tile_blocks > row_blocks ? tile_blocks : row_blocks;
  const int fit = per_sm * sms;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(want < fit ? want : fit),
                                     dim3(kThreads), args, 0, s);"""),
    ("int astt_ring_join_launches() { return 2; }", "int astt_ring_join_launches() { return 1; }"),
]

#: source -> variant -> its edits (``myers_probe.patched``)
VARIANTS = {
    "ring": {
        "shipped": [],
        "cooperative": COOPERATIVE,
        "two_launches": [("programmaticStreamSerializationAllowed = 1;",
                          "programmaticStreamSerializationAllowed = 0;")],
        "items2": [(ITEMS, "constexpr int kItems = 2;")],
        "no_guess": [(GUARD, "constexpr int kGuard = 1 << 30;")],
        "exact_bounds": [(SLACK, "constexpr int kSlack = 0;"),
                         (GUARD, "constexpr int kGuard = 1 << 30;")],
        "threads128": [(THREADS, "constexpr int kThreads = 128;"),
                       (GUARD, "constexpr int kGuard = 128;")],
    },
    "exact": {
        "shipped": [],
        "threads128": [(THREADS, "constexpr int kThreads = 128;")],
        "blocks2": [("std::max(per_sm, 1);", "std::min(std::max(per_sm, 1), 2);")],
    },
}

#: source -> cut -> its edits: a step left out, timed only (the results are wrong), to show
#: what the step costs
CUTS = {
    "ring": {"cut_gathers": [
        ("    crow[i] = hit ? __ldg(a.perm + ti) : -1;",
         "    crow[i] = hit ? static_cast<int32_t>(ti) : -1;"),
        ("    cg[i] = crow[i] >= 0 && crow[i] < a.Bt ? __ldg(a.gidx_eff + crow[i]) : kBig;",
         "    cg[i] = crow[i] >= 0 ? crow[i] : kBig;")]},
}

#: GPU clocks the card spins before a queued timing (~10 ms at 1980 MHz)
AHEAD_CYCLES = 20_000_000
#: the kernels' names in the profiler
KERNELS = {"ring": "ring_", "exact": "exact_hash_kernel"}
#: the ring join's kernels: this design's two phases and the parent's one kernel
RING_KERNELS = ("ring_tiles_kernel", "ring_rows_kernel", "ring_join_kernel")


class RingLib:
    """``astt_ring_join`` of one built ``ring.cu``, called as
    ``ops/ring_cuda.py`` calls it; a library without
    ``astt_ring_join_launches`` has the parent's interface (the local keys,
    one launch, no presort or table)."""

    def __init__(self, path: Path):
        self.lib = lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.parent = not hasattr(lib, "astt_ring_join_launches")
        if self.parent:
            lib.astt_ring_join.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, p, p]
            self.launches = 1
        else:
            lib.astt_ring_join.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, p, p, p]
            lib.astt_ring_join_launches.restype = i
            self.launches = lib.astt_ring_join_launches()
        lib.astt_ring_join.restype = i

    def join(self, args: tuple, own: dict, rep: torch.Tensor, threshold: float,
             bits: int) -> torch.Tensor:
        keys_l, sig_l, gidx_l, sk, perm, geff, sig_b = args
        (Bl, nb), P, Bt = keys_l.shape, sig_l.shape[1], sk.shape[1]
        thr = float(np.float32(threshold))
        stream = torch.cuda.current_stream().cuda_stream
        if self.parent:
            err = self.lib.astt_ring_join(
                keys_l.data_ptr(), sig_l.data_ptr(), gidx_l.data_ptr(), sk.data_ptr(),
                perm.data_ptr(), geff.data_ptr(), sig_b.data_ptr(), Bl, Bt, nb, P, bits, thr,
                rep.data_ptr(), stream)
        else:
            table = torch.empty((Bl, nb, 2), dtype=torch.int32, device=keys_l.device)
            err = self.lib.astt_ring_join(
                sig_l.data_ptr(), gidx_l.data_ptr(), own["sorted_l"].data_ptr(),
                own["order_l"].data_ptr(), sk.data_ptr(), perm.data_ptr(), geff.data_ptr(),
                sig_b.data_ptr(), Bl, Bt, nb, P, bits, thr, table.data_ptr(), rep.data_ptr(),
                stream)
        if err:
            raise RuntimeError(f"ring_join variant launch failed: CUDA error {err}")
        return rep


class ExactLib:
    """``astt_exact_hash`` of one built ``exact.cu`` (the parent's has the
    same interface), called as ``ops/exact_cuda.py`` calls it."""

    launches = 1

    def __init__(self, path: Path):
        self.lib = lib = ctypes.CDLL(str(path))
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.astt_exact_hash.argtypes = [p, ll, p, p, p, p, ll, ll, ctypes.c_int, p, p]
        lib.astt_exact_hash.restype = ctypes.c_int

    def hash(self, text, starts, span, mixlen, coef, max_span: int) -> torch.Tensor:
        n = starts.shape[0]
        out = torch.empty((n, 4), dtype=torch.int32, device=text.device)
        if n:
            err = self.lib.astt_exact_hash(
                text.data_ptr(), text.numel(), starts.data_ptr(), span.data_ptr(),
                mixlen.data_ptr(), coef.data_ptr(), coef.shape[0], max_span, n, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"exact_hash variant launch failed: CUDA error {err}")
        return out


def ring_inputs(dev: torch.device) -> dict:
    """``chip_smoke.ring_path``'s 64 (hop, shard) joins: their arguments,
    each shard's own presort, and each join's plain result on a fresh
    ``rep``; the row bits, the threshold and the bound's count."""
    import chip_smoke as cs

    from advanced_scrapper_tpu_torch.core.tokenizer import encode_batch
    from advanced_scrapper_tpu_torch.ops.lsh import row_bits
    from advanced_scrapper_tpu_torch.parallel import ring

    docs, _planted = cs.ragged_corpus(np.random.RandomState(7), cs.MAIN_ARTICLES)
    tok, lens = encode_batch(docs[:cs.RING_ARTICLES], block_len=cs.RING_BLOCK)
    shards = cs.ring_shards(tok, lens, dev)
    n = len(shards)
    bits = row_bits(cs.RING_ARTICLES // n)
    joins = []
    for h in range(n):
        for s in range(n):
            args = cs.ring_join_args(shards, s, h)
            want = ring.join_plain(*args, args[2].clone(), cs.RING_THRESHOLD, bits)
            joins.append((args, cs.ring_own(shards, s), want))
    work = [cs.ring_join_work(a, cs.RING_THRESHOLD, bits) for a, _o, _w in joins]
    return {"joins": joins, "bits": bits, "threshold": cs.RING_THRESHOLD, "work": work,
            "scratch": [sh["gidx"].clone() for sh in shards]}


def exact_inputs(dev: torch.device) -> dict:
    """The grouping tier's 262,144 urls as ``doc_inputs`` lays them out,
    and ``chip_smoke.exact_cases``, each with its plain result."""
    import chip_smoke as cs

    from advanced_scrapper_tpu_torch.core.tokenizer import to_bytes
    from advanced_scrapper_tpu_torch.ops.exact import ExactHasher, exact_hash_plain

    hasher = ExactHasher(device=dev)
    raw = [to_bytes(u) for u in cs.exact_urls(2)]
    cases = {"tier": hasher.doc_inputs(raw), **cs.exact_cases(hasher, dev)}
    plain = {name: exact_hash_plain(*c[:5]) for name, c in cases.items()}
    return {"cases": cases, "plain": plain, "documents": len(raw)}


def equal_to_plain(kind: str, lib, c: dict) -> dict[str, bool]:
    if kind == "ring":
        return {"joins": all(
            torch.equal(lib.join(args, own, args[2].clone(), c["threshold"], c["bits"]), want)
            for args, own, want in c["joins"])}
    return {name: torch.equal(lib.hash(*case), c["plain"][name])
            for name, case in c["cases"].items()}


def run_of(kind: str, lib, c: dict):
    """One timed call: the 64 joins of a ring step, or the tier's urls."""
    if kind == "ring":
        def fn():
            for i, (args, own, _w) in enumerate(c["joins"]):
                lib.join(args, own, c["scratch"][i % len(c["scratch"])], c["threshold"],
                         c["bits"])
        return fn
    tier = c["cases"]["tier"]
    return lambda: lib.hash(*tier)


def bounds(c_ring: dict, c_exact: dict, clock_mhz: float) -> dict:
    import chip_smoke as cs

    moved = sum(w["bytes"] for w in c_ring["work"]) / len(c_ring["work"])
    ops = sum(w["ops"] for w in c_ring["work"]) / len(c_ring["work"])
    ops_ms, bytes_ms = cs.bound_ms(ops, moved, clock_mhz)
    text, *_rest, longest = c_exact["cases"]["tier"]
    return {"ring": {"bound_ms": max(ops_ms, bytes_ms), "bound_by": cs.bound_by(ops_ms, bytes_ms),
                     "bytes": moved, "ops": ops},
            "exact": cs.exact_bound(c_exact["documents"], text.numel(), longest, clock_mhz)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="a checkout whose ring.cu and exact.cu to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("join_probe runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs  # the inputs, bounds and timers of the smoke run
    import myers_probe as mp  # the variant builder and the timer in turns

    from advanced_scrapper_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(json.dumps({"card": card}), flush=True)
    for name in ("minhash", "lsh"):  # the inputs' signatures and presorts
        _build.build(name)
    libs = mp.build_variants(args.parent, {k: {**v, **CUTS.get(k, {})}
                                           for k, v in VARIANTS.items()})
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    inputs = {"ring": ring_inputs(dev), "exact": exact_inputs(dev)}
    per_call = {"ring": len(inputs["ring"]["joins"]), "exact": 1}
    bound = bounds(inputs["ring"], inputs["exact"], clock_mhz)
    order = sorted(libs, key=lambda key: (key[1] != "parent", key[1] != "shipped", key))
    loaded, runs = {}, {}
    for key in order:
        kind, name = key
        lib = (RingLib if kind == "ring" else ExactLib)(libs[key])
        if name not in CUTS.get(kind, {}):
            eq = equal_to_plain(kind, lib, inputs[kind])
            assert all(eq.values()), f"{kind} {name} differs from plain: {eq}"
            print(json.dumps({"source": kind, "variant": name, "equal_to_plain": eq}), flush=True)
        loaded[key] = lib
        runs[key] = run_of(kind, lib, inputs[kind])
        runs[key]()
    torch.cuda.synchronize()
    times = mp.timed_twice(cs, runs, ahead=AHEAD_CYCLES)
    for key, t in times.items():
        kind, name = key
        lib = loaded[key]
        seen = cs.profiler_device_ms(runs[key], (KERNELS[kind],))
        if kind == "ring":
            per = {k: cs.per_launch_ms(seen, k) for k in RING_KERNELS}
            phases = {k: ms for k, (ms, n) in per.items() if n}
            recorded = {k: n for k, (_ms, n) in per.items() if n}
            assert phases, f"the profiler saw no ring join kernel, only {sorted(seen)}"
        else:
            per_launch, recorded = cs.per_launch_ms(seen, KERNELS[kind])
            phases = {KERNELS[kind]: per_launch}
        ms = [x[0] / per_call[kind] for x in t]
        mean = sum(ms) / len(ms)
        profiler_ms = sum(phases.values())
        b = bound[kind]
        print(json.dumps({
            "kernel": kind, "variant": name, "launches_a_call": lib.launches,
            "equal_to_plain": name not in CUTS.get(kind, {}),
            "queued_ms": ms, "queued_ms_mean": mean, "profiler_ms": profiler_ms,
            "profiler_phase_ms": phases,
            "profiler_launches_recorded": recorded, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "bytes": b["bytes"], "ops": b["ops"],
            "share_of_bound": b["bound_ms"] / profiler_ms if profiler_ms else None,
            "clock_sm": [x for y in t for x in y[1:]], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
