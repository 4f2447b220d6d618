"""Where the MinHash kernel's time goes, on the card: a tuning probe.

    python -m advanced_scrapper_tpu_torch.ops.minhash_probe

Builds variants of ``csrc/minhash.cu`` (the source with one piece swapped
by text substitution) into ``build/kernels/probe/``, runs each through the
``minhash_fold_segments`` wrapper over 65,536 ragged articles (the corpus of
``chip_smoke.py``) as one launch, and prints each variant's kernel time from
``torch.profiler`` beside the shipped source's.  Variants that change the
result are timing probes only: they say what a part of the kernel costs,
not a design.  Then it times two loops of 32-bit integer instructions to
read the card's ``IMAD`` and ``VIMNMX`` issue rates.  One JSON line per
measurement; needs one card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops import _build, minhash_cuda

LOOP = """          const uint32_t lo = umin32(ap[q] * h.x + bp[q], ap[q] * h.y + bp[q]);
          const uint32_t hi = umin32(ap[q] * h.z + bp[q], ap[q] * h.w + bp[q]);
          m[q] = umin32(m[q], umin32(lo, hi));"""
HASH = "slot[32 * t + lane] = shingle_hash<kK>(stage + shift + i, k);"
GROUP_LOAD = """      for (int g = 0; g < groups; ++g) {
        const uint4 h = h4[g];"""

#: name -> [(text in the source, its replacement)], and whether the result
#: stays exact
VARIANTS = {
    "shipped": ([], True),
    "8_blocks_per_sm": ([("kMinBlocks = 6", "kMinBlocks = 8")], True),
    "round_128": ([("kRound = 64", "kRound = 128")], True),
    "no_hash": ([(HASH, "slot[32 * t + lane] = static_cast<uint32_t>(i) * 0x9E3779B1u;")], False),
    "no_group_load": ([(GROUP_LOAD, """      uint4 h = h4[0];
      for (int g = 0; g < groups; ++g) {
        h = make_uint4(h.y, h.z, h.w, h.x ^ g);""")], False),
    "no_hash_no_group_load": ([
        (HASH, "slot[32 * t + lane] = static_cast<uint32_t>(i) * 0x9E3779B1u;"),
        (GROUP_LOAD, """      uint4 h = h4[0];
      for (int g = 0; g < groups; ++g) {
        h = make_uint4(h.y, h.z, h.w, h.x ^ g);"""),
    ], False),
    "xor_for_min": ([(LOOP, LOOP.replace("umin32(", "(0u ^ ").replace(", ", " ^ "))], False),
    "b_constant": ([(LOOP, LOOP.replace("bp[q]", "(0x9E3779B9u + q)"))], False),
    # eight permutations per lane: each half-warp takes half of every round
    "8_perms_per_lane": ([
        ("kLanePerms = kPerm / 32;", "kLanePerms = kPerm / 16;"),
        ("kMinBlocks = 6;", "kMinBlocks = 4;"),
        ("ap[q] = a[lane + 32 * q];", "ap[q] = a[(lane & 15) + 16 * q];"),
        ("bp[q] = b[lane + 32 * q];", "bp[q] = b[(lane & 15) + 16 * q];"),
        ("""      const uint4* h4 = reinterpret_cast<const uint4*>(slot);
      const int groups = (nr + 3) >> 2;""",
         """      const uint4* h4 = reinterpret_cast<const uint4*>(slot) + (lane >> 4) * (kRound / 8);
      const int groups = (min(nr, kRound / 2) + 3) >> 2;"""),
        ("""    uint32_t* row = out + static_cast<size_t>(x.owner) * kPerm + lane;
#pragma unroll
    for (int q = 0; q < kLanePerms; ++q) atomicMin(row + 32 * q, m[q]);""",
         """#pragma unroll
    for (int q = 0; q < kLanePerms; ++q)
      m[q] = umin32(m[q], __shfl_xor_sync(0xFFFFFFFFu, m[q], 16));
    uint32_t* row = out + static_cast<size_t>(x.owner) * kPerm + (lane & 15) + (lane >> 4) * 64;
#pragma unroll
    for (int q = 0; q < kLanePerms / 2; ++q)
      atomicMin(row + 16 * q, lane < 16 ? m[q] : m[q + 4]);"""),
    ], True),
}

PIPES = r"""
#include <cstdint>
__device__ __forceinline__ uint32_t umin(uint32_t x, uint32_t y) { return y < x ? y : x; }
extern "C" __global__ void k_imad(uint32_t* out, uint32_t a, uint32_t b, int iters) {
  uint32_t r[16];
  for (int j = 0; j < 16; ++j) r[j] = threadIdx.x + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) r[j] = r[j] * a + b;
  }
  uint32_t s = 0;
  for (int j = 0; j < 16; ++j) s ^= r[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" __global__ void k_min(uint32_t* out, uint32_t a, uint32_t b, int iters) {
  uint32_t r[16];
  for (int j = 0; j < 16; ++j) r[j] = (threadIdx.x + j) * a;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) r[j] = umin(r[(j + 1) & 15], r[(j + 5) & 15]);
  }
  uint32_t s = 0;
  for (int j = 0; j < 16; ++j) s ^= r[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""


def _variant_source(edits) -> str:
    src = (_build.CSRC_DIR / "minhash.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant text not found in minhash.cu: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _compile(sources: dict[str, str], outdir: Path, flags) -> None:
    """Compile every source at once, one nvcc each."""
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, out) in sources.items():
        (outdir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *flags, "-o", str(outdir / out),
             str(outdir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")


def _pipe_rates(cubin: Path, clock_mhz: float, sms: int) -> None:
    """Warp-instructions per clock per SM of the two loops in ``PIPES``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    torch.zeros(1, device="cuda")  # a current context
    mod, fn = ctypes.c_void_p(), ctypes.c_void_p()
    if cuda.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()):
        raise RuntimeError("cuModuleLoad failed")
    grid, block, iters = sms * 8, 256, 20000
    out = torch.empty(grid * block, dtype=torch.int32, device="cuda")
    args = [ctypes.c_void_p(out.data_ptr()), ctypes.c_uint32(0x9E3779B1),
            ctypes.c_uint32(12345), ctypes.c_int(iters)]
    params = (ctypes.c_void_p * 4)(*[ctypes.cast(ctypes.byref(x), ctypes.c_void_p) for x in args])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for name in ("k_imad", "k_min"):
        if cuda.cuModuleGetFunction(ctypes.byref(fn), mod, name.encode()):
            raise RuntimeError(f"no {name} in the cubin")
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(2):  # the second launch is timed
            start.record()
            if cuda.cuLaunchKernel(fn, grid, 1, 1, block, 1, 1, 0, stream, params, None):
                raise RuntimeError(f"{name} launch failed")
            stop.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        warp_instr = grid * block // 32 * iters * 16
        print(json.dumps({"loop": name, "ms": ms, "warp_instr_per_clk_per_sm":
                          warp_instr / (ms * 1e-3 * clock_mhz * 1e6 * sms)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("minhash_probe runs on the card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as cs  # the corpus and the timers of the smoke run

    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.cpu.hostbatch import segment_ranges
    from advanced_scrapper_tpu_torch.ops.minhash import SEGMENT_SHINGLES, perm_tensors

    card = cs.nvidia_smi("name,power.limit")
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    outdir = _build.BUILD_DIR / "probe"
    sources = {n: (_variant_source(e), f"lib{n}.so") for n, (e, _exact) in VARIANTS.items()}
    sources["pipes"] = (PIPES, "pipes.cubin")
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    _compile({n: v for n, v in sources.items() if n != "pipes"}, outdir, _build.NVCC_FLAGS)
    _compile({"pipes": sources["pipes"]}, outdir, [*flags, "-cubin"])

    params = make_params()
    k, dev = params.shingle_k, torch.device("cuda")
    docs, _ = cs.ragged_corpus(np.random.RandomState(7), cs.MAIN_ARTICLES)
    lens = np.fromiter(map(len, docs), np.int64, count=len(docs))
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    text = torch.frombuffer(bytearray(b"".join(docs)), dtype=torch.uint8).to(dev)
    seg = [torch.from_numpy(x).to(dev) for x in segment_ranges(
        off, lens, np.arange(len(docs)), k, SEGMENT_SHINGLES)]
    a, b = perm_tensors(params, dev)
    want = None
    for name, (_edits, exact) in VARIANTS.items():
        lib = ctypes.CDLL(str(outdir / f"lib{name}.so"))
        _build._loaded["minhash"] = lib  # the wrapper's library, for this variant
        minhash_cuda._lib.cache_clear()
        run = torch.full((len(docs), 128), -1, dtype=torch.int32, device=dev)
        event_ms, kernel_ms = cs.timed(lambda: minhash_cuda.minhash_fold_segments(
            run.view(torch.uint32), text, *seg, a, b, k), "SegmentUnits")
        if want is None:
            want = run.clone()
        if exact:
            assert torch.equal(run, want), f"variant {name} changed the signatures"
        print(json.dumps({"variant": name, "exact": exact, "kernel_ms": kernel_ms,
                          "event_ms": event_ms, "card": card}), flush=True)
    _build._loaded.pop("minhash")
    minhash_cuda._lib.cache_clear()
    _pipe_rates(outdir / "pipes.cubin", clock_mhz, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
