"""Variants of the LSH epilogue kernels on the card: a design probe.

    python3 lsh_probe.py [--parent DIR]

Builds copies of ``advanced_scrapper_tpu_torch/csrc/lsh.cu`` with other
values of its constants and other forms of its steps (:data:`VARIANTS`:
the sort held whole in a thread-block cluster's shared memory, or as three
launches a pass, its items a thread, its lane match by ``match.any``, its
registers; the run-head tiles, the records written for every row, the run
heads written straight into the rows or through 16-byte records; lanes a
candidate, rounds of candidates in flight, registers and the repeated
candidates counted each time in ``lsh_verify``; the keys' tiles read as
4-byte words or folded from global memory, their keys written 8 bytes a
store; the label's edge lists with every ok column, its rounds on every
co-resident block), applied by text substitution (the forms the shipped
source no longer has are carried here as source text), and, with
``--parent``, the ``lsh.cu`` of another checkout (the parent commit
unpacked with ``git archive``; its ``lsh_label`` takes ``3 B + rounds``
int32 of scratch), and the L2 read kernel (:data:`L2_READ_SOURCE`), into
``build/kernels/probe/``, all at once, one nvcc each.

Each one, except the cuts (:data:`CUTS`: the sort's scatter writes, the
run heads' scattered record writes and the verify gathers left out, to
show what each costs), is held bit-equal to the plain versions
(``ops.lsh.keys_plain`` and ``pack_keys_plain``, ``torch.sort``,
``run_heads_plain``, ``verify_plain``, ``label_plain``) on the main path's
inputs (the accumulator of ``chip_smoke.py``'s 65,536 ragged articles, 16
+ 32 key sets, 144 candidate columns), on the edge cases of
``chip_smoke.lsh_key_cases``, on the keys' tile edges and general paths
(``chip_smoke.LSH_KEY_SHAPES``) and on ``chip_smoke.lsh_graphs`` at 0, 1,
2, 16 and 31 rounds.  Then the stages of each library (the keys, the packing pass,
Kernel B, the sort, the run heads, the verify at the main path's scalar
bar, the label at the main path's ``jump_rounds``, and the whole
estimator-only epilogue) are timed over those inputs by CUDA events, 5
calls queued behind a spin of the card, in turns (the parent, the shipped
kernels, the variants, the cuts, then the same in reverse), and the
parent's, the shipped and the cluster sort's kernels by the profiler,
kernel by kernel.  One JSON line a (library, stage), with its bound
(``chip_smoke.lsh_bounds``).

Beside them: the sort's launches and bytes a pass, the share of verify's
candidates that repeat within a row, and the L2 read rate (a read of a 32
MiB buffer that stays in L2, :func:`l2_read_rate`) with the gather floor
it sets: the non-self edges' signature bytes, and the distinct ones', over
that rate.  The shipped build and the parent's must pass; a variant the
card does not launch is reported and left out.  Needs one card and
``nvcc``; run it from the repo's root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

ITEMS = "constexpr int kSortItems = 16;"
MATCH = """  unsigned peers = kFull;
#pragma unroll
  for (int i = 0; i <= kRadixBits; ++i) {
    const bool bit = (d >> i) & 1;
    const unsigned v = __ballot_sync(kFull, bit);
    peers &= bit ? v : ~v;
  }
  return peers;"""
SUB = "constexpr int kSub = 16;           // lanes a candidate in lsh_verify"
SCATTER = "__global__ void __launch_bounds__(kThreads, 3)\nsort_scatter_kernel("
VERIFY = "template <int R>\n__global__ void __launch_bounds__(kThreads, 8) verify_kernel("
HEADS = "constexpr int kHeadItems = 2;"
RECORD = """    if (h != p1 || p1 != p2) {
      rec[static_cast<size_t>(band) * B + row] = Rec<Pack>::make(h, p1, p2);
    }"""

#: The three-launches-a-pass sort: a histogram of each (band, tile)'s
#: digits, a scan of each band's [digit][tile] counts digit-major, then the
#: shipped scatter with the scanned offsets in place of its tickets and
#: look-back.  The two kernels it adds:
RTS_KERNELS = r"""// Block (tile, band): the digit counts of the tile's kSortTile positions
// -> hist[band][digit][tile].
__global__ void __launch_bounds__(kThreads)
sort_hist_kernel(const int64_t* __restrict__ src, int B, int shift, int ntiles,
                 int* __restrict__ hist) {
  __shared__ int h[kBins];
  for (int d = threadIdx.x; d < kBins; d += kThreads) h[d] = 0;
  __syncthreads();
  const int64_t* s = src + static_cast<size_t>(blockIdx.y) * B;
  const int lane = threadIdx.x & 31;
  const long long lo = static_cast<long long>(blockIdx.x) * kSortTile;
#pragma unroll 4
  for (int i = 0; i < kSortItems; ++i) {
    const long long p = lo + static_cast<long long>(i) * kThreads + threadIdx.x;
    const bool in = p < B;
    const int d = in ? digit_of(__ldg(s + p), shift) : kBins;
    const unsigned peers = match_digit(d);
    if (in && lane == __ffs(peers) - 1) atomicAdd(h + d, __popc(peers));
  }
  __syncthreads();
  int* out = hist + static_cast<size_t>(blockIdx.y) * kBins * ntiles + blockIdx.x;
  for (int d = threadIdx.x; d < kBins; d += kThreads) out[static_cast<size_t>(d) * ntiles] = h[d];
}

// Block band: hist[band] (digit-major, the order in which the sorted band
// lays out each (digit, tile) group) becomes its exclusive prefix sum; a
// thread takes a run of consecutive counts.
__global__ void __launch_bounds__(kThreads) sort_scan_kernel(int* __restrict__ hist, int ntiles) {
  __shared__ int warp_tot[kWarps];
  int* h = hist + static_cast<size_t>(blockIdx.x) * kBins * ntiles;
  const int n = kBins * ntiles, per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += h[i];
  int run = block_exclusive_sum(sum, warp_tot);
  for (int i = lo; i < hi; ++i) {
    const int c = h[i];
    h[i] = run;
    run += c;
  }
}

"""
LOOKBACK = """  block_exclusive_scan(gbase, warp_tot);
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    unsigned long long* st = status + band * ntiles * kBins + d;
    int before = 0;
    for (int t = tile - 1; t >= 0; --t) {
      unsigned long long x;
      int spins = 0;
      do {
        x = load_volatile(st + static_cast<size_t>(t) * kBins);
        if (++spins > kMaxSpins) __trap();  // a tile that never published: fail, not hang
      } while (x < kAggregate);
      before += static_cast<int>(x & 0xFFFFFFFFull);
      if (x >= kInclusive) break;
    }
    if (tile > 0) {
      store_volatile(st + static_cast<size_t>(tile) * kBins,
                     kInclusive | static_cast<unsigned>(before + dstart[d]));
    }
    gbase[d] += before;
  }
"""
RTS = [
    ("constexpr size_t kScatterSmem =", RTS_KERNELS + "constexpr size_t kScatterSmem ="),
    ("""  if (threadIdx.x == 0) tile_s = atomicAdd(ticket + band, 1);
  __syncthreads();
  const int tile = tile_s;
""", "  const int tile = blockIdx.x;\n"),
    ("""    gbase[d] = ofs[band * kSortPasses * kBins + d];
    store_volatile(status + (band * ntiles + tile) * kBins + d,
                   (tile == 0 ? kInclusive : kAggregate) | static_cast<unsigned>(run));
""", "    gbase[d] = ofs[(band * kBins + d) * ntiles + tile];\n"),
    (LOOKBACK, ""),
    ("""  err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(astt_lsh_sort_scratch(B, nbt)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_digits_kernel<<<grid, kThreads, 0, s>>>(src, B, row_bits, counts);
  err = cudaGetLastError();
""", ""),
    ("""    sort_scatter_kernel<<<grid, kThreads, kScatterSmem, s>>>(
        src, dst, B, shift, ntiles, counts + pass * kBins, status + pass * per_pass,
        tickets + pass * nbt);
""", """    auto* h = static_cast<int*>(scratch);
    sort_hist_kernel<<<grid, kThreads, 0, s>>>(src, B, shift, ntiles, h);
    sort_scan_kernel<<<nbt, kThreads, 0, s>>>(h, ntiles);
    sort_scatter_kernel<<<grid, kThreads, kScatterSmem, s>>>(src, dst, B, shift, ntiles, h,
                                                             status, tickets);
"""),
]

#: The run heads written straight to the output's three columns from the
#: scan (the earlier design's writes): no records, no transpose.
DIRECT = [
    ("""                 int row_bits, typename Rec<Pack>::T* __restrict__ rec) {""",
     """                 int row_bits, typename Rec<Pack>::T* __restrict__ rec, int nbt,
                 int32_t* __restrict__ out) {"""),
    (RECORD, """    int32_t* o = out + static_cast<size_t>(row) * (3 * nbt) + band;
    o[0] = h;
    o[nbt] = p1;
    o[2 * nbt] = p2;"""),
    ("""  cudaError_t err = cudaMemsetAsync(r, 0xFF, sizeof(T) * B * static_cast<size_t>(nbt), s);
  if (err != cudaSuccess) return err;
""", "  cudaError_t err = cudaSuccess;\n"),
    ("                                                   row_bits, r);",
     "                                                   row_bits, r, nbt,"
     " static_cast<int32_t*>(out));"),
    ("""  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = stage_rows(nbt);
  const size_t smem = sizeof(int32_t) * rows * (3 * nbt + 1);  // at most 48 KiB
  heads_out_kernel<Pack><<<(B + rows - 1) / rows, kThreads, smem, s>>>(
      r, B, nbt, rows, static_cast<int32_t*>(out));
""", ""),
]

#: lsh_verify with two rounds of candidates (4 candidates a warp) whose
#: loads issue before any compare.
FLIGHT = """      for (int u0 = 0; u0 < nu; u0 += kAtOnce) {
        const int u = u0 + sg;
        const int j = u < nu ? uj[u] : b;
        const uint4* sj = reinterpret_cast<const uint4*>(a.sig + static_cast<size_t>(j) * a.P);
        uint4 w[R > 0 ? R : 1];
#pragma unroll
        for (int r = 0; r < R; ++r) w[r] = u < nu ? __ldg(sj + r * kSub + g) : uint4{};
        int m = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          m += (w[r].x == mine[r].x) + (w[r].y == mine[r].y) + (w[r].z == mine[r].z) +
               (w[r].w == mine[r].w);
        }
#pragma unroll
        for (int o = 1; o < kSub; o <<= 1) m += __shfl_xor_sync(kFull, m, o);
        bool eq = false;
        if (kb != nullptr && u < nu) {
          const int64_t* kj = a.keys + static_cast<size_t>(j) * a.nk;
          eq = (g < a.num_coarse && __ldg(kj + g) == kb0) ||
               (g + kSub < a.num_coarse && __ldg(kj + g + kSub) == kb1);
          for (int i = g + 2 * kSub; i < a.num_coarse && !eq; i += kSub) eq = kj[i] == kb[i];
        }
        const unsigned anyeq = __ballot_sync(kFull, eq);
        if (g == 0 && u < nu) {
          ucnt[u] = m;
          const bool shares = (anyeq >> (sg * kSub)) & (kSub == 32 ? kFull : (1u << kSub) - 1u);
          uflag[u] = (shares ? kShares : 0) | (a.valid != nullptr && a.valid[j] ? kValid : 0);
        }
      }
"""
FLIGHT2 = """      constexpr int kInFlight = 2;
      for (int u0 = 0; u0 < nu; u0 += kAtOnce * kInFlight) {
        int js[kInFlight];
        uint4 w[kInFlight][R > 0 ? R : 1];
#pragma unroll
        for (int f = 0; f < kInFlight; ++f) {
          const int u = u0 + f * kAtOnce + sg;
          js[f] = u < nu ? uj[u] : b;
          const uint4* sj =
              reinterpret_cast<const uint4*>(a.sig + static_cast<size_t>(js[f]) * a.P);
#pragma unroll
          for (int r = 0; r < R; ++r) w[f][r] = u < nu ? __ldg(sj + r * kSub + g) : uint4{};
        }
#pragma unroll
        for (int f = 0; f < kInFlight; ++f) {
          const int u = u0 + f * kAtOnce + sg;
          int m = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            m += (w[f][r].x == mine[r].x) + (w[f][r].y == mine[r].y) +
                 (w[f][r].z == mine[r].z) + (w[f][r].w == mine[r].w);
          }
#pragma unroll
          for (int o = 1; o < kSub; o <<= 1) m += __shfl_xor_sync(kFull, m, o);
          bool eq = false;
          if (kb != nullptr && u < nu) {
            const int64_t* kj = a.keys + static_cast<size_t>(js[f]) * a.nk;
            eq = (g < a.num_coarse && __ldg(kj + g) == kb0) ||
                 (g + kSub < a.num_coarse && __ldg(kj + g + kSub) == kb1);
            for (int i = g + 2 * kSub; i < a.num_coarse && !eq; i += kSub) eq = kj[i] == kb[i];
          }
          const unsigned anyeq = __ballot_sync(kFull, eq);
          if (g == 0 && u < nu) {
            ucnt[u] = m;
            const bool shares = (anyeq >> (sg * kSub)) & (kSub == 32 ? kFull : (1u << kSub) - 1u);
            uflag[u] = (shares ? kShares : 0) |
                       (a.valid != nullptr && a.valid[js[f]] ? kValid : 0);
          }
        }
      }
"""

#: The cluster sort: a band held whole in the shared memory of a cluster of
#: 8 blocks (8 x 128 KiB of keys, two buffers of 64 KiB a block) for all
#: passes, each pass's digit counts exchanged and the keys scattered
#: through distributed shared memory; the keys read once and written once.
#: Up to 65,536 rows a band.  Added to lsh.cu as astt_lsh_sort_cluster.
CLUSTER_KERNEL = r"""
constexpr int kClusterBlocks = 8;
constexpr int kClusterThreads = 512;
constexpr int kClusterItems = 16;
constexpr int kClusterPart = kClusterThreads * kClusterItems;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr size_t kClusterSmem =
    2 * sizeof(int64_t) * kClusterPart + sizeof(int) * (kClusterWarps + 2) * kBins;

__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kClusterThreads)
sort_cluster_kernel(const int64_t* __restrict__ packed, int B, int row_bits,
                    int64_t* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* src = reinterpret_cast<int64_t*>(smem);
  int64_t* dst = src + kClusterPart;
  int* wcnt = reinterpret_cast<int*>(dst + kClusterPart);
  int* cnt = wcnt + kClusterWarps * kBins;
  int* gbase = cnt + kBins;
  __shared__ int warp_tot[kClusterWarps];
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t band = blockIdx.y;
  const int part = (B + kClusterBlocks - 1) / kClusterBlocks;
  const int lo = rank * part;
  const int n = max(0, min(part, B - lo));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int p = threadIdx.x; p < n; p += kClusterThreads) src[p] = packed[band * B + lo + p];
  for (int pass = 0; pass < kSortPasses; ++pass) {
    const int shift = row_bits + pass * kRadixBits;
    for (int i = threadIdx.x; i < kClusterWarps * kBins; i += kClusterThreads) wcnt[i] = 0;
    __syncthreads();
    const int base = warp * 32 * kClusterItems;
    int* mine = wcnt + warp * kBins;
    int64_t v[kClusterItems];
    int rk[kClusterItems];
#pragma unroll
    for (int i = 0; i < kClusterItems; ++i) {
      const int p = base + 32 * i + lane;
      const bool in = p < n;
      v[i] = in ? src[p] : 0;
      const int d = in ? digit_of(v[i], shift) : kBins;
      const unsigned peers = match_digit(d);
      const int leader = 31 - __clz(peers);
      int old = 0;
      if (in && lane == leader) {
        old = mine[d];
        mine[d] = old + __popc(peers);
      }
      old = __shfl_sync(kFull, old, leader);
      rk[i] = old + __popc(peers & lt);
      __syncwarp();
    }
    __syncthreads();
    for (int d = threadIdx.x; d < kBins; d += kClusterThreads) {
      int run = 0;
      for (int w = 0; w < kClusterWarps; ++w) {
        const int c = wcnt[w * kBins + d];
        wcnt[w * kBins + d] = run;
        run += c;
      }
      cnt[d] = run;
    }
    cluster.sync();
    int before = 0;
    for (int d = threadIdx.x; d < kBins; d += kClusterThreads) {
      int tot = 0;
      for (int r = 0; r < kClusterBlocks; ++r) {
        const int c = cluster.map_shared_rank(cnt, r)[d];
        tot += c;
        if (r < rank) before += c;
      }
      gbase[d] = tot;
    }
    __syncthreads();
    block_exclusive_scan(gbase, warp_tot);
    for (int d = threadIdx.x; d < kBins; d += kClusterThreads) gbase[d] += before;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kClusterItems; ++i) {
      if (base + 32 * i + lane < n) {
        const int d = digit_of(v[i], shift);
        const int pos = gbase[d] + mine[d] + rk[i];
        const int target = pos / part;
        cluster.map_shared_rank(dst, target)[pos - target * part] = v[i];
      }
    }
    cluster.sync();
    int64_t* t = src;
    src = dst;
    dst = t;
  }
  for (int p = threadIdx.x; p < n; p += kClusterThreads) out[band * B + lo + p] = src[p];
}

"""
CLUSTER_HOST = r"""// The cluster sort (a probe variant): B up to 65,536.
int astt_lsh_sort_cluster(const void* packed, int B, int nbt, int row_bits, void* out,
                          void* stream) {
  if (B < 1 || B > kClusterBlocks * kClusterPart || nbt < 1 || nbt > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(sort_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kClusterSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_cluster_kernel<<<dim3(kClusterBlocks, nbt), kClusterThreads, kClusterSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(packed), B, row_bits, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

"""
CLUSTER = [
    ("#include <cstdint>\n", "#include <cstdint>\n\n#include <cooperative_groups.h>\n"),
    ("inline unsigned blocks_for(long long threads) {",
     CLUSTER_KERNEL + "inline unsigned blocks_for(long long threads) {"),
    ("const char* astt_lsh_error_string(int err) {",
     CLUSTER_HOST + "const char* astt_lsh_error_string(int err) {"),
]

#: The keys' write-out of the staged tile as 16-byte stores of two keys
KEYS_PAIRS = """  for (int e = 2 * threadIdx.x; e < n; e += 2 * kThreads) {
    int r = e / ncol, c = e - r * ncol;
    const int64_t v0 = stage[r * kp + c];
    if (e + 1 == n) {
      out[e] = v0;
      break;
    }
    if (++c == ncol) {
      c = 0;
      ++r;
    }
    *reinterpret_cast<longlong2*>(out + e) = make_longlong2(v0, stage[r * kp + c]);
  }
"""
#: ... as 8-byte stores, a key a store
KEYS_SINGLE = """  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / ncol;
    out[e] = stage[r * kp + e - r * ncol];
  }
"""
VEC_PLAN = "  if (vec) {\n"
WORDS_PLAN = "  if (smem <= kMaxBlockSmem) return {kLoadWords, pitch, smem};\n"
LABEL_MATCH = """      const unsigned peers = __match_any_sync(kFull, cand ? j : B);  // B: no candidate
      bool fresh = cand && lane == __ffs(peers) - 1;
      for (int u = 0; fresh && u < n; ++u) fresh = list[u] != j;"""
#: The label's edge lists a group of 32 columns at a time, each group's
#: loads after the previous group's match (the first form), and the shipped
#: chunk of kLabelGroups groups whose loads issue together
LABEL_GROUPS = """  for (int c0 = 0; c0 < nc; c0 += 32 * kLabelGroups) {
    int jr[kLabelGroups];
    bool cr[kLabelGroups];
#pragma unroll
    for (int g = 0; g < kLabelGroups; ++g) {  // every load of the chunk in flight at once
      const int c = c0 + 32 * g + lane;
      jr[g] = c < nc ? rb[c] : b;
      cr[g] = c < nc && ob[c];
    }
#pragma unroll
    for (int g = 0; g < kLabelGroups; ++g) {
      const int j = jr[g];
      const bool cand = cr[g] && j != b && j >= 0 && j < B;
"""
LABEL_SERIAL = """  for (int c0 = 0; c0 < nc; c0 += 32) {
    {
      const int c = c0 + lane;
      const int j = c < nc ? rb[c] : b;
      const bool cand = c < nc && ob[c] && j != b && j >= 0 && j < B;
"""

#: lsh.cu variants: name -> [(text in the source, its replacement)]; the
#: sort held in a cluster's shared memory (:data:`CLUSTER_KERNEL`), or as
#: a histogram, a scan and a scatter launch a pass (:data:`RTS`: no
#: look-back), at 8 and 12 items a thread (tiles of 2,048 and 3,072), its
#: lanes matched by the match.any instruction, its scatter held to 64
#: registers (4 blocks an SM) or not held; the run-head tiles of 256 and
#: 1,024 positions (1 and 4 a thread); a record written for every (band,
#: row), self ones too; the run heads written straight to the output's
#: three columns (:data:`DIRECT`, the earlier design's writes) or as
#: 16-byte records at every size; verify at 8 lanes a candidate, 2 rounds
#: of candidates in flight (:data:`FLIGHT2`), held to 64 or 40 registers
#: (4 or 6 blocks an SM), every column's candidate counted (no dedupe);
#: the keys' tiles read as 4-byte words (no 16-byte loads) or folded
#: straight from global memory (no signature tile), the staged keys written
#: a key a store (:data:`KEYS_SINGLE`); the label's edge lists with every ok
#: column (no dedupe), a group of 32 columns' loads at a time (the first
#: form, :data:`LABEL_SERIAL`) or 3 groups' at once, its rounds on every
#: co-resident block in place of one a 256 rows
VARIANTS = {
    "shipped": [],
    "rts": RTS,
    "cluster": CLUSTER,
    "items8": [(ITEMS, "constexpr int kSortItems = 8;")],
    "items12": [(ITEMS, "constexpr int kSortItems = 12;")],
    "matchany": [(MATCH, "  return __match_any_sync(kFull, d);")],
    "scatter4": [(SCATTER, SCATTER.replace("(kThreads, 3)", "(kThreads, 4)"))],
    "scatter_free": [(SCATTER, SCATTER.replace("(kThreads, 3)", "(kThreads)"))],
    "heads1": [(HEADS, "constexpr int kHeadItems = 1;")],
    "heads4": [(HEADS, "constexpr int kHeadItems = 4;")],
    "write_all": [("    if (h != p1 || p1 != p2) {", "    if (true) {")],
    "direct": DIRECT,
    "rec16": [("{ return row_bits <= kRecBits; }", "{ return false; }")],
    "sub8": [(SUB, "constexpr int kSub = 8;")],
    "flight2": [(FLIGHT, FLIGHT2)],
    "verify4": [(VERIFY, VERIFY.replace("(kThreads, 8)", "(kThreads, 4)"))],
    "verify6": [(VERIFY, VERIFY.replace("(kThreads, 8)", "(kThreads, 6)"))],
    "nodedupe": [("__match_any_sync(kFull, cand ? j : -1);", "1u << lane;"),
                 ("      if (fresh) {\n        // a j of an earlier group", "      if (false) {\n        // a j of an earlier group")],
    "keys_words": [(VEC_PLAN, "  if (false) {\n")],
    "keys_global": [(VEC_PLAN, "  if (false) {\n"), (WORDS_PLAN, "")],
    "keys_store8": [(KEYS_PAIRS, KEYS_SINGLE)],
    "label_nodedupe": [(LABEL_MATCH, "      const bool fresh = cand;")],
    "label_serial": [(LABEL_GROUPS, LABEL_SERIAL)],
    "label_groups3": [("constexpr int kLabelGroups = 6;", "constexpr int kLabelGroups = 3;")],
    "label_fullgrid": [("  const dim3 grid(want < fit ? want : fit);",
                        "  const dim3 grid(fit);")],
}

#: lsh.cu with one step cut out, timed only (their outputs are not the
#: kernels'): the sort scatter's writes, the run heads' record writes (the
#: transpose then reads what is there), the verify's gathers (each
#: candidate's loads read the row's own signature, which L1 holds)
CUTS = {
    "cut_scatter": [("    o[gbase[d] + q - dstart[d]] = val;",
                     "    if (val == -7) o[gbase[d] + q - dstart[d]] = val;")],
    "cut_records": [("    if (h != p1 || p1 != p2) {", "    if ((h ^ p1 ^ p2) == -7) {")],
    "cut_gathers": [("a.sig + static_cast<size_t>(j) * a.P);",
                     "a.sig + static_cast<size_t>(b) * a.P);")],
}

#: A read of n 16-byte words, XOR-folded (the fold keeps the loads), a
#: grid of 8 blocks an SM: the rate at which the card reads a buffer that
#: stays in L2, for ``lsh_verify``'s gather floor.  Measurement only.
L2_READ_SOURCE = r"""#include <cuda_runtime.h>

__global__ void l2_read_kernel(const uint4* __restrict__ buf, long long n,
                               unsigned* __restrict__ sink) {
  unsigned acc = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint4 v = __ldg(buf + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9E3779B9u) *sink = acc;
}

extern "C" int astt_l2_read(const void* buf, long long n16, void* sink, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  l2_read_kernel<<<sms * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), n16, static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}
"""

#: GPU clocks the card spins before a queued timing (~10 ms at 1980 MHz)
AHEAD_CYCLES = 20_000_000


#: ``jump_rounds`` of the label graphs
LABEL_ROUNDS = (0, 1, 2, 16, 31)


class Lib:
    """The entry points of one built ``lsh.cu``, called as
    ``ops/lsh_cuda.py`` calls them (the inputs are the ones the shipped
    wrappers check).  ``parent``: the earlier interface, whose
    ``lsh_label`` takes ``3 B + rounds`` int32 of scratch."""

    def __init__(self, path: Path, parent: bool, cluster: bool = False):
        self.lib = lib = ctypes.CDLL(str(path))
        self.parent, self.cluster = parent, cluster
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.astt_lsh_keys.argtypes = [p, i, i, i, i, p, i, p, p, i, p, p]
        lib.astt_lsh_pack.argtypes = [p, i, i, p, i, p, p]
        lib.astt_lsh_verify.argtypes = [p, i, p, i, i, p, p, i, i, p, i, f, f, f, p, p, p, p]
        lib.astt_lsh_run_heads.argtypes = [p, p, i, i, i, p, p, p]
        lib.astt_lsh_run_heads_scratch.argtypes = [i, i, i]
        lib.astt_lsh_run_heads_scratch.restype = ll
        lib.astt_lsh_sort.argtypes = [p, i, i, i, p, p, p, p]
        lib.astt_lsh_sort_scratch.argtypes = [i, i]
        lib.astt_lsh_sort_scratch.restype = ll
        lib.astt_lsh_label.argtypes = [p, p, p, i, i, i, p, p, p]
        if not parent:
            lib.astt_lsh_label_scratch.argtypes = [i, i]
            lib.astt_lsh_label_scratch.restype = ll
        if cluster:
            lib.astt_lsh_sort_cluster.argtypes = [p, i, i, i, p, p]
            lib.astt_lsh_sort_cluster.restype = i
        for fn in ("keys", "pack", "sort", "run_heads", "verify", "label"):
            getattr(lib, f"astt_lsh_{fn}").restype = i

    @staticmethod
    def _raise_on(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what} variant launch failed: CUDA error {err}")

    @staticmethod
    def _stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def keys(self, sig: torch.Tensor, salts: np.ndarray, nb: int, *, wide: bool = False,
             valid: torch.Tensor | None = None, bits: int = 0):
        """``(keys, packed)`` as ``lsh_cuda.lsh_keys``: ``salts`` the
        ``nb`` coarse then the fine salts, ``uint32`` on the host."""
        B, P = sig.shape
        nk = salts.size
        keys = torch.empty((B, nb, 2) if wide else (B, nk), dtype=torch.int64, device=sig.device)
        packed = (torch.empty((nk, B), dtype=torch.int64, device=sig.device)
                  if valid is not None else None)
        self._raise_on(self.lib.astt_lsh_keys(
            sig.data_ptr(), B, P, nb, nk - nb, salts.ctypes.data, int(wide), keys.data_ptr(),
            None if valid is None else valid.data_ptr(), bits,
            None if packed is None else packed.data_ptr(), self._stream()), "lsh_keys")
        return keys, packed

    def pack(self, keys: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
        B, nk = keys.shape
        packed = torch.empty((nk, B), dtype=torch.int64, device=keys.device)
        self._raise_on(self.lib.astt_lsh_pack(keys.data_ptr(), B, nk, valid.data_ptr(), bits,
                                              packed.data_ptr(), self._stream()), "pack_keys")
        return packed

    def sort(self, packed: torch.Tensor, bits: int) -> torch.Tensor:
        nbt, B = packed.shape
        if self.cluster:
            out = torch.empty_like(packed)
            self._raise_on(self.lib.astt_lsh_sort_cluster(packed.data_ptr(), B, nbt, bits,
                                                          out.data_ptr(), self._stream()),
                           "lsh_sort (cluster)")
            return out
        out, tmp = torch.empty_like(packed), torch.empty_like(packed)
        scratch = torch.empty((self.lib.astt_lsh_sort_scratch(B, nbt),), dtype=torch.uint8,
                              device=packed.device)
        self._raise_on(self.lib.astt_lsh_sort(packed.data_ptr(), B, nbt, bits, out.data_ptr(),
                                              tmp.data_ptr(), scratch.data_ptr(), self._stream()),
                       "lsh_sort")
        return out

    def run_heads(self, srt: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
        nbt, B = srt.shape
        out = torch.empty((B, 3 * nbt), dtype=torch.int32, device=srt.device)
        rec = torch.empty((self.lib.astt_lsh_run_heads_scratch(B, nbt, bits),),
                          dtype=torch.uint8, device=srt.device)
        self._raise_on(self.lib.astt_lsh_run_heads(srt.data_ptr(), valid.data_ptr(), B, nbt,
                                                   bits, out.data_ptr(), rec.data_ptr(),
                                                   self._stream()), "lsh_run_heads")
        return out

    def verify(self, rep: torch.Tensor, valid: torch.Tensor, sig: torch.Tensor,
               base: float) -> torch.Tensor:
        B, nc = rep.shape
        ok = torch.empty((B, nc), dtype=torch.bool, device=rep.device)
        b32 = float(np.float32(base))
        self._raise_on(self.lib.astt_lsh_verify(
            sig.data_ptr(), sig.shape[1], rep.data_ptr(), B, nc, valid.data_ptr(), None, 0, 0,
            None, 0, b32, b32, 0.0, ok.data_ptr(), None, None, self._stream()), "lsh_verify")
        return ok

    def label(self, rep: torch.Tensor, ok: torch.Tensor, valid: torch.Tensor,
              rounds: int) -> torch.Tensor:
        B, nc = rep.shape
        out = torch.empty((B,), dtype=torch.int32, device=rep.device)
        words = 3 * B + rounds if self.parent else -(-self.lib.astt_lsh_label_scratch(B, nc) // 4)
        work = torch.empty((words,), dtype=torch.int32, device=rep.device)
        self._raise_on(self.lib.astt_lsh_label(rep.data_ptr(), ok.data_ptr(), valid.data_ptr(),
                                               B, nc, rounds, work.data_ptr(), out.data_ptr(),
                                               self._stream()), "lsh_label")
        return out


def main_inputs(dev: torch.device) -> dict:
    """The main path's epilogue inputs: the 65,536 ragged articles'
    accumulator and valid rows, the key salts, and the plain versions'
    keys, packed sort keys, sorted keys, candidates, ok edges and labels
    at the engine's ``jump_rounds``; the keys' tile cases
    (``chip_smoke.LSH_KEY_SHAPES``) and the label graphs with their plain
    results."""
    import chip_smoke as cs

    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.ops import lsh
    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine, _jump_rounds

    docs, _planted = cs.ragged_corpus(np.random.RandomState(7), cs.MAIN_ARTICLES)
    eng = NearDupEngine(DedupConfig(rerank=False, exact_verify_band=0.0), device=dev)
    sig, n_bucket = eng._accumulate_device(docs)
    valid = eng._valid_device(docs, n_bucket).contiguous()
    bits = lsh.row_bits(n_bucket)
    salt, fine = np.asarray(eng.params.band_salt), np.asarray(eng._fine_salt())
    keys = lsh.keys_plain(sig, salt, fine)
    packed = lsh.pack_keys_plain(keys, valid, bits)
    srt = lsh.sort_plain(packed)
    rep = lsh.run_heads_plain(srt, valid, bits)
    ok = lsh.verify_plain(rep, valid, sig, base=eng.cfg.sim_threshold)[0]
    rounds = _jump_rounds(n_bucket)
    rng = np.random.RandomState(31)
    tiles = []
    for B, P, nb, nf, wide, off in cs.LSH_KEY_SHAPES:
        sig_np, valid_np = cs.lsh_sigs(rng, B, P)
        buf = torch.from_numpy(np.concatenate([np.zeros(off, np.uint32), sig_np.reshape(-1)])
                               .view(np.int32)).to(dev).view(torch.uint32)
        tsig, tvalid = buf[off:].view(B, P), torch.from_numpy(valid_np).to(dev)
        tsalt = np.concatenate([salt[:nb], lsh.subband_salt(nf)]).astype(np.uint32)
        tkeys = lsh.keys_plain(tsig, salt[:nb], tsalt[nb:], wide=wide)
        tbits = lsh.row_bits(B)
        tiles.append(dict(sig=tsig, valid=tvalid, salts=tsalt, nb=nb, wide=wide, bits=tbits,
                          keys=tkeys, packed=None if wide else
                          lsh.pack_keys_plain(tkeys, tvalid, tbits)))
    graphs = []
    for name, arrays in cs.lsh_graphs(np.random.RandomState(37)).items():
        grep, gok, gvalid = (torch.from_numpy(a).to(dev) for a in arrays)
        graphs.append(dict(name=name, rep=grep, ok=gok, valid=gvalid,
                           want={r: lsh.label_plain(grep, gok, gvalid, r) for r in LABEL_ROUNDS}))
    torch.cuda.synchronize()
    return dict(sig=sig, valid=valid, bits=bits, salts=np.concatenate([salt, fine]).astype(
        np.uint32), nb=salt.size, keys=keys, packed=packed, srt=srt, rep=rep, ok=ok,
        base=eng.cfg.sim_threshold, rounds=rounds,
        labels=lsh.label_plain(rep, ok, valid, rounds), tiles=tiles, graphs=graphs)


def stage_runs(lib: Lib, c: dict) -> dict:
    """``stage -> fn``: each stage of ``lib`` on the main inputs, and the
    whole estimator-only epilogue (keys and packed keys, sort, run heads,
    verify at the scalar bar, label)."""
    packed, srt, valid, bits = c["packed"], c["srt"], c["valid"], c["bits"]

    def epilogue():
        _keys, pk = lib.keys(c["sig"], c["salts"], c["nb"], valid=valid, bits=bits)
        rep = lib.run_heads(lib.sort(pk, bits), valid, bits)
        return lib.label(rep, lib.verify(rep, valid, c["sig"], c["base"]), valid, c["rounds"])

    return {
        "keys": lambda: lib.keys(c["sig"], c["salts"], c["nb"], valid=valid, bits=bits),
        "pack": lambda: lib.pack(c["keys"], valid, bits),
        "kernel_b": lambda: lib.run_heads(lib.sort(packed, bits), valid, bits),
        "sort": lambda: lib.sort(packed, bits),
        "run_heads": lambda: lib.run_heads(srt, valid, bits),
        "verify": lambda: lib.verify(c["rep"], valid, c["sig"], c["base"]),
        "label": lambda: lib.label(c["rep"], c["ok"], valid, c["rounds"]),
        "epilogue": epilogue,
    }


def equal_to_plain(lib: Lib, c: dict, dev: torch.device) -> dict:
    """Each stage of ``lib`` against the plain versions on the main inputs,
    on ``chip_smoke.lsh_key_cases``, the keys' tile cases and the label
    graphs."""
    import chip_smoke as cs

    from advanced_scrapper_tpu_torch.ops import lsh

    valid, bits = c["valid"], c["bits"]
    keys, packed = lib.keys(c["sig"], c["salts"], c["nb"], valid=valid, bits=bits)
    out = {
        "keys": bool(torch.equal(keys, c["keys"]) and torch.equal(packed, c["packed"])),
        "pack": bool(torch.equal(lib.pack(c["keys"], valid, bits), c["packed"])),
        "sort": bool(torch.equal(lib.sort(c["packed"], bits), c["srt"])),
        "run_heads": bool(torch.equal(lib.run_heads(c["srt"], valid, bits), c["rep"])),
        "verify": bool(torch.equal(lib.verify(c["rep"], valid, c["sig"], c["base"]), c["ok"])),
        "label": bool(torch.equal(lib.label(c["rep"], c["ok"], valid, c["rounds"]),
                                  c["labels"])),
        "epilogue": bool(torch.equal(stage_runs(lib, c)["epilogue"](), c["labels"])),
    }
    for t in c["tiles"]:
        if t["wide"]:
            got = lib.keys(t["sig"], t["salts"], t["nb"], wide=True)[0]
            out["keys"] &= bool(torch.equal(got, t["keys"]))
            continue
        got, pk = lib.keys(t["sig"], t["salts"], t["nb"], valid=t["valid"], bits=t["bits"])
        out["keys"] &= bool(torch.equal(got, t["keys"]) and torch.equal(pk, t["packed"]))
        out["pack"] &= bool(torch.equal(lib.pack(got, t["valid"], t["bits"]), t["packed"]))
    for g in c["graphs"]:
        for r, want in g["want"].items():
            out["label"] &= bool(torch.equal(lib.label(g["rep"], g["ok"], g["valid"], r), want))
    cases = 0
    for name, (k, v) in cs.lsh_key_cases(np.random.RandomState(29)).items():
        keys, valid = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
        bits = lsh.row_bits(keys.shape[0])
        packed = lsh.pack_keys_plain(keys, valid, bits)
        out["pack"] &= bool(torch.equal(lib.pack(keys, valid, bits), packed))
        srt = lsh.sort_plain(packed)
        got = lib.run_heads(lib.sort(packed, bits), valid, bits)
        assert torch.equal(got, lsh.run_heads_plain(srt, valid, bits)), name
        cases += 1
    out["key_cases"] = cases
    return out


def repeat_share(rep: torch.Tensor) -> dict:
    """Non-self in-range candidate columns and distinct (row, candidate)
    pairs among them."""
    B = rep.shape[0]
    idx = torch.arange(B, device=rep.device)[:, None]
    r = torch.where((rep != idx) & (rep >= 0) & (rep < B), rep, -1)
    srt = torch.sort(r, dim=1).values
    edges = int((srt >= 0).sum())
    distinct = int(((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)).sum() + (srt[:, 0] >= 0).sum())
    return {"non_self_edges": edges, "distinct_pairs": distinct,
            "repeat_share": 1 - distinct / edges if edges else 0.0}


def l2_read_rate(cuda_ms) -> dict:
    """Bytes a second at which the card reads a 32 MiB buffer that stays in
    L2: :data:`L2_READ_SOURCE` built into ``build/kernels/probe/``, then
    warm, 20 reads queued, timed by ``cuda_ms`` (``chip_smoke.cuda_ms``)."""
    import myers_probe as mp
    from advanced_scrapper_tpu_torch.ops import _build

    src = _build.BUILD_DIR / "probe" / "l2_read.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(L2_READ_SOURCE)
    lib = ctypes.CDLL(str(mp.build_sources({("l2_read", "probe"): src})["l2_read", "probe"]))
    lib.astt_l2_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.astt_l2_read.restype = ctypes.c_int
    buf = torch.zeros((32 << 20,), dtype=torch.uint8, device="cuda")
    sink = torch.zeros((1,), dtype=torch.int32, device="cuda")

    def read() -> None:
        err = lib.astt_l2_read(buf.data_ptr(), buf.numel() // 16, sink.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"l2_read launch failed: CUDA error {err}")

    read()
    ms = cuda_ms(read, 20, queued=True)
    return {"l2_read_ms": ms, "l2_bytes": buf.numel(), "l2_bytes_per_s": buf.numel() / ms * 1e3}


def sort_passes(c: dict) -> dict:
    """The shipped sort's launches and the bytes of each launch: each read
    and write of the int64 keys once, the counts and published tile counts
    once each way."""
    from advanced_scrapper_tpu_torch.ops import lsh_cuda

    nbt, B = c["packed"].shape
    keys = nbt * B * 8
    scratch = lsh_cuda._lib().astt_lsh_sort_scratch(B, nbt)
    passes = lsh_cuda.sort_passes()
    return {"passes": passes, "launches": lsh_cuda.sort_launches(), "scratch_bytes": scratch,
            "bytes": {"memset": scratch, "digits": keys, "scatter_each": 2 * keys
                      + 2 * scratch // passes}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="a checkout whose lsh.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lsh_probe runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs  # the corpus, the edge cases, bounds and timers of the smoke run
    import myers_probe as mp  # the variant builder and the timer in turns

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(json.dumps({"card": card}), flush=True)
    libs = mp.build_variants(args.parent, {"lsh": {**VARIANTS, **CUTS}})
    order = sorted(libs, key=lambda key: (key[1] != "parent", key[1] in CUTS))
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    c = main_inputs(dev)
    runs = {}
    for key in order:
        name = key[1]
        lib = Lib(libs[key], parent=name == "parent", cluster=name == "cluster")
        stages = stage_runs(lib, c)
        if name not in CUTS:
            try:
                eq = equal_to_plain(lib, c, dev)
            except RuntimeError as e:  # a variant the card does not launch: left out
                if name in ("shipped", "parent"):
                    raise
                print(json.dumps({"variant": name, "launch_failed": str(e)[:300]}), flush=True)
                continue
            assert all(eq.values()), f"lsh.cu {name} differs from plain: {eq}"
            print(json.dumps({"variant": name, "equal_to_plain": eq}), flush=True)
        for stage, fn in stages.items():
            fn()
            runs[name, stage] = fn
    torch.cuda.synchronize()
    times = mp.timed_twice(cs, runs, ahead=AHEAD_CYCLES)
    rounds_run = cs.label_rounds_run(c["rep"], c["ok"], c["valid"], c["rounds"])
    bounds = cs.lsh_bounds(c["sig"], c["rep"], c["packed"].shape[0], clock_mhz,
                           fine=c["salts"].size - c["nb"], rounds_run=rounds_run)
    for (name, stage), t in times.items():
        ms = [x[0] for x in t]
        mean = sum(ms) / len(ms)
        b = bounds[stage]
        print(json.dumps({"stage": stage, "variant": name, "ms": ms, "ms_mean": mean,
                          "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                          "share_of_bound": b["bound_ms"] / mean,
                          "equal_to_plain": name not in CUTS,
                          "clock_sm": [x for y in t for x in y[1:]], "card": card}), flush=True)
    for name in ("parent", "shipped", "cluster"):
        if (name, "kernel_b") not in runs:
            continue
        seen = cs.profiler_device_ms(lambda n=name: [runs[n, s]() for s in ("kernel_b", "verify")],
                                     ("run_heads_kernel", "verify_kernel"))
        print(json.dumps({"profile": name,
                          "per_launch_ms": {k: v[0] / v[1] for k, v in seen.items()},
                          "recorded": {k: v[1] for k, v in seen.items()}, "card": card}),
              flush=True)
    # the redesigned stages, kernel by kernel: every kernel of a call, summed
    # over the profiler's 5 calls (per_call_ms counts every recorded launch)
    for name in ("parent", "shipped"):
        for stage, want in (("keys", ("keys_kernel",)), ("pack", ("pack_kernel",)),
                            ("label", ("label_",))):
            if (name, stage) not in runs:
                continue
            seen = cs.profiler_device_ms(runs[name, stage], want)
            print(json.dumps({"profile": name, "stage": stage,
                              "per_call_ms": sum(v[0] for v in seen.values()) / 5,
                              "per_launch_ms": {k: v[0] / v[1] for k, v in seen.items()},
                              "recorded": {k: v[1] for k, v in seen.items()}, "card": card}),
                  flush=True)
    print(json.dumps({"label": {"jump_rounds": c["rounds"], "rounds_run": rounds_run},
                      "card": card}), flush=True)
    share = repeat_share(c["rep"])
    rate = l2_read_rate(cs.cuda_ms)
    gathered = share["non_self_edges"] * c["sig"].shape[1] * 4
    distinct = share["distinct_pairs"] * c["sig"].shape[1] * 4
    print(json.dumps({"verify_gather": {
        **share, **rate, "gathered_bytes": gathered, "distinct_bytes": distinct,
        "gather_floor_ms": gathered / rate["l2_bytes_per_s"] * 1e3,
        "distinct_floor_ms": distinct / rate["l2_bytes_per_s"] * 1e3}, "card": card}), flush=True)
    print(json.dumps({"sort_passes": sort_passes(c), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
