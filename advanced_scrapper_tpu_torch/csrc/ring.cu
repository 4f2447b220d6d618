// The mesh's ring join by hand for Hopper (sm_90a): two launches a (hop,
// shard) of make_ring_dedup.
//
// Replaces the jnp device code of advanced_scrapper_tpu/parallel/ring.py:
// _best_match_against_sorted (:59; its band_body :82 under lax.scan) and the
// rep = min(rep, cand) of make_ring_dedup's hop (:139).  There is no Pallas
// original; the port ran a Python loop over the bands, each a searchsorted,
// two gathers, a [Bl, P] compare and a reduction (~10 launches a band).  The
// presort (_presort_bands :43) runs on lsh_sort (csrc/lsh.cu), so each block
// carries each band's packed keys (key << bits) | i sorted ascending, where i
// indexes the block's order (perm), its rows valid first (each group
// ascending): within a key that is the reference's (key, gidx_eff) order.
// The local block keeps its own presort (sorted_l, order_l) for every hop.
//
// For each local row r and each band b, the transit position
// searchsorted(keys of band b, key_l[r, b], side="left"), clamped to Bt - 1:
// the run head only, as in the reference.  A hit (the key there equals the
// row's) names the transit row perm[i] and its global index gidx_eff; the
// candidate verifies when its signature agrees with the row's on count / P
// of the words (float32, __fdiv_rn) >= thr (the threshold rounded to float32)
// and it comes before the row (gidx_eff < gidx_l).  The row's result is the
// smallest verified candidate, else its own index, and rep[r] takes the
// minimum of that and what it held.
//
// Bound, at the mesh plane's shape (65,536 articles on 8 shards: Bl = Bt =
// 8,192, 16 bands, P = 128): bytes.  A launch must read the local keys (1
// MiB) and the transit keys (1 MiB), perm and gidx_eff where a band hits,
// both signatures of each pair it verifies (a few hundred rows), and read
// and write rep: ~2.4 MB, under 1 us at 3.35 TB/s.  The first design (PR
// 26: a warp a local row, a lane a band, each lane's run head a binary
// search of 13 dependent loads over its band in L2, one wave of 1,024
// blocks) took 0.0118 ms a launch on an H100 80GB HBM3 at 700 W, 6.2% of
// that bound: the search chain was the launch.  What bounds this design is
// the few dependent round trips that remain (a block's staging, the
// gathers at hits, the table, the verification) and two launches.
//
// Design: a merge of two sorted blocks, in two phases.
// - Phase 1, by band: a block takes kTile consecutive local sorted positions
//   of one band.  Blocks of one key distribution put the tile's run heads
//   near the same share of the transit band, so that window and kGuard
//   keys each side are staged into shared memory by 8-byte cp.async at
//   once, and kept when they hold the tile's first and last run heads.
//   Else the threads find where the tile's first and last keys go in the
//   transit band by two 128-way searches side by side (one round of loads
//   at 8,192 rows, to within kSlack) and stage that span.  Each position's
//   run head is then a binary search in shared memory.  A hit's (gidx_eff, transit row), else
//   (int32 max, 0), goes to the candidate table at [order_l's row, band]:
//   every entry is written once, as each local row has one position a band.
//   A tile whose span passes kSpanMax (a long run of equal transit keys
//   between its first and last key) searches each position in global
//   memory between the two bounds instead: the data decides, not a failure.
// - Phase 2, by row: a group of kGroup lanes a local row (16 at nb <= 16,
//   so no lane idles at 16 bands; 32 above, bands in rounds of 32) reads
//   the row's table entries; the candidates that come before the row and
//   could lower its best are verified in ascending global index, each
//   distinct one once: the group takes the smallest left (a min
//   reduction), counts its agreement (a lane a 16-byte word group of both
//   signatures, an add reduction), and stops at the first that verifies,
//   which is the minimum the reference takes; a candidate that fails drops
//   out of every lane that holds it.  rep = min(rep, cand) is fused.
// - Two launches: phase 2 is a programmatic dependent launch, so its
//   blocks start while phase 1 runs, read their rows' order_l, gidx_l and
//   rep, and wait (griddepcontrol.wait) for phase 1's table.  Two ordinary
//   launches, and one cooperative launch with a grid sync between the
//   phases, measured slower on the H100 (join_probe.py carries both).  The
//   table is the wrapper's scratch, int32[Bl, nb, 2].

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 1;                     // local sorted positions a thread in phase 1
constexpr int kTile = kThreads * kItems;      // a phase-1 block's positions
constexpr int kSpanMax = 4 * kTile;           // transit keys staged in shared memory (8 KiB)
constexpr int kGuard = 256;                   // the guessed window's reach past the tile's own
constexpr int kSearchLanes = kThreads / 2;    // threads a bracket of a tile's bound
constexpr int kSlack = 64;                    // a bracket no wider is staged as it is
constexpr int32_t kBig = 0x7FFFFFFF;          // int32 max: no candidate
constexpr unsigned kFull = 0xFFFFFFFFu;

struct JoinArgs {
  const uint32_t* sig_l;
  const int32_t* gidx_l;
  const int64_t* sorted_l;
  const int32_t* order_l;
  const int64_t* sorted_t;
  const int32_t* perm;
  const int32_t* gidx_eff;
  const uint32_t* sig_b;
  int Bl, Bt, nb, P, bits;
  float thr;
  int2* table;
  int32_t* rep;
};

__device__ __forceinline__ void cp_async8(int64_t* dst, const int64_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A bracket [L, R] of the first position of band[0, Bt) whose packed key
// is >= target (Bt if none), for the first half of the block's threads
// (their target) and the second (theirs) at once: each round a thread
// loads one of kSearchLanes evenly spaced keys of its range, the keys below
// the target are counted, and the range shrinks to the gap after the last
// of them; rounds go on while a range is wider than kSlack (one round at
// 8,192 rows).
__device__ __forceinline__ int2 block_bracket(const int64_t* __restrict__ band, int Bt,
                                              int64_t target, int* red) {
  const int half = threadIdx.x / kSearchLanes;
  const int q = threadIdx.x % kSearchLanes;
  const int warp = threadIdx.x >> 5;
  int L = 0, R = Bt;
  for (;;) {
    const int n = R - L;
    const bool open = n > kSlack;
    if (!__syncthreads_or(open)) break;
    const int stride = open ? (n + kSearchLanes - 1) / kSearchLanes : 1;
    const int s = L + q * stride;
    const bool below = open && s < R && __ldg(band + s) < target;
    const unsigned votes = __ballot_sync(kFull, below);
    if ((threadIdx.x & 31) == 0) red[warp] = __popc(votes);
    __syncthreads();
    int c = 0;
#pragma unroll
    for (int w = 0; w < kSearchLanes / 32; ++w) c += red[half * (kSearchLanes / 32) + w];
    __syncthreads();  // red is written again next round
    if (open) {
      if (c == 0) {
        R = L;  // band[L] >= target
      } else {
        const int m = (n + stride - 1) / stride;  // keys loaded
        const int Rn = c < m ? L + c * stride : R;
        L = L + (c - 1) * stride + 1;
        R = Rn;
      }
    }
  }
  return make_int2(L, R);
}

// Phase 1 for one (band, tile) of local sorted positions.
__device__ void join_tile(const JoinArgs& a, int band, int tile, int64_t* span, int* red) {
  const int64_t* lband = a.sorted_l + static_cast<int64_t>(band) * a.Bl;
  const int64_t* tband = a.sorted_t + static_cast<int64_t>(band) * a.Bt;
  const int64_t mask = (int64_t{1} << a.bits) - 1;
  const int j0 = tile * kTile;
  const int n_here = min(kTile, a.Bl - j0);
  int64_t lv[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = j0 + i * kThreads + static_cast<int>(threadIdx.x);
    lv[i] = j < a.Bl ? __ldg(lband + j) : -1;
  }
  // the tile's first and last keys: every thread loads the same two words
  const int64_t k_first = __ldg(lband + j0) >> a.bits;
  const int64_t k_last = __ldg(lband + j0 + n_here - 1) >> a.bits;
  // The guess: in blocks of one key distribution the transit run heads of
  // local positions [j0, j0 + n_here) lie near the same share of the band,
  // so that window and kGuard positions each side are staged at once; it
  // holds every run head of the tile when its first key is below the
  // tile's first key (or it starts the band) and its last key is at least
  // the tile's last key (or it ends the band).
  const float scale = static_cast<float>(a.Bt) / static_cast<float>(a.Bl);  // any guess is safe
  int s0 = max(__float2int_rd(j0 * scale) - kGuard, 0);
  int len = min(__float2int_rd((j0 + n_here) * scale) + kGuard, a.Bt - 1) - s0 + 1;
  const bool guessed = len <= kSpanMax;
  if (guessed) {
    for (int k = threadIdx.x; k < len; k += kThreads) cp_async8(span + k, tband + s0 + k);
  }
  cp_async_wait_all();
  __syncthreads();
  bool staged = guessed && (s0 == 0 || span[0] < (k_first << a.bits)) &&
                (s0 + len == a.Bt || span[len - 1] >= (k_last << a.bits));
  int lo = 0, hi = 0;
  if (!staged) {  // the same in every thread: bracket both bounds, stage between them
    const int64_t target = (threadIdx.x < kSearchLanes ? k_first : k_last) << a.bits;
    const int2 br = block_bracket(tband, a.Bt, target, red);  // syncs before span is reused
    if (threadIdx.x == 0) red[kWarps] = br.x;
    if (threadIdx.x == kSearchLanes) red[kWarps + 1] = br.y;
    __syncthreads();
    lo = red[kWarps];  // both run heads lie in [lo, hi]
    hi = red[kWarps + 1];
    __syncthreads();  // red is the next tile's too
    s0 = min(lo, a.Bt - 1);
    len = min(hi, a.Bt - 1) - s0 + 1;
    staged = len <= kSpanMax;
    if (staged) {
      for (int k = threadIdx.x; k < len; k += kThreads) cp_async8(span + k, tband + s0 + k);
      cp_async_wait_all();
      __syncthreads();
    }
  }
  // every item's run head, then every item's gathers, so they are in flight together
  int64_t v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t t = (lv[i] >> a.bits) << a.bits;
    if (staged) {  // among the staged keys
      int l = 0, r = len;
      while (l < r) {
        const int mid = (l + r) >> 1;
        if (span[mid] < t) {
          l = mid + 1;
        } else {
          r = mid;
        }
      }
      v[i] = span[l < len ? l : len - 1];
    } else {  // a long run: between the tile's bounds in global memory
      int l = lo, r = hi;
      while (l < r) {
        const int mid = (l + r) >> 1;
        if (__ldg(tband + mid) < t) {
          l = mid + 1;
        } else {
          r = mid;
        }
      }
      v[i] = __ldg(tband + (l < a.Bt ? l : a.Bt - 1));
    }
  }
  int32_t crow[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t ti = v[i] & mask;
    const bool hit = lv[i] >= 0 && (v[i] >> a.bits) == (lv[i] >> a.bits) && ti < a.Bt;
    crow[i] = hit ? __ldg(a.perm + ti) : -1;
  }
  int32_t cg[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    cg[i] = crow[i] >= 0 && crow[i] < a.Bt ? __ldg(a.gidx_eff + crow[i]) : kBig;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {  // at the local row's place in order_l
    const int64_t f = lv[i] & mask;
    if (lv[i] >= 0 && f < a.Bl) {
      a.table[f * a.nb + band] = cg[i] == kBig ? make_int2(kBig, 0) : make_int2(cg[i], crow[i]);
    }
  }
  __syncthreads();  // span is the next tile's
}

// Words where the two signature rows agree, summed over the group.
template <int kVec, int kGroup>
__device__ __forceinline__ int agree_count(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b, int P, int sub,
                                           unsigned gmask) {
  int c = 0;
  if (kVec == 4) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    for (int w = sub; w < P / 4; w += kGroup) {
      const uint4 x = __ldg(a4 + w), y = __ldg(b4 + w);
      c += (x.x == y.x) + (x.y == y.y) + (x.z == y.z) + (x.w == y.w);
    }
  } else {
    for (int w = sub; w < P; w += kGroup) c += __ldg(a + w) == __ldg(b + w);
  }
  return __reduce_add_sync(gmask, c);
}

// Phase 2 for the local row r = order_l[f] (its gidx_l and rep read ahead),
// by a group of kGroup lanes.
template <int kVec, int kGroup>
__device__ void join_row(const JoinArgs& a, int f, int r, int32_t gl, int32_t old, int sub,
                         unsigned gmask) {
  const uint32_t* own = a.sig_l + static_cast<int64_t>(r) * a.P;
  const int2* ent = a.table + static_cast<int64_t>(f) * a.nb;
  int32_t best = kBig;
  for (int b0 = 0; b0 < a.nb; b0 += kGroup) {
    const int b = b0 + sub;
    int32_t cand = kBig, crow = 0;
    if (b < a.nb) {
      const int2 e = __ldcg(ent + b);  // written by other blocks: through L2
      if (e.x < gl && e.x < best) {
        cand = e.x;
        crow = e.y;
      }
    }
    for (;;) {
      const int32_t m = __reduce_min_sync(gmask, cand);
      if (m == kBig) break;
      const int owner = __ffs(__ballot_sync(gmask, cand == m)) - 1;
      const int32_t trow = __shfl_sync(gmask, crow, owner);
      const int count = agree_count<kVec, kGroup>(
          own, a.sig_b + static_cast<int64_t>(trow) * a.P, a.P, sub, gmask);
      if (__fdiv_rn(static_cast<float>(count), static_cast<float>(a.P)) >= a.thr) {
        best = m;
        break;
      }
      if (cand == m) cand = kBig;
    }
  }
  if (sub == 0) {
    const int32_t c = best == kBig ? gl : best;
    a.rep[r] = c < old ? c : old;
  }
}

__device__ void tiles_phase(const JoinArgs& a, int64_t* span, int* red) {
  const int tiles = (a.Bl + kTile - 1) / kTile;
  for (int item = blockIdx.x; item < tiles * a.nb; item += gridDim.x) {
    join_tile(a, item / tiles, item % tiles, span, red);
  }
}

// The local order's positions f, grid-strided; each group reads its first
// row (order_l[f]), that row's gidx_l and rep, then waits for phase 1's
// grid and its table, so those reads overlap phase 1.
template <int kVec, int kGroup>
__device__ void rows_phase(const JoinArgs& a) {
  constexpr int kPerBlock = kThreads / kGroup;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const unsigned gmask = kGroup == 32 ? kFull : 0xFFFFu << (lane & 16);
  int f = blockIdx.x * kPerBlock + static_cast<int>(threadIdx.x) / kGroup;
  int r = -1;
  int32_t gl = 0, old = 0;
  auto row_of = [&](int at) {  // order_l's row at `at`, -1 past the block
    r = at < a.Bl ? __ldg(a.order_l + at) : -1;
    if (r >= a.Bl) r = -1;
    if (r >= 0) {
      gl = __ldg(a.gidx_l + r);
      old = a.rep[r];
    }
  };
  row_of(f);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (; f < a.Bl; f += gridDim.x * kPerBlock) {
    if (r >= 0) join_row<kVec, kGroup>(a, f, r, gl, old, sub, gmask);
    row_of(f + gridDim.x * kPerBlock);
  }
}

// Phase 1; it lets the rows' launch start at once.
__global__ void __launch_bounds__(kThreads) ring_tiles_kernel(JoinArgs a) {
  __shared__ int64_t span[kSpanMax];
  __shared__ int red[kWarps + 2];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  tiles_phase(a, span, red);
}

// Phase 2.
template <int kVec, int kGroup>
__global__ void __launch_bounds__(kThreads) ring_rows_kernel(JoinArgs a) {
  rows_phase<kVec, kGroup>(a);
}

template <int kVec, int kGroup>
cudaError_t launch(JoinArgs a, cudaStream_t s) {
  const int tiles = (a.Bl + kTile - 1) / kTile;
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
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel launches of one astt_ring_join call with Bl > 0.
int astt_ring_join_launches() { return 2; }

// sig_l uint32[Bl, P], gidx_l int32[Bl]; the local block's presort: sorted_l
// int64[nb, Bl] (each band's packed keys ascending) and order_l int32[Bl];
// the transit block: sorted_t int64[nb, Bt], perm int32[Bt], gidx_eff
// int32[Bt], sig_b uint32[Bt, P]; both blocks' row fields `bits` wide; thr
// the bar as float32; table int32[Bl, nb, 2] scratch -> rep int32[Bl]
// updated in place to min(rep, the join).  Launches nothing for Bl == 0;
// returns CUDA's error where a launch fails.
int astt_ring_join(const void* sig_l, const void* gidx_l, const void* sorted_l,
                   const void* order_l, const void* sorted_t, const void* perm,
                   const void* gidx_eff, const void* sig_b, int Bl, int Bt, int nb, int P,
                   int bits, float thr, void* table, void* rep, void* stream) {
  if (Bl < 0 || Bt < 1 || nb < 1 || P < 1 || bits < 0 || bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Bl == 0) return 0;
  JoinArgs a{static_cast<const uint32_t*>(sig_l),   static_cast<const int32_t*>(gidx_l),
             static_cast<const int64_t*>(sorted_l), static_cast<const int32_t*>(order_l),
             static_cast<const int64_t*>(sorted_t), static_cast<const int32_t*>(perm),
             static_cast<const int32_t*>(gidx_eff), static_cast<const uint32_t*>(sig_b),
             Bl, Bt, nb, P, bits, thr, static_cast<int2*>(table), static_cast<int32_t*>(rep)};
  auto* s = static_cast<cudaStream_t>(stream);
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(sig_l) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sig_b) % 16 == 0;
  cudaError_t err;
  if (nb <= 16) {
    err = vec ? launch<4, 16>(a, s) : launch<1, 16>(a, s);
  } else {
    err = vec ? launch<4, 32>(a, s) : launch<1, 32>(a, s);
  }
  return static_cast<int>(err);
}

const char* astt_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
