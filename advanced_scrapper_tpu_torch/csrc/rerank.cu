// Quantized bottom-sketch Jaccard of sketch pairs and its verdict, by hand
// for Hopper (sm_90a): the rerank tier's settle with the finalize fused.
//
// Replaces the reference's jnp settle step,
// advanced_scrapper_tpu/ops/rerank.py:_pair_jq under vmap in
// make_rerank_tile_step, which sorts the concatenation of the pair's two
// sketches, and its finalize, make_rerank_finalize.  There is no Pallas
// original; XLA fuses that sort, where PyTorch would build a [pairs, 2S]
// int64 intermediate (1 GiB at 65,536 pairs and S = 1,024).
//
// Input: sk uint32[n_sk, S], each row sorted ascending, its live hashes
// unique and none equal to PAD, then PAD up to S (ops/rerank.py:
// bottom_sketch builds exactly this); ia, ib int32[m] row indices; the
// margin band [lo, hi).  Output: out int32[2, m], row 0 bit-equal to
// _pair_jq(sk[ia], sk[ib], S), row 1 the finalize's verdict:
//
//   n_uni   = |a| + |b| - |a∩b|          (|a| = index of the first PAD)
//   kk      = min(n_uni, S)
//   matches = the common values whose rank in the union is < kk
//   jq      = kk > 0 ? (SCALE * matches + kk / 2) / kk : SCALE
//   verdict = lo <= jq < hi ? -1 : (jq >= hi ? 1 : 0)
//
// Bound: the bytes are each participating sketch's live values and the
// PAD after them read once, 8 bytes of indices and 8 of output per pair;
// the operations are |a| + |b| comparison steps per pair at the INT32
// rate.  Bytes bound it at the tier's shapes: ~1.8 us for the ~4,100 pairs
// over ~2,150 sketches of a 4,096-article near-dup corpus, about one
// launch, so that shape is bound by latency; ~20 us for the 21,960 pairs
// over 21,801 sketches (68 MB of live values, more than the 50 MB L2) of
// 65,536 ragged articles, most of them pairs of exact duplicates.  A
// kernel that reads each pair's two rows reads most sketches twice there
// (a row sits in ~2 pairs and falls out of L2 between them), so the bytes
// it must move are nearer twice the bound.  The first design (a
// 128-thread block per pair) copied both whole rows with 4-byte loads
// behind a __syncthreads, re-read row a for every pair, and binary-searched
// each value of a in b twice.
//
// Design:
// - One warp per pair, up to eight warps a block (as many as their slots
//   fit in 227 KiB), a persistent grid: each warp takes a contiguous run
//   of pairs in the given order (the tier's list is sorted by (i, j)), so
//   row a stays in the warp's slot while ia repeats and only row b is
//   copied again.  A warp owns two slots of S + 1 words (the last one PAD)
//   in shared memory; no __syncthreads.
// - Only live values move.  Each lane reads one word of the row from
//   global memory at stride ceil(S / 32); the first lane that sees PAD
//   bounds |a| to one stride, and the warp copies that prefix with
//   16-byte cp.async (4-byte where S or the base is not 16-byte aligned).
//   |a| is then one ballot over that stride in shared memory.  The next
//   pair's indices and probe words are loaded before this pair merges, so
//   their latency hides behind it.  The copies' latency hides behind the
//   other warps of the SM (three blocks fit at S = 1,024); double-buffered
//   slots would halve those warps.
// - A common prefix of length p (a[k] == b[k] for k < p, found by
//   coalesced compares) merges as a[0], b[0], a[1], b[1], ...: p common
//   values of union ranks 0 ... p - 1, and the merge path runs through
//   (p, p).  Exact duplicates, most pairs of the ragged corpus, end there.
// - A merge-path count of the rest instead of binary search: lane l walks
//   diagonal slice l of the merge (a before b on ties) from a split found
//   by one binary search, and counts the common values, each the one step
//   where the heads are equal.  A common value's union rank is its merge
//   index less the common values before it; warp shuffles give each lane
//   that prefix, n_uni and kk.  Where n_uni <= S all common values match;
//   otherwise ranks rise along the merge, so only the one slice that
//   crosses rank kk is counted again, by the whole warp, 1/32 of it a lane.
// - The finalize is fused: lane 0 writes jq and the verdict.
//
// On an H100 (PERF.md) the load path alone takes about as long as
// moving each pair's two live prefixes at the memory's rate; near-dup
// pairs, which share few leading values, spend most of their time in the
// walk, a chain of dependent shared-memory loads.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScale = 10000;
constexpr uint32_t kPad = 0xFFFFFFFFu;
constexpr int kWarps = 8;
// dynamic shared memory one block may opt in to on an H100 (227 KiB)
constexpr int kSmemOptin = 227 * 1024;

// words of one row slot: the row, one PAD word after it, rounded to 16 B
__host__ __device__ constexpr int slot_words(int size) { return (size + 4) & ~3; }

// the widest sketch whose two slots fit one warp's block
constexpr int kMaxSketch = kSmemOptin / 8 - 1;
static_assert(2 * 4 * slot_words(kMaxSketch) <= kSmemOptin, "two slots of the widest sketch");

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This lane's probe word of a row: the last word of its stride.
__device__ __forceinline__ uint32_t probe(const uint32_t* row, int size, int step, int lane) {
  return __ldg(row + min((lane + 1) * step, size) - 1);
}

// What the probes say of a row: its length `n` if no probe saw PAD, else
// (n = -1) the first PAD lies in [from, last] and `last` holds PAD.
struct Extent {
  int n, from, last;
};

// Starts the copy of a row's live prefix (up to the first PAD probe) into
// `slot` and returns its extent.
template <int kVec>
__device__ __forceinline__ Extent copy_live(uint32_t* slot, const uint32_t* row, int size,
                                            int step, uint32_t probe_word, int lane) {
  const unsigned pad = __ballot_sync(kFull, probe_word == kPad);
  Extent e{size, 0, size - 1};
  if (pad) {
    const int f = __ffs(pad) - 1;
    e = Extent{-1, f * step, min((f + 1) * step, size) - 1};
  }
  const int words = e.last + 1;
  if (kVec == 4) {
    for (int u = lane; u < (words + 3) >> 2; u += 32) cp_async16(slot + 4 * u, row + 4 * u);
  } else {
    for (int w = lane; w < words; w += 32) cp_async4(slot + w, row + w);
  }
  return e;
}

// The row's length once its copy has landed.
__device__ __forceinline__ int live_length(const uint32_t* slot, const Extent& e, int lane) {
  if (e.n >= 0) return e.n;
  for (int base = e.from;; base += 32) {
    const int p = base + lane;
    const unsigned pad = __ballot_sync(kFull, p > e.last || slot[p] == kPad);
    if (pad) return base + __ffs(pad) - 1;
  }
}

// `steps` steps of the merge of a and b (a before b on ties) from a[i] and
// b[j], counting the common values it meets: all of them, or (kRanked)
// those whose union rank, merge index less the common values before it
// (`seen` of them before this walk), lies below kk.  Each array is unique,
// so a common value is the one step where the heads are equal; a[|a|] and
// b[|b|] hold PAD, above every live value.
template <bool kRanked>
__device__ __forceinline__ int walk(const uint32_t* a, const uint32_t* b, int i, int j, int steps,
                                    int seen, int kk) {
  const uint32_t* pa = a + i;
  const uint32_t* pb = b + j;
  uint32_t x = *pa, y = *pb;
  int count = 0;
  for (int s = 0; s < steps; ++s) {
    const bool take_a = x <= y;
    if (kRanked) {
      const bool common = x == y;
      count += common && static_cast<int>((pa - a) + (pb - b)) - seen < kk;
      seen += common;
    } else {
      count += x == y;
    }
    pa += take_a;
    pb += !take_a;
    const uint32_t v = *(take_a ? pa : pb);
    x = take_a ? v : x;
    y = take_a ? y : v;
  }
  return count;
}

// Length of the common prefix of a[0, n) and b[0, n), by the whole warp.
__device__ __forceinline__ int common_prefix(const uint32_t* a, const uint32_t* b, int n,
                                             int lane) {
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const unsigned differ = __ballot_sync(kFull, k < n && a[k] != b[k]);
    if (differ) return base + __ffs(differ) - 1;
  }
  return n;
}

// Merge-path split of diagonal d, a before b on ties: the i in [lo, hi]
// such that a[0, i) and b[0, d - i) are the merge's first d values.
__device__ __forceinline__ int split(const uint32_t* a, int na, const uint32_t* b, int nb, int d,
                                     int lo, int hi) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Sum of v over the lanes below this one.
__device__ __forceinline__ int exclusive_sum(int v, int lane) {
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += t;
  }
  return inc - v;
}

// jq of the live prefixes a[0, na) and b[0, nb), by the whole warp.
__device__ __forceinline__ int pair_jq(const uint32_t* a, int na, const uint32_t* b, int nb,
                                       int size, int lane) {
  // a common prefix of length p merges as a[0], b[0], a[1], b[1], ...: p
  // common values, union ranks 0 ... p - 1, and the merge path runs
  // through (p, p); exact duplicates end here
  const int p = common_prefix(a, b, min(na, nb), lane);
  const int total = na + nb;
  const int per = (total - 2 * p + 31) >> 5;
  const int d0 = min(2 * p + lane * per, total);
  const int d1 = min(d0 + per, total);
  int lo = split(a, na, b, nb, d0, max(p, d0 - nb), min(d0 - p, na));
  const int common = walk<false>(a, b, lo, d0 - lo, d1 - d0, 0, 0);
  int before = exclusive_sum(common, lane);
  const int n_common = p + __shfl_sync(kFull, before + common, 31);
  before += p;
  const int kk = min(total - n_common, size);
  int matches = n_common;
  if (total - n_common > size) {
    // ranks rise along the merge: a slice's common values have ranks from
    // d0 - before up to d1 - before - common, and these ranges tile the
    // merge; the prefix's ranks lie below p <= S = kk.  Slices wholly
    // below kk count all their common values; the one slice that crosses
    // kk, if any, is walked again by the whole warp, 1/32 of it a lane.
    const bool starts_below = common > 0 && d0 - before < kk;
    int below = starts_below && d1 - before - common < kk ? common : 0;
    const unsigned cross = __ballot_sync(kFull, starts_below && d1 - before - common >= kk);
    if (cross) {
      const int w = __ffs(cross) - 1;
      const int s0 = __shfl_sync(kFull, d0, w), s1 = __shfl_sync(kFull, d1, w);
      const int si = __shfl_sync(kFull, lo, w), seen = __shfl_sync(kFull, before, w);
      const int sub = (s1 - s0 + 31) >> 5;
      const int e0 = min(s0 + lane * sub, s1), e1 = min(e0 + sub, s1);
      // the path runs through (si, s0 - si), so on diagonal e0 it lies
      // within e0 - s0 steps of it
      lo = split(a, na, b, nb, e0, max(si, e0 - nb), min(si + e0 - s0, na));
      const int c = walk<false>(a, b, lo, e0 - lo, e1 - e0, 0, 0);
      below += walk<true>(a, b, lo, e0 - lo, e1 - e0, seen + exclusive_sum(c, lane), kk);
    }
    matches = p + static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(below)));
  }
  return kk > 0 ? (kScale * matches + kk / 2) / kk : kScale;
}

template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    settle_kernel(const uint32_t* __restrict__ sk, int size, const int32_t* __restrict__ ia,
                  const int32_t* __restrict__ ib, int lo, int hi, int32_t* __restrict__ out,
                  int m, int chunk) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sw = slot_words(size);
  uint32_t* const slot_a = smem + 2 * warp * sw;
  uint32_t* const slot_b = slot_a + sw;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp) * chunk;
  if (first >= m) return;  // whole warps only
  const int p0 = static_cast<int>(first);
  const int p1 = static_cast<int>(first + chunk < m ? first + chunk : m);
  const int step = (size + 31) >> 5;
  if (lane == 0) {
    slot_a[size] = kPad;
    slot_b[size] = kPad;
  }

  // lane t holds the indices of pair p0 + 32k + t of the current batch k
  int batch_a = p0 + lane < p1 ? ia[p0 + lane] : 0;
  int batch_b = p0 + lane < p1 ? ib[p0 + lane] : 0;
  int ra = __shfl_sync(kFull, batch_a, 0), rb = __shfl_sync(kFull, batch_b, 0);
  uint32_t probe_a = probe(sk + static_cast<int64_t>(ra) * size, size, step, lane);
  uint32_t probe_b = probe(sk + static_cast<int64_t>(rb) * size, size, step, lane);
  int held_a = -1, na = 0;

  for (int p = p0; p < p1; ++p) {
    const bool new_a = ra != held_a;
    Extent ea{0, 0, 0};
    if (new_a) {
      ea = copy_live<kVec>(slot_a, sk + static_cast<int64_t>(ra) * size, size, step, probe_a, lane);
    }
    const Extent eb =
        copy_live<kVec>(slot_b, sk + static_cast<int64_t>(rb) * size, size, step, probe_b, lane);
    // the next pair's indices and probe words, in flight while this merges
    int next_a = ra, next_b = rb;
    if (p + 1 < p1) {
      const int t = (p + 1 - p0) & 31;
      if (t == 0) {
        batch_a = p + 1 + lane < p1 ? ia[p + 1 + lane] : 0;
        batch_b = p + 1 + lane < p1 ? ib[p + 1 + lane] : 0;
      }
      next_a = __shfl_sync(kFull, batch_a, t);
      next_b = __shfl_sync(kFull, batch_b, t);
      if (next_a != ra) probe_a = probe(sk + static_cast<int64_t>(next_a) * size, size, step, lane);
      probe_b = probe(sk + static_cast<int64_t>(next_b) * size, size, step, lane);
    }
    cp_async_wait_all();
    __syncwarp();
    if (new_a) {
      na = live_length(slot_a, ea, lane);
      held_a = ra;
    }
    const int nb = live_length(slot_b, eb, lane);
    const int jq = pair_jq(slot_a, na, slot_b, nb, size, lane);
    if (lane == 0) {
      out[p] = jq;
      out[m + p] = jq >= lo && jq < hi ? -1 : (jq >= hi ? 1 : 0);
    }
    __syncwarp();  // every lane is done with the slots before the next copy
    ra = next_a;
    rb = next_b;
  }
}

template <int kVec>
int launch(const uint32_t* sk, int size, const int32_t* ia, const int32_t* ib, int lo, int hi,
           int32_t* out, int m, cudaStream_t stream) {
  const int per_warp = 2 * slot_words(size) * static_cast<int>(sizeof(uint32_t));
  const int warps = std::min(kWarps, kSmemOptin / per_warp);
  const int smem = warps * per_warp;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(settle_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, settle_kernel<kVec>,
                                                           warps * 32, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // every resident warp gets a contiguous run of `chunk` pairs
  const int64_t resident = static_cast<int64_t>(sms) * std::max(per_sm, 1) * warps;
  const int64_t chunk = (m + resident - 1) / resident;
  const int64_t busy = (m + chunk - 1) / chunk;
  const int grid = static_cast<int>((busy + warps - 1) / warps);
  settle_kernel<kVec><<<grid, warps * 32, smem, stream>>>(sk, size, ia, ib, lo, hi, out, m,
                                                          static_cast<int>(chunk));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The widest sketch astt_rerank_settle takes.
int astt_rerank_max_sketch() { return kMaxSketch; }

// sk uint32[n_sk, size] (rows as above), ia/ib int32[m] in [0, n_sk), the
// margin band [lo, hi) -> out int32[2, m]: jq, then the verdict.  Launches
// nothing for m == 0.
int astt_rerank_settle(const void* sk, int size, const void* ia, const void* ib, int lo, int hi,
                       void* out, long long m, void* stream) {
  if (m <= 0) return 0;
  if (size < 1 || size > kMaxSketch || m > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* rows = static_cast<const uint32_t*>(sk);
  const auto* a = static_cast<const int32_t*>(ia);
  const auto* b = static_cast<const int32_t*>(ib);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(m);
  if (size % 4 == 0 && reinterpret_cast<uintptr_t>(sk) % 16 == 0) {
    return launch<4>(rows, size, a, b, lo, hi, o, n, s);
  }
  return launch<1>(rows, size, a, b, lo, hi, o, n, s);
}

const char* astt_rerank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
