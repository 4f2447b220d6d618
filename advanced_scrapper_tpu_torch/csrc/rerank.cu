// Quantized bottom-sketch Jaccard of sketch pairs, by hand for Hopper
// (sm_90a): the rerank tier's settle.
//
// Replaces the reference's jnp settle step,
// advanced_scrapper_tpu/ops/rerank.py:_pair_jq under vmap in
// make_rerank_tile_step, which sorts the concatenation of the pair's two
// sketches.  There is no Pallas original; XLA fuses that sort, where
// PyTorch would build a [pairs, 2S] int64 intermediate (1 GiB at 65,536
// pairs and S = 1,024) before its own scratch.
//
// Input: sk uint32[n_sk, S], each row sorted ascending, its live hashes
// unique and none equal to PAD, then PAD up to S (ops/rerank.py:
// bottom_sketch builds exactly this); ia, ib int32[m] row indices.
// Output: jq int32[m], bit-equal to _pair_jq(sk[ia], sk[ib], S):
//
//   n_uni   = |a| + |b| - |a∩b|          (|a| = lower bound of PAD in a)
//   kk      = min(n_uni, S)
//   matches = the common values whose rank in the union is < kk
//   jq      = kk > 0 ? (SCALE * matches + kk / 2) / kk : SCALE
//
// Both rows are sorted and unique, so no sort is needed: a common value
// a[i] has union rank i + lower_bound(b, a[i]) - (common values below it).
//
// Design (simple first; this PR does not make it fast): one 128-thread
// block per pair stages both rows in shared memory (8 KiB at S = 1,024),
// each thread binary-searches its contiguous chunk of a's live values in
// b and counts the common ones, a block prefix sum gives each chunk the
// common values below it, a second pass counts the matches, and thread 0
// does the one integer division.
//
// Bound: the bytes are each participating sketch's live values and its
// first PAD read once plus 8 bytes of indices and 4 of output per pair;
// the operations are |a| + |b| comparison steps per pair (a merge of the
// live values) at the INT32 rate.  The bytes bound is the larger at the
// tier's shapes.  This kernel reads both full rows of every pair (mostly
// from L2) and does log2(S) steps per value, twice.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// two rows of uint32 beside the two scans' warp sums (static shared memory)
// in the 48 KiB of shared memory a block gets by default
constexpr int kMaxSketch =
    (48 * 1024 - 2 * kWarps * sizeof(int)) / (2 * sizeof(uint32_t));
constexpr int kScale = 10000;
constexpr uint32_t kPad = 0xFFFFFFFFu;

__device__ __forceinline__ int lower_bound(const uint32_t* v, int n, uint32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Exclusive prefix sum over the block of one int per thread; *total gets
// the block's sum.  `sums` is kWarps ints of shared memory used by no other
// call in flight.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + inc - v;
}

__global__ void __launch_bounds__(kThreads)
    settle_kernel(const uint32_t* __restrict__ sk, int size,
                  const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
                  int32_t* __restrict__ jq) {
  extern __shared__ uint32_t rows[];  // a, then b: size values each
  __shared__ int common_sums[kWarps];
  __shared__ int match_sums[kWarps];
  const int pair = blockIdx.x;
  const uint32_t* ga = sk + static_cast<int64_t>(ia[pair]) * size;
  const uint32_t* gb = sk + static_cast<int64_t>(ib[pair]) * size;
  uint32_t* a = rows;
  uint32_t* b = rows + size;
  for (int i = threadIdx.x; i < size; i += kThreads) {
    a[i] = ga[i];
    b[i] = gb[i];
  }
  __syncthreads();
  const int na = lower_bound(a, size, kPad);
  const int nb = lower_bound(b, size, kPad);
  const int chunk = (size + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * chunk, na);
  const int hi = min(lo + chunk, na);

  int common = 0;
  for (int i = lo; i < hi; ++i) {
    const int j = lower_bound(b, nb, a[i]);
    common += j < nb && b[j] == a[i];
  }
  int n_common;
  int below = block_exclusive_scan(common, common_sums, &n_common);
  const int kk = min(na + nb - n_common, size);

  int matches = 0;
  for (int i = lo; i < hi; ++i) {
    const int j = lower_bound(b, nb, a[i]);
    if (j < nb && b[j] == a[i]) {
      matches += i + j - below < kk;
      ++below;
    }
  }
  int n_matches;
  block_exclusive_scan(matches, match_sums, &n_matches);
  if (threadIdx.x == 0) {
    jq[pair] = kk > 0 ? (kScale * n_matches + kk / 2) / kk : kScale;
  }
}

}  // namespace

extern "C" {

// The widest sketch astt_rerank_settle takes.
int astt_rerank_max_sketch() { return kMaxSketch; }

// sk uint32[n_sk, size] (rows as above), ia/ib int32[m] in [0, n_sk) ->
// jq int32[m].  Launches nothing for m == 0.
int astt_rerank_settle(const void* sk, int size, const void* ia, const void* ib,
                       void* jq, long long m, void* stream) {
  if (m <= 0) return 0;
  if (size < 1 || size > kMaxSketch || m > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  settle_kernel<<<static_cast<unsigned>(m), kThreads,
                  2 * size * sizeof(uint32_t),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sk), size, static_cast<const int32_t*>(ia),
      static_cast<const int32_t*>(ib), static_cast<int32_t*>(jq));
  return static_cast<int>(cudaGetLastError());
}

const char* astt_rerank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
