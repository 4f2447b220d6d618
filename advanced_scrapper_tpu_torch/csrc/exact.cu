// The exact 128-bit hash of ExactDedup's grouping tier, by hand for Hopper
// (sm_90a).
//
// Replaces the jnp device code of advanced_scrapper_tpu/ops/exact.py:
// _block_hash_impl (:126) under ExactHasher.hash_docs (:61) and
// _row_hash_impl (:147) under ExactHasher.__call__ (:57).  There is no Pallas
// original; the port ran both as int64 products in row chunks, a lane at a
// time, then index_add_.  For document d and lane j in 0..3:
//
//   h[d, j] = fmix32((sum_i coef[i, j] * x[d, i] mod 2^32)
//                    ^ fmix32(mixlen[d] * 0x9E3779B9) ^ j * 0x85EBCA77)
//
// where i runs over the span[d] bytes at text[starts[d]] and coef is
// ExactHasher's per-lane stream, interleaved as uint32[cols, 4].  The stream
// is prefix-consistent, so the reference's block p, dotted with the stream at
// p * block_len, is the stream at each byte's offset in its document: the
// kernel reads ragged documents straight from one joined buffer and builds no
// blocks, as minhash_fold_segments reads chunk text.  The row form dots all L
// columns of a padded row (bytes past its length count when not zero) and
// mixes its length: the caller passes span = L and mixlen = lengths[b].  The
// arithmetic is uint32 and wraps mod 2^32 as the reference's uint32 sums do;
// that addition is associative, so any order of the sum gives the same bits.
//
// Bound, at the grouping tier's shape (262,144 urls of ~49 bytes): the text
// (~13 MB), 16 bytes of descriptors and 16 of hash a document: bytes, a few
// microseconds at 3.35 TB/s; 4 multiply-adds a byte are fewer.  What bounds
// this design is the instructions a document costs (descriptors, its bytes,
// the reduction, the mix) against the SMs' issue rate.
//
// Design:
// - A warp a document, a persistent grid of 8-warp blocks striding over the
//   documents; 4 lane sums in registers, a shuffle reduction, one lane mixes
//   and writes the document's 16 bytes.  The warp loads the next document's
//   descriptors before it sums this one.
// - A lane a byte: lane l takes positions l, l + 32, ..., so a warp's loads
//   of text (32 bytes) and of coefficients (512 bytes) are each contiguous,
//   and all 32 lanes work on a 49-byte url.  A first design took 16 bytes a
//   lane with one 16-byte load: on urls 30 of the 32 lanes sat idle while
//   two lanes walked 16 positions each (0.186 ms on an H100 at the tier's
//   shape, against 0.077 for this design).
// - The stream's first positions (up to kPrefixMax, as far as the longest
//   span needs) sit in shared memory, 16 bytes a position; a quarter warp
//   reads 8 consecutive positions, 128 contiguous bytes, so no bank
//   conflict.  Positions past the prefix are read through L1/L2, so a
//   document of up to MAX_DOC_LEN (4 MiB) stays right: its warp loops over
//   it, 32 bytes a step, four steps' loads in flight.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// the most stream positions held in shared memory (16 KiB)
constexpr int kPrefixMax = 1024;
constexpr uint32_t kLenMul = 0x9E3779B9u;
constexpr uint32_t kLaneSalt = 0x85EBCA77u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

struct Sums {
  uint32_t s0, s1, s2, s3;
};

__device__ __forceinline__ void mad(Sums& s, uint32_t x, uint4 c) {
  s.s0 += x * c.x;
  s.s1 += x * c.y;
  s.s2 += x * c.z;
  s.s3 += x * c.w;
}

__device__ __forceinline__ uint4 coef_at(const uint4* sm, int pre, const uint4* coef, int64_t i) {
  return i < pre ? sm[i] : __ldg(coef + i);
}

__global__ void __launch_bounds__(kThreads)
    exact_hash_kernel(const uint8_t* __restrict__ text, int64_t text_len,
                      const int64_t* __restrict__ starts, const int32_t* __restrict__ span,
                      const uint32_t* __restrict__ mixlen, const uint4* __restrict__ coef,
                      int64_t cols, int pre, int n, uint4* __restrict__ out) {
  extern __shared__ uint4 sm[];
  for (int i = threadIdx.x; i < pre; i += kThreads) {
    sm[i] = i < cols ? coef[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t d = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int64_t next_start = 0;
  int32_t next_span = 0;
  uint32_t next_mix = 0;
  if (d < n) {
    next_start = starts[d];
    next_span = span[d];
    next_mix = mixlen[d];
  }
  for (; d < n; d += stride) {
    const int64_t st = next_start;
    const int32_t sp = next_span;
    const uint32_t mix = next_mix;
    if (d + stride < n) {  // the next document's descriptors, in flight during this one
      next_start = starts[d + stride];
      next_span = span[d + stride];
      next_mix = mixlen[d + stride];
    }
    // Clamped to the buffer and the stream: memory safety only (a caller
    // that states its bounds keeps every document inside both).
    const int64_t start = lmin(st > 0 ? st : 0, text_len);
    const int64_t len = lmin(lmin(sp > 0 ? sp : 0, cols), text_len - start);
    const uint8_t* p = text + start;
    Sums s{0u, 0u, 0u, 0u};
#pragma unroll 4
    for (int64_t i = lane; i < len; i += 32) mad(s, p[i], coef_at(sm, pre, coef, i));
    s.s0 = __reduce_add_sync(0xFFFFFFFFu, s.s0);
    s.s1 = __reduce_add_sync(0xFFFFFFFFu, s.s1);
    s.s2 = __reduce_add_sync(0xFFFFFFFFu, s.s2);
    s.s3 = __reduce_add_sync(0xFFFFFFFFu, s.s3);
    if (lane == 0) {
      const uint32_t lm = fmix32(mix * kLenMul);
      out[d] = make_uint4(fmix32(s.s0 ^ lm), fmix32(s.s1 ^ lm ^ kLaneSalt),
                          fmix32(s.s2 ^ lm ^ (2u * kLaneSalt)),
                          fmix32(s.s3 ^ lm ^ (3u * kLaneSalt)));
    }
  }
}

}  // namespace

extern "C" {

// text uint8[text_len]; starts int64[n], span int32[n] (the bytes dotted),
// mixlen uint32[n] (the length mixed in); coef uint32[cols, 4], 16-byte
// aligned; max_span the longest span (sizes the shared prefix) -> out
// uint32[n, 4], 16-byte aligned.  Launches nothing for n == 0.
int astt_exact_hash(const void* text, long long text_len, const void* starts, const void* span,
                    const void* mixlen, const void* coef, long long cols, long long max_span,
                    int n, void* out, void* stream) {
  if (n < 0 || text_len < 0 || cols < 0 || max_span < 0 ||
      reinterpret_cast<uintptr_t>(coef) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long need = std::min(max_span, cols);
  const int pre = static_cast<int>(std::min<long long>(kPrefixMax, (need + 15) / 16 * 16));
  const int smem = pre * static_cast<int>(sizeof(uint4));
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exact_hash_kernel, kThreads,
                                                           smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long resident = static_cast<long long>(sms) * std::max(per_sm, 1);
  const int grid = static_cast<int>(std::min<long long>(resident, (n + kWarps - 1) / kWarps));
  exact_hash_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), text_len, static_cast<const int64_t*>(starts),
      static_cast<const int32_t*>(span), static_cast<const uint32_t*>(mixlen),
      static_cast<const uint4*>(coef), cols, pre, n, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* astt_exact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
