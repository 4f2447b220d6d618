// MinHash signatures of k-byte shingles, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// advanced_scrapper_tpu/ops/pallas_minhash.py:_minhash_kernel, and with it
// the body of the reference's fused tile step
// (advanced_scrapper_tpu/ops/minhash.py:make_fused_tile_step): unpack the
// packed tile, hash every k-byte shingle (rolling FNV-1a, then murmur3's
// fmix32), apply 128 permutations a*h + b mod 2^32, take the minimum over
// the row's valid shingles, and fold it into the running per-article
// accumulator by owner.
//
// Bound: two 32-bit integer operations per (shingle, permutation) -- the
// multiply-add and the unsigned min -- against about one byte read per
// shingle, so the kernel is bound by integer throughput, not by memory.
// IMAD issues on the FMA pipe at 64 lanes per SM per clock and IMNMX on the
// ALU pipe at another 64, so at 132 SMs and 1980 MHz one H100 does about
// 1.7e13 shingle-permutations per second.
//
// Design: one block of 128 threads per row, one thread per permutation, so
// each thread keeps its a, b and running minimum in registers.  The row is
// walked in chunks of kChunk shingles: its bytes are staged in shared
// memory, the block hashes the chunk cooperatively into shared memory, and
// every thread then reads each hash as a broadcast (four at a time) and
// folds it into its minimum.  Positions past the row's length are never
// read, so a short row in a wide bucket costs only its own shingles.  The
// fold form writes no [rows, 128] signature to device memory: each thread
// does one atomicMin on the owner's row, native for unsigned int.  The TPU
// kernel's sequential grid, VMEM scratch and sign-flipped minima were TPU
// constraints and are not carried over.
//
// Launches go on the caller's stream and allocate nothing.  Each entry
// point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPerm = 128;      // permutations = threads per block
constexpr int kChunk = 2048;    // shingles staged per pass
constexpr int kMaxK = 64;       // widest shingle the staging buffer holds
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t umin32(uint32_t x, uint32_t y) {
  return y < x ? y : x;
}

// kFold == false: out is uint32[rows, 128], one signature per row.
// kFold == true:  out is the accumulator uint32[n_out, 128]; row r folds
//                 into out[owners[r]] (rows with an owner outside
//                 [0, n_out) are dropped, as segment_min drops them).
template <bool kFold>
__global__ void __launch_bounds__(kPerm)
minhash_kernel(const uint8_t* __restrict__ tokens,
               const int32_t* __restrict__ lengths,
               const int32_t* __restrict__ owners, int width, int k,
               const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int n_out) {
  __shared__ uint8_t bytes[kChunk + kMaxK];
  __shared__ __align__(16) uint32_t hashes[kChunk];

  const int row = blockIdx.x;
  const int p = threadIdx.x;
  const uint8_t* src = tokens + static_cast<size_t>(row) * width;
  const int len = min(max(lengths[row], 0), width);
  const int n_valid = max(len - (k - 1), 0);
  const uint32_t ap = a[p];
  const uint32_t bp = b[p];
  uint32_t m = 0xFFFFFFFFu;

  for (int base = 0; base < n_valid; base += kChunk) {
    const int n = min(kChunk, n_valid - base);
    for (int i = p; i < n + k - 1; i += kPerm) bytes[i] = src[base + i];
    __syncthreads();
    for (int i = p; i < n; i += kPerm) {
      uint32_t h = kFnvOffset;
      for (int j = 0; j < k; ++j) h = (h ^ bytes[i + j]) * kFnvPrime;
      hashes[i] = fmix32(h);
    }
    __syncthreads();
    int i = 0;
    for (; i + 4 <= n; i += 4) {
      const uint4 h4 = *reinterpret_cast<const uint4*>(&hashes[i]);
      m = umin32(m, ap * h4.x + bp);
      m = umin32(m, ap * h4.y + bp);
      m = umin32(m, ap * h4.z + bp);
      m = umin32(m, ap * h4.w + bp);
    }
    for (; i < n; ++i) m = umin32(m, ap * hashes[i] + bp);
    __syncthreads();  // the next chunk overwrites bytes and hashes
  }

  if constexpr (kFold) {
    if (n_valid == 0) return;  // all-U32_MAX: the min identity
    const int owner = owners[row];
    if (owner < 0 || owner >= n_out) return;
    atomicMin(out + static_cast<size_t>(owner) * kPerm + p, m);
  } else {
    out[static_cast<size_t>(row) * kPerm + p] = m;
  }
}

}  // namespace

extern "C" {

// tokens uint8[rows, width], lengths int32[rows] -> out uint32[rows, 128].
int astt_minhash_sig(const void* tokens, const void* lengths, int rows,
                     int width, int k, const void* a, const void* b, void* out,
                     void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > kMaxK || width < k) return static_cast<int>(cudaErrorInvalidValue);
  minhash_kernel<false><<<rows, kPerm, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tokens), static_cast<const int32_t*>(lengths),
      nullptr, width, k, static_cast<const uint32_t*>(a),
      static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// packed uint8[rows * (width + 8)] (tokens, then lengths and owners as
// int32 planes; see ops/pack.py) folded into running uint32[n_out, 128].
int astt_minhash_fold(const void* packed, int rows, int width, int k,
                      const void* a, const void* b, void* running, int n_out,
                      void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > kMaxK || width < k) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* base = static_cast<const uint8_t*>(packed);
  const size_t tok_bytes = static_cast<size_t>(rows) * width;
  const int32_t* lengths = reinterpret_cast<const int32_t*>(base + tok_bytes);
  minhash_kernel<true><<<rows, kPerm, 0, static_cast<cudaStream_t>(stream)>>>(
      base, lengths, lengths + rows, width, k, static_cast<const uint32_t*>(a),
      static_cast<const uint32_t*>(b), static_cast<uint32_t*>(running), n_out);
  return static_cast<int>(cudaGetLastError());
}

const char* astt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
