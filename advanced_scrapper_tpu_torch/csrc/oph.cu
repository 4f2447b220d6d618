// One-permutation MinHash (OPH), by hand for Hopper (sm_90a).
//
// Replaces the reference's jnp OPH on the device,
// advanced_scrapper_tpu/ops/oph.py: _raw_impl (one lax.sort of each padded
// [B, S] tile of shingle hashes plus a searchsorted per bin) and densify
// (seven rounds of pointer doubling with jnp.roll).  The reference has no
// Pallas kernel for either; the port's card path folds ragged article
// segments straight from a chunk's text, where no padded tile exists to
// sort, so both are written here.
//
// oph_fold: hash every k-byte shingle (rolling FNV-1a, then murmur3's
// fmix32, as csrc/minhash.cu does), take bin = h >> (32 - log2 P), and
// fold the unsigned minimum of each bin into the owner's row of a running
// uint32[n_out, P] accumulator, whose empty bins hold 0xFFFFFFFF.  The
// minimum of a bin does not depend on how it is found, so this equals the
// reference's sort form bit for bit, and any cut of an article into
// segments gives its raw signature.  Three addressing modes share the
// kernel template, as in csrc/minhash.cu:
//   fold_segments  segments given by (start, shingles, owner) descriptors
//                  into one flat text (the engine's main path);
//   fold           the rows of a packed tile (ops/pack.py), owner per row;
//   sig            the rows of a [rows, width] tile, owner = row.
//
// oph_densify: rotation densification with distance offsetting on
// uint32[B, P]: each empty bin takes the value v of the nearest filled bin
// to its right (circularly) at distance d, as v + d * 0x9E3779B1 mod 2^32;
// an all-empty row stays all 0xFFFFFFFF.  The reference's pointer doubling
// computes exactly this nearest distance.
//
// Bound: the fold reads the text once and does about 3k + 8 integer
// operations a shingle (the k-step FNV loop, fmix32, the shift and the
// shared-memory min), a few hundred times fewer than the dense kernel's
// 256 a shingle; at the engine's article sizes it is bound by the bytes
// of text (and, per segment, by the P atomics of its flush).  Densify
// reads and writes 4P bytes a row and is bound by memory.
//
// Design (simple first; being right is the bar of this kernel):
// - fold: one warp per unit in a persistent grid of kWarps-warp blocks.
//   Each warp owns a P-entry minimum table in dynamic shared memory,
//   reset to 0xFFFFFFFF; lane l hashes shingles l, l+32, ... reading the
//   bytes from global memory (neighbouring lanes read neighbouring bytes)
//   and takes a shared atomicMin into the table; then each lane flushes
//   its entries l, l+32, ... that were hit with a global atomicMin into
//   running[owner, :] (its return value unused: a reduction) and resets
//   them.  Owners outside [0, n_out) are dropped and not hashed.
// - densify: one warp per row.  Lane l holds bins l, l+32, ... (four at
//   P = 128); one __ballot_sync per 32 bins gives the row's filled mask,
//   kept in shared memory; each empty bin finds its nearest filled bin to
//   the right with find-first-set over the mask words, wrapping once.
//
// Launches go on the caller's stream and allocate nothing.  Each entry
// point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSeg = 2048;              // most shingles in one segment
constexpr int kMaxK = 64;                  // widest shingle
constexpr int kMaxBins = 1024;             // most bins (P)
constexpr int kMaxWords = kMaxBins / 32;   // densify's mask words a row
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;
constexpr uint32_t kDensifyC = 0x9E3779B1u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// A unit's bytes start at text + off and hold n shingles (n + k - 1 bytes).
struct Unit {
  int64_t off;
  int n;
  int owner;
};

// fold_segments: one unit per descriptor.  A descriptor that does not lie
// inside the text yields no shingle (the wrapper rejects it beforehand).
struct SegmentUnits {
  const int64_t* __restrict__ start;
  const int32_t* __restrict__ shingles;
  const int32_t* __restrict__ owner;
  int64_t count;

  __device__ __forceinline__ Unit get(int64_t u, int64_t text_len, int k) const {
    Unit x{start[u], shingles[u], owner[u]};
    if (x.off < 0 || x.n > kMaxSeg || x.off + x.n + k - 1 > text_len) x.n = 0;
    return x;
  }
};

// fold and sig: `pieces` units per row of a [rows, width] tile; owners is
// null for sig (owner = row).
struct TileUnits {
  const int32_t* __restrict__ lengths;
  const int32_t* __restrict__ owners;
  int width;
  int pieces;
  int64_t count;

  __device__ __forceinline__ Unit get(int64_t u, int64_t, int k) const {
    const int row = static_cast<int>(u / pieces);
    const int s0 = static_cast<int>(u % pieces) * kMaxSeg;
    const int len = min(max(lengths[row], 0), width);
    const int n = min(kMaxSeg, len - (k - 1) - s0);
    return Unit{static_cast<int64_t>(row) * width + s0, max(n, 0),
                owners ? owners[row] : row};
  }
};

// kK > 0: the shingle width fixed at compile time (the loop unrolls);
// kK == 0: the width k given at run time.
template <int kK>
__device__ __forceinline__ uint32_t shingle_hash(const uint8_t* __restrict__ p, int k) {
  uint32_t h = kFnvOffset;
  if constexpr (kK > 0) {
#pragma unroll
    for (int j = 0; j < kK; ++j) h = (h ^ __ldg(p + j)) * kFnvPrime;
  } else {
    for (int j = 0; j < k; ++j) h = (h ^ __ldg(p + j)) * kFnvPrime;
  }
  return fmix32(h);
}

template <class Units, int kK>
__global__ void __launch_bounds__(kThreads)
oph_fold_kernel(const uint8_t* __restrict__ text, int64_t text_len, Units units,
                int k, int bins, int shift, uint32_t* __restrict__ out, int n_out) {
  extern __shared__ uint32_t tables[];  // [kWarps][bins]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* table = tables + warp * bins;
  for (int j = lane; j < bins; j += 32) table[j] = kEmpty;
  __syncwarp();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       u < units.count; u += stride) {
    const Unit x = units.get(u, text_len, k);  // warp-uniform
    if (x.n <= 0 || x.owner < 0 || x.owner >= n_out) continue;
    const uint8_t* src = text + x.off;
    for (int i = lane; i < x.n; i += 32) {
      const uint32_t h = shingle_hash<kK>(src + i, k);
      atomicMin(table + (h >> shift), h);
    }
    __syncwarp();
    uint32_t* row = out + static_cast<size_t>(x.owner) * bins;
    for (int j = lane; j < bins; j += 32) {
      const uint32_t v = table[j];
      if (v != kEmpty) {
        atomicMin(row + j, v);
        table[j] = kEmpty;
      }
    }
    __syncwarp();  // the next unit starts from an empty table
  }
}

template <class Units, int kK>
int launch_k(const uint8_t* text, int64_t text_len, const Units& units, int k,
             int bins, int shift, void* out, int n_out, void* stream) {
  const size_t smem = sizeof(uint32_t) * kWarps * bins;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, oph_fold_kernel<Units, kK>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (units.count + kWarps - 1) / kWarps;
  const int64_t fit = static_cast<int64_t>(max(per_sm, 1)) * sms;
  const int grid = static_cast<int>(want < fit ? want : fit);
  oph_fold_kernel<Units, kK><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      text, text_len, units, k, bins, shift, static_cast<uint32_t*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

int bin_shift(int bins) {  // 32 - log2(bins), or -1 when bins is not 2..kMaxBins, a power of two
  if (bins < 2 || bins > kMaxBins || (bins & (bins - 1))) return -1;
  int bits = 0;
  while ((1 << bits) < bins) ++bits;
  return 32 - bits;
}

// k = 5, the configured shingle width, hashes with its byte loop unrolled.
template <class Units>
int launch(const uint8_t* text, int64_t text_len, const Units& units, int k,
           int bins, void* out, int n_out, void* stream) {
  const int shift = bin_shift(bins);
  if (shift < 0 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (units.count <= 0 || n_out <= 0) return 0;
  if (k == 5) return launch_k<Units, 5>(text, text_len, units, k, bins, shift, out, n_out, stream);
  return launch_k<Units, 0>(text, text_len, units, k, bins, shift, out, n_out, stream);
}

TileUnits tile_units(const int32_t* lengths, const int32_t* owners, int rows,
                     int width, int k) {
  const int most = width - k + 1 > 1 ? width - k + 1 : 1;
  const int pieces = (most + kMaxSeg - 1) / kMaxSeg;
  return TileUnits{lengths, owners, width, pieces,
                   static_cast<int64_t>(rows) * pieces};
}

// Distance (1..bins-1) from empty bin b to the nearest filled bin to its
// right, circularly, over the row's filled mask (words of 32 bins); 0 when
// the row has no filled bin.
__device__ __forceinline__ int next_filled(const uint32_t* masks, int words,
                                           int bins, int b) {
  const int q = b >> 5, l = b & 31;
  const uint32_t above = l == 31 ? 0u : masks[q] & (0xFFFFFFFFu << (l + 1));
  if (above) return 32 * q + __ffs(above) - 1 - b;
  for (int t = 1; t <= words; ++t) {  // t == words: this word again, wrapped
    const int qq = (q + t) % words;
    const uint32_t w = masks[qq];
    if (w) return (32 * qq + __ffs(w) - 1 - b + bins) % bins;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
oph_densify_kernel(const uint32_t* __restrict__ sig, int rows, int bins,
                   uint32_t* __restrict__ out) {
  __shared__ uint32_t mask_all[kWarps][kMaxWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* masks = mask_all[warp];
  const int words = (bins + 31) >> 5;
  for (int r = blockIdx.x * kWarps + warp; r < rows; r += gridDim.x * kWarps) {
    const uint32_t* in = sig + static_cast<size_t>(r) * bins;
    uint32_t* dst = out + static_cast<size_t>(r) * bins;
    for (int q = 0; q < words; ++q) {
      const int b = 32 * q + lane;
      const uint32_t v = b < bins ? in[b] : kEmpty;
      const uint32_t m = __ballot_sync(0xFFFFFFFFu, v != kEmpty);
      if (lane == 0) masks[q] = m;
    }
    __syncwarp();
    for (int q = 0; q < words; ++q) {
      const int b = 32 * q + lane;
      if (b >= bins) continue;
      uint32_t v = in[b];
      if (v == kEmpty) {
        const int d = next_filled(masks, words, bins, b);
        if (d) v = in[(b + d) % bins] + static_cast<uint32_t>(d) * kDensifyC;
      }
      dst[b] = v;
    }
    __syncwarp();  // the next row overwrites the mask
  }
}

}  // namespace

extern "C" {

// The most shingles one segment of astt_oph_fold_segments may hold, and
// the most bins.
int astt_oph_max_segment_shingles() { return kMaxSeg; }
int astt_oph_max_bins() { return kMaxBins; }

// tokens uint8[rows, width], lengths int32[rows] -> out uint32[rows, bins],
// which the caller fills with 0xFFFFFFFF first.
int astt_oph_sig(const void* tokens, const void* lengths, int rows, int width,
                 int k, int bins, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (width < k) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const uint8_t*>(tokens),
                static_cast<int64_t>(rows) * width,
                tile_units(static_cast<const int32_t*>(lengths), nullptr, rows,
                           width, k),
                k, bins, out, rows, stream);
}

// packed uint8[rows * (width + 8)] (tokens, then lengths and owners as
// int32 planes; see ops/pack.py) folded into running uint32[n_out, bins].
int astt_oph_fold(const void* packed, int rows, int width, int k, int bins,
                  void* running, int n_out, void* stream) {
  if (rows <= 0) return 0;
  if (width < k) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* tokens = static_cast<const uint8_t*>(packed);
  const int64_t tok_bytes = static_cast<int64_t>(rows) * width;
  const int32_t* lengths = reinterpret_cast<const int32_t*>(tokens + tok_bytes);
  return launch(tokens, tok_bytes,
                tile_units(lengths, lengths + rows, rows, width, k), k, bins,
                running, n_out, stream);
}

// Segments (seg_start int64[n_seg] byte offsets into text uint8[text_len],
// seg_shingles int32[n_seg] <= kMaxSeg, seg_owner int32[n_seg]) folded into
// running uint32[n_out, bins].
int astt_oph_fold_segments(const void* text, long long text_len,
                           const void* seg_start, const void* seg_shingles,
                           const void* seg_owner, long long n_seg, int k,
                           int bins, void* running, int n_out, void* stream) {
  const SegmentUnits units{static_cast<const int64_t*>(seg_start),
                           static_cast<const int32_t*>(seg_shingles),
                           static_cast<const int32_t*>(seg_owner),
                           static_cast<int64_t>(n_seg)};
  return launch(static_cast<const uint8_t*>(text),
                static_cast<int64_t>(text_len), units, k, bins, running, n_out,
                stream);
}

// sig uint32[rows, bins] -> out uint32[rows, bins], densified.
int astt_oph_densify(const void* sig, int rows, int bins, void* out, void* stream) {
  if (bin_shift(bins) < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = (rows + kWarps - 1) / kWarps;
  const int fit = 16 * sms;
  oph_densify_kernel<<<want < fit ? want : fit, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sig), rows, bins, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* astt_oph_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
