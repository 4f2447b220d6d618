// MinHash signatures of k-byte shingles, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// advanced_scrapper_tpu/ops/pallas_minhash.py:_minhash_kernel, and with it
// the body of the reference's fused tile step
// (advanced_scrapper_tpu/ops/minhash.py:make_fused_tile_step): hash every
// k-byte shingle (rolling FNV-1a, then murmur3's fmix32), apply 128
// permutations a*h + b mod 2^32, take the unsigned minimum over the
// shingles, and fold it into a per-article accumulator by owner.
//
// Bound: two 32-bit integer operations per (shingle, permutation) -- the
// multiply-add and the unsigned min -- against about one byte read per
// shingle, so the kernel is bound by integer issue, not by memory.  IMAD
// issues on the FMA pipe at 64 lanes per SM per clock and IMNMX on the ALU
// pipe at another 64, so at 132 SMs and 1980 MHz one H100 does about
// 1.7e13 shingle-permutations per second.  Every other instruction in the
// inner loop takes an issue slot from that bound.
//
// Work unit: a segment, a run of at most kMaxSeg shingles of one article,
// read from the bytes where they lie, with its k-1 trailing bytes.  The
// minimum over an article's segments is the minimum over its shingles, so
// any cut of an article into segments gives its signature.  Three
// addressing modes share one kernel template:
//   fold_segments  segments given by (start, shingles, owner) descriptors
//                  into one flat text (the engine's main path);
//   fold           the rows of a packed tile (ops/pack.py), owner per row;
//   sig            the rows of a [rows, width] tile, owner = row.
// A tile row longer than kMaxSeg shingles is several segments.
//
// Design:
// - One warp per segment, in a persistent grid of about (SMs x resident
//   blocks) blocks of kWarps warps; each warp strides over the segments.
//   Segments are short and even, so no wave ends half empty and no warp
//   waits on a long row; there is no block-wide barrier, only __syncwarp.
// - Four permutations per lane (l, l+32, l+64, l+96): a, b and the running
//   minima live in registers, loaded once per warp, and give four
//   independent min chains per lane.
// - Staging: the warp copies the segment's bytes into its slice of shared
//   memory with 16-byte loads from the 16-byte-aligned address below the
//   segment's start (keeping the shift), and byte loads only for a word
//   that straddles an end of the text.
// - Hashing: each round every lane hashes kRound/32 shingles from the
//   staged bytes (the byte loop unrolled for k = 5, the configured width)
//   into a double-buffered slice of kRound hashes (a lane past
//   the segment's end hashes its last shingle again; the minimum does not
//   change).  Then every lane reads the hashes back as 16-byte broadcast
//   loads: one LDS.128 feeds 16 (shingle, permutation) pairs.  ptxas
//   turns the group into 16 IMAD, 12 VIMNMX/VIMNMX3 (the three-input min
//   takes two of the bound's operations) and the LDS.128: 29 instructions
//   for 32 operations of the bound.
// - Fold: four atomicMin per lane on the owner's row, each warp-wide one
//   128 contiguous bytes; the return value is unused, so they compile to
//   reductions.  Owners outside [0, n_out) are dropped, as segment_min
//   drops them, and their segments are not hashed.
// The TPU kernel's sequential grid, VMEM scratch, static [B, L] tiles and
// sign-flipped minima were TPU constraints and are not carried over.
//
// Where the rest of the time goes (ops/minhash_probe.py times variants of
// this file; numbers in PERF.md): the min loop alone, without hashing or
// the group loads, stays short of the bound; the hashing and the LDS.128
// of each group cost the rest.  Occupancy, unrolling, the round size, the
// segment size, the kind of min and a register-free b move it little, and
// eight permutations per lane (half-warps on half-rounds) is slower.
//
// Launches go on the caller's stream and allocate nothing.  Each entry
// point returns cudaGetLastError() after its launch.
//
// Built with ASTT_CHECK_BOUNDS defined (oph_probe.py --checked), each
// 16-byte word load of the text tests its address against [text, text +
// text_len), each unit's staged words against the warp's stage, and each
// hash its staged bytes against the unit's words; a failed test traps.
// The shipped build leaves it undefined: ASTT_CHECK compiles to nothing.

#include <cstdint>
#include <cuda_runtime.h>

#ifdef ASTT_CHECK_BOUNDS
#define ASTT_CHECK(cond) \
  do {                   \
    if (!(cond)) __trap(); \
  } while (0)
#else
#define ASTT_CHECK(cond) \
  do {                   \
  } while (0)
#endif

namespace {

constexpr int kPerm = 128;                 // permutations
constexpr int kLanePerms = kPerm / 32;     // permutations per lane
constexpr int kWarps = 8;                  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 6;              // resident blocks per SM asked of ptxas
constexpr int kMaxSeg = 2048;              // most shingles in one segment
constexpr int kMaxK = 64;                  // widest shingle
constexpr int kRound = 64;                 // shingles hashed per round
constexpr int kStageWords = (15 + kMaxSeg + kMaxK - 1 + 15) / 16;
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
__device__ __forceinline__ uint32_t shingle_hash(const uint8_t* p, int k) {
  uint32_t h = kFnvOffset;
  if constexpr (kK > 0) {
#pragma unroll
    for (int j = 0; j < kK; ++j) h = (h ^ p[j]) * kFnvPrime;
  } else {
    for (int j = 0; j < k; ++j) h = (h ^ p[j]) * kFnvPrime;
  }
  return fmix32(h);
}

template <class Units, int kK>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
minhash_fold_kernel(const uint8_t* __restrict__ text, int64_t text_len,
                    Units units, int k, const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                    int n_out) {
  __shared__ __align__(16) uint4 stage_all[kWarps][kStageWords];
  __shared__ __align__(16) uint32_t hash_all[kWarps][2 * kRound];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint4* stage_words = stage_all[warp];
  const uint8_t* stage = reinterpret_cast<const uint8_t*>(stage_words);
  uint32_t* hashes = hash_all[warp];

  uint32_t ap[kLanePerms], bp[kLanePerms];
#pragma unroll
  for (int q = 0; q < kLanePerms; ++q) {
    ap[q] = a[lane + 32 * q];
    bp[q] = b[lane + 32 * q];
  }
  const uintptr_t text_lo = reinterpret_cast<uintptr_t>(text);
  const uintptr_t text_hi = text_lo + static_cast<uintptr_t>(text_len);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int parity = 0;

  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       u < units.count; u += stride) {
    const Unit x = units.get(u, text_len, k);  // warp-uniform
    if (x.n <= 0 || x.owner < 0 || x.owner >= n_out) continue;

    // stage the unit's bytes, from the 16-byte word at or below its start
    const uintptr_t src = text_lo + static_cast<uintptr_t>(x.off);
    const uintptr_t base = src & ~static_cast<uintptr_t>(15);
    const int shift = static_cast<int>(src - base);
    const int words = (shift + x.n + k - 1 + 15) >> 4;
    ASTT_CHECK(words <= kStageWords);
    for (int w = lane; w < words; w += 32) {
      const uintptr_t p = base + 16 * static_cast<uintptr_t>(w);
      uint4 v;
      if (p >= text_lo && p + 16 <= text_hi) {
        ASTT_CHECK(p >= text_lo && p + 16 <= text_hi);
        v = __ldg(reinterpret_cast<const uint4*>(p));
      } else {  // a word that straddles an end of the text
        uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (p + j >= text_lo && p + j < text_hi) {
            wv[j >> 2] |= static_cast<uint32_t>(
                               *reinterpret_cast<const uint8_t*>(p + j))
                          << (8 * (j & 3));
          }
        }
        v = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      }
      stage_words[w] = v;
    }
    __syncwarp();

    uint32_t m[kLanePerms];
#pragma unroll
    for (int q = 0; q < kLanePerms; ++q) m[q] = 0xFFFFFFFFu;
    for (int r0 = 0; r0 < x.n; r0 += kRound) {
      const int nr = min(kRound, x.n - r0);
      uint32_t* slot = hashes + parity * kRound;
      parity ^= 1;
#pragma unroll
      for (int t = 0; t < kRound / 32; ++t) {
        const int i = r0 + min(32 * t + lane, nr - 1);
        ASTT_CHECK(i >= 0 && shift + i + k <= 16 * words);
        slot[32 * t + lane] = shingle_hash<kK>(stage + shift + i, k);
      }
      __syncwarp();
      const uint4* h4 = reinterpret_cast<const uint4*>(slot);
      const int groups = (nr + 3) >> 2;
#pragma unroll 4
      for (int g = 0; g < groups; ++g) {
        const uint4 h = h4[g];
#pragma unroll
        for (int q = 0; q < kLanePerms; ++q) {
          const uint32_t lo = umin32(ap[q] * h.x + bp[q], ap[q] * h.y + bp[q]);
          const uint32_t hi = umin32(ap[q] * h.z + bp[q], ap[q] * h.w + bp[q]);
          m[q] = umin32(m[q], umin32(lo, hi));
        }
      }
    }

    uint32_t* row = out + static_cast<size_t>(x.owner) * kPerm + lane;
#pragma unroll
    for (int q = 0; q < kLanePerms; ++q) atomicMin(row + 32 * q, m[q]);
    __syncwarp();  // the next unit overwrites the staged bytes
  }
}

// Persistent grid: as many blocks as fit on the card at once, fewer when
// there are fewer units than warps.
template <class Units, int kK>
int launch_k(const uint8_t* text, int64_t text_len, const Units& units, int k,
             const void* a, const void* b, void* out, int n_out, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, minhash_fold_kernel<Units, kK>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (units.count + kWarps - 1) / kWarps;
  const int64_t fit = static_cast<int64_t>(max(per_sm, 1)) * sms;
  const int grid = static_cast<int>(want < fit ? want : fit);
  minhash_fold_kernel<Units, kK><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      text, text_len, units, k, static_cast<const uint32_t*>(a),
      static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

// k = 5, the configured shingle width, hashes with its byte loop unrolled.
template <class Units>
int launch(const uint8_t* text, int64_t text_len, const Units& units, int k,
           const void* a, const void* b, void* out, int n_out, void* stream) {
  if (units.count <= 0 || n_out <= 0) return 0;
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 5) return launch_k<Units, 5>(text, text_len, units, k, a, b, out, n_out, stream);
  return launch_k<Units, 0>(text, text_len, units, k, a, b, out, n_out, stream);
}

TileUnits tile_units(const int32_t* lengths, const int32_t* owners, int rows,
                     int width, int k) {
  const int most = width - k + 1 > 1 ? width - k + 1 : 1;
  const int pieces = (most + kMaxSeg - 1) / kMaxSeg;
  return TileUnits{lengths, owners, width, pieces,
                   static_cast<int64_t>(rows) * pieces};
}

}  // namespace

extern "C" {

// The most shingles one segment of astt_minhash_fold_segments may hold.
int astt_max_segment_shingles() { return kMaxSeg; }

// tokens uint8[rows, width], lengths int32[rows] -> out uint32[rows, 128],
// which the caller fills with 0xFFFFFFFF first.
int astt_minhash_sig(const void* tokens, const void* lengths, int rows,
                     int width, int k, const void* a, const void* b, void* out,
                     void* stream) {
  if (rows <= 0) return 0;
  if (width < k) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const uint8_t*>(tokens),
                static_cast<int64_t>(rows) * width,
                tile_units(static_cast<const int32_t*>(lengths), nullptr, rows,
                           width, k),
                k, a, b, out, rows, stream);
}

// packed uint8[rows * (width + 8)] (tokens, then lengths and owners as
// int32 planes; see ops/pack.py) folded into running uint32[n_out, 128].
int astt_minhash_fold(const void* packed, int rows, int width, int k,
                      const void* a, const void* b, void* running, int n_out,
                      void* stream) {
  if (rows <= 0) return 0;
  if (width < k) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* tokens = static_cast<const uint8_t*>(packed);
  const int64_t tok_bytes = static_cast<int64_t>(rows) * width;
  const int32_t* lengths = reinterpret_cast<const int32_t*>(tokens + tok_bytes);
  return launch(tokens, tok_bytes,
                tile_units(lengths, lengths + rows, rows, width, k), k, a, b,
                running, n_out, stream);
}

// Segments (seg_start int64[n_seg] byte offsets into text uint8[text_len],
// seg_shingles int32[n_seg] <= kMaxSeg, seg_owner int32[n_seg]) folded into
// running uint32[n_out, 128].
int astt_minhash_fold_segments(const void* text, long long text_len,
                               const void* seg_start, const void* seg_shingles,
                               const void* seg_owner, long long n_seg, int k,
                               const void* a, const void* b, void* running,
                               int n_out, void* stream) {
  const SegmentUnits units{static_cast<const int64_t*>(seg_start),
                           static_cast<const int32_t*>(seg_shingles),
                           static_cast<const int32_t*>(seg_owner),
                           static_cast<int64_t>(n_seg)};
  return launch(static_cast<const uint8_t*>(text),
                static_cast<int64_t>(text_len), units, k, a, b, running, n_out,
                stream);
}

const char* astt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
