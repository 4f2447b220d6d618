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
// Bound: the fold reads the text once and does about 2k + 10 integer
// operations a shingle (the k-step FNV loop, fmix32, the bin, the min), so
// it is bound by the issue of its integer instructions, not by bytes: the
// ALU pipe (the FNV xors, the byte extracts, fmix32's shifts and xors, the
// bin) at 64 lanes an SM a clock, the FMA pipe (the FNV and fmix32
// multiplies) at 64, the MIO pipe (global loads, shared atomics) at 32;
// every byte extract and address add on top of the 2k + 10 counts.
// oph_probe.py reads the hash loop's SASS per shingle and pipe.  Densify
// reads and writes 4P bytes a row and is bound by memory.
//
// Design of the fold:
// - A warp walks a contiguous range of units (descriptors; in the tile
//   modes, row pieces) and keeps one P-entry minimum table in dynamic
//   shared memory across consecutive units of the same owner.  It flushes
//   the hit bins into running[owner, :] with a global atomicMin (its
//   return value unused: a reduction) only when the owner changes and at
//   the end of its range, then resets them.  An article's segments are
//   consecutive descriptors, so most articles flush once; the atomics
//   stay because an owner can span two ranges, two launches or an OOM
//   halving.  Owners outside [0, n_out) are dropped and not hashed.
// - Ranges: the units split into at most kRangesPerWarp ranges per
//   resident warp (a grid of whole ranges; the block scheduler balances
//   the blocks), so a warp's work is a few descriptors of at most kMaxSeg
//   shingles each, whatever one article's length.  The tile modes cut each
//   row into pieces sized so that one tile's pieces fill every resident
//   warp (at least kMinPiece shingles, a multiple of a warp's run): a
//   64-row tile still reaches all 132 SMs, and one launch a tile stays.
// - Word loads: lane l hashes kLaneShingles consecutive shingles at a
//   time.  It reads the aligned 32-bit words that cover their bytes
//   (kLaneShingles + k - 1 of them, at any residue of the text),
//   funnel-shifts them into a byte stream in registers and takes each byte
//   with one PRMT, mask or shift: half a load a shingle where a byte load
//   a byte was.  In a unit
//   whose words could reach outside the text (the segment mode) or past
//   the tile's last row (the tile modes), such words are read byte by
//   byte, guarded; every other unit reads without a check.  The width
//   k = 5 is compiled in; any other k (to kMaxK) keeps a byte loop.
// - Shared minimum: every shingle takes the shared atomicMin, without
//   return.  A filter (read the bin, take the atomic only when below it:
//   exact, as the table only falls) costs more issue slots than the
//   atomics it saves, its read, compare and divergent branch about five a
//   shingle against one (oph_probe.py's variant `filter`).
// - densify: one warp per row.  Lane l holds bins l, l+32, ... (four at
//   P = 128); one __ballot_sync per 32 bins gives the row's filled mask,
//   kept in shared memory; each empty bin finds its nearest filled bin to
//   the right with find-first-set over the mask words, wrapping once.
//
// Launches go on the caller's stream and allocate nothing.  Each entry
// point returns cudaGetLastError() after its launch.
//
// Built with ASTT_CHECK_BOUNDS defined (oph_probe.py --checked), every
// unguarded word load and every byte load of the hash loop first tests its
// address against [text, text + text_len) (in the tile modes, the tile's
// rows end there) and traps outside it.  The shipped build leaves it
// undefined: ASTT_CHECK then compiles to nothing.

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

constexpr int kWarps = 8;                  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSeg = 2048;              // most shingles in one segment
constexpr int kMaxK = 64;                  // widest shingle
constexpr int kMaxBins = 1024;             // most bins (P)
constexpr int kMaxWords = kMaxBins / 32;   // densify's mask words a row
constexpr int kLaneShingles = 8;           // consecutive shingles a lane hashes at a time
constexpr int kWarpRun = 32 * kLaneShingles;
constexpr int kRangesPerWarp = 4;          // ranges of units per resident warp
constexpr int kMinPiece = 256;             // fewest shingles in a tile piece
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;
constexpr uint32_t kDensifyC = 0x9E3779B1u;

static_assert(kLaneShingles % 4 == 0, "a lane's shingles start on one word residue");
static_assert(kMaxSeg % kWarpRun == 0 && kMinPiece <= kMaxSeg, "tile pieces");

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

  void plan(int64_t) {}

  __device__ __forceinline__ Unit get(int64_t u, int64_t text_len, int k) const {
    Unit x{start[u], shingles[u], owner[u]};
    if (x.off < 0 || x.n > kMaxSeg || x.off + x.n + k - 1 > text_len) x.n = 0;
    return x;
  }
};

// fold and sig: `pieces` units of `piece` shingles per row of a [rows,
// width] tile, row-major; owners is null for sig (owner = row).
struct TileUnits {
  const int32_t* __restrict__ lengths;
  const int32_t* __restrict__ owners;
  int rows;
  int width;
  int most;  // shingles of a full row (at least 1)
  int piece;
  int pieces;
  int64_t count;

  // Pieces such that the tile's rows fill `fit` warps: at least
  // kMinPiece shingles, a multiple of a warp's run, at most kMaxSeg.
  void plan(int64_t fit) {
    int64_t p = static_cast<int64_t>(rows) * most / (fit > 0 ? fit : 1);
    if (p < kMinPiece) p = kMinPiece;
    p = (p + kWarpRun - 1) / kWarpRun * kWarpRun;
    piece = static_cast<int>(p < kMaxSeg ? p : kMaxSeg);
    pieces = (most + piece - 1) / piece;
    count = static_cast<int64_t>(rows) * pieces;
  }

  __device__ __forceinline__ Unit get(int64_t u, int64_t, int k) const {
    const int row = static_cast<int>(u / pieces);
    const int s0 = static_cast<int>(u % pieces) * piece;
    const int len = min(max(lengths[row], 0), width);
    const int n = min(piece, len - (k - 1) - s0);
    return Unit{static_cast<int64_t>(row) * width + s0, max(n, 0),
                owners ? owners[row] : row};
  }
};

// Fold hash h into its bin's minimum.
__device__ __forceinline__ void bin_min(uint32_t* table, uint32_t h, int shift) {
  atomicMin(table + (h >> shift), h);
}

// Byte m of the stream of words s, zero-extended.
template <int kM>
__device__ __forceinline__ uint32_t stream_byte(const uint32_t* s) {
  if constexpr (kM % 4 == 0) return s[kM / 4] & 0xFFu;
  else if constexpr (kM % 4 == 3) return s[kM / 4] >> 24;
  else return __byte_perm(s[kM / 4], 0, 0x4440 + kM % 4);  // one PRMT
}

// FNV-1a over stream bytes kJ .. kJ + kK - 1, then fmix32.
template <int kJ, int kK, int kM = kJ>
__device__ __forceinline__ uint32_t stream_hash(const uint32_t* s, uint32_t h = kFnvOffset) {
  if constexpr (kM == kJ + kK) return fmix32(h);
  else return stream_hash<kJ, kK, kM + 1>(s, (h ^ stream_byte<kM>(s)) * kFnvPrime);
}

// hash_words' shingles kJ .. kLaneShingles - 1 of the stream s.
template <int kK, bool kFull, int kJ = 0>
__device__ __forceinline__ void hash_stream(const uint32_t* s, int valid, uint32_t* table,
                                            int shift) {
  if constexpr (kJ < kLaneShingles) {
    if (kFull || kJ < valid) bin_min(table, stream_hash<kJ, kK>(s), shift);
    hash_stream<kK, kFull, kJ + 1>(s, valid, table, shift);
  }
}

// The 4-aligned word at w of the bytes [lo, hi), bytes outside it as 0.
__device__ __forceinline__ uint32_t guarded_word(const uint8_t* w, const uint8_t* lo,
                                                 const uint8_t* hi) {
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (w + b >= lo && w + b < hi) x |= static_cast<uint32_t>(__ldg(w + b)) << (8 * b);
  return x;
}

// The aligned word i of base, read without a guard.
__device__ __forceinline__ uint32_t word_at(const uint8_t* base, int i, const uint8_t* lo,
                                            const uint8_t* hi) {
  ASTT_CHECK(base + 4 * i >= lo && base + 4 * i + 4 <= hi);
  return __ldg(reinterpret_cast<const uint32_t*>(base) + i);
}

// Words a lane reads from its first shingle's aligned word on: its bytes
// end at most 3 + kLaneShingles + kK - 2 bytes past that word's start.
template <int kK>
__host__ __device__ constexpr int lane_words() { return kLaneShingles / 4 + (kK + 5) / 4; }

// The kWords aligned words of a lane's run from base on; with kGuard,
// each word that reaches outside [lo, hi) byte by byte.
template <int kK, bool kGuard>
__device__ __forceinline__ void load_words(uint32_t* w, const uint8_t* base, const uint8_t* lo,
                                           const uint8_t* hi) {
#pragma unroll
  for (int i = 0; i < lane_words<kK>(); ++i)
    w[i] = kGuard && (base + 4 * i < lo || base + 4 * i + 4 > hi)
               ? guarded_word(base + 4 * i, lo, hi)
               : word_at(base, i, lo, hi);
}

// A lane's kLaneShingles consecutive shingles from the words w, starting
// a bytes into them, of which the first `valid` (all with kFull) are
// hashed into the table: the words funnel-shifted into a byte stream.
template <int kK, bool kFull>
__device__ __forceinline__ void hash_words(const uint32_t* w, int a, int valid, uint32_t* table,
                                           int shift) {
  uint32_t s[lane_words<kK>() - 1];  // the run's bytes 4i .. 4i + 3
#pragma unroll
  for (int i = 0; i < lane_words<kK>() - 1; ++i) s[i] = __funnelshift_r(w[i], w[i + 1], 8 * a);
  hash_stream<kK, kFull>(s, valid, table, shift);
}

// The n shingles from src into the warp's table: whole runs of 32 lanes,
// then the tail; lane l takes shingles l * kLaneShingles + (0 ..
// kLaneShingles - 1) of each run.  kK > 0 reads words, kK == 0 bytes.
template <int kK, bool kGuard>
__device__ __forceinline__ void hash_runs(const uint8_t* __restrict__ src, int n, int k,
                                          int lane, const uint8_t* lo, const uint8_t* hi,
                                          uint32_t* table, int shift) {
  const uint8_t* p = src + lane * kLaneShingles;
  int i = 0;
  if constexpr (kK > 0) {
    const int a = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);  // warp-uniform
    const uint8_t* base = p - a;
    uint32_t w[lane_words<kK>()];
    for (; i + kWarpRun <= n; i += kWarpRun) {
      load_words<kK, kGuard>(w, base + i, lo, hi);
      hash_words<kK, true>(w, a, kLaneShingles, table, shift);
    }
    const int valid = n - i - lane * kLaneShingles;
    if (valid > 0) {
      load_words<kK, kGuard>(w, base + i, lo, hi);
      hash_words<kK, false>(w, a, valid, table, shift);
    }
  } else {
    for (; i < n; i += kWarpRun) {
      const int valid = min(n - i - lane * kLaneShingles, kLaneShingles);
      for (int j = 0; j < valid; ++j) {
        uint32_t h = kFnvOffset;
        for (int m = j; m < j + k; ++m) {
          ASTT_CHECK(p + i + m >= lo && p + i + m < hi);
          h = (h ^ __ldg(p + i + m)) * kFnvPrime;
        }
        bin_min(table, fmix32(h), shift);
      }
    }
  }
}

// The unit's n shingles at text[off] into the warp's table.  Its words
// reach from 3 bytes before it to lane_words past its last run; a unit
// whose words all lie in the text runs without guards (all but the
// text's first and last few).
template <int kK>
__device__ __forceinline__ void hash_unit(const uint8_t* __restrict__ text, int64_t text_len,
                                          int64_t off, int n, int k, int lane, uint32_t* table,
                                          int shift) {
  const uint8_t* hi = text + text_len;
  if constexpr (kK > 0) {
    const int64_t reach = (n + kWarpRun - 1) / kWarpRun * kWarpRun + 4 * lane_words<kK>();
    if (off < 3 || off + reach > text_len) {
      hash_runs<kK, true>(text + off, n, k, lane, text, hi, table, shift);
      return;
    }
  }
  hash_runs<kK, false>(text + off, n, k, lane, text, hi, table, shift);
}

// The table's hit bins into out[owner, :], and the table emptied.
__device__ __forceinline__ void flush(uint32_t* table, uint32_t* __restrict__ out, int owner,
                                      int bins, int lane) {
  __syncwarp();
  uint32_t* row = out + static_cast<size_t>(owner) * bins;
  for (int j = lane; j < bins; j += 32) {
    const uint32_t v = table[j];
    if (v != kEmpty) {
      atomicMin(row + j, v);
      table[j] = kEmpty;
    }
  }
  __syncwarp();
}

template <class Units, int kK>
__global__ void __launch_bounds__(kThreads)
oph_fold_kernel(const uint8_t* __restrict__ text, int64_t text_len, Units units, int64_t span,
                int k, int bins, int shift, uint32_t* __restrict__ out, int n_out) {
  extern __shared__ uint32_t tables[];  // [kWarps][bins]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * span;
  if (first >= units.count) return;
  uint32_t* table = tables + warp * bins;
  for (int j = lane; j < bins; j += 32) table[j] = kEmpty;
  __syncwarp();

  const int64_t end = min(units.count, first + span);
  int owner = -1;  // whose minima the table holds
  for (int64_t u = first; u < end; ++u) {
    const Unit x = units.get(u, text_len, k);  // warp-uniform
    if (x.n <= 0 || x.owner < 0 || x.owner >= n_out) continue;
    if (x.owner != owner) {
      if (owner >= 0) flush(table, out, owner, bins, lane);
      owner = x.owner;
    }
    hash_unit<kK>(text, text_len, x.off, x.n, k, lane, table, shift);
  }
  if (owner >= 0) flush(table, out, owner, bins, lane);
}

template <class Units, int kK>
int launch_k(const uint8_t* text, int64_t text_len, Units units, int k, int bins, int shift,
             void* out, int n_out, void* stream) {
  const size_t smem = sizeof(uint32_t) * kWarps * bins;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, oph_fold_kernel<Units, kK>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fit = static_cast<int64_t>(max(per_sm, 1)) * sms * kWarps;  // resident warps
  units.plan(fit);
  if (units.count <= 0) return 0;
  const int64_t want = units.count < fit * kRangesPerWarp ? units.count : fit * kRangesPerWarp;
  const int64_t span = (units.count + want - 1) / want;
  const int64_t ranges = (units.count + span - 1) / span;
  const int grid = static_cast<int>((ranges + kWarps - 1) / kWarps);
  oph_fold_kernel<Units, kK><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      text, text_len, units, span, k, bins, shift, static_cast<uint32_t*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

int bin_shift(int bins) {  // 32 - log2(bins), or -1 when bins is not 2..kMaxBins, a power of two
  if (bins < 2 || bins > kMaxBins || (bins & (bins - 1))) return -1;
  int bits = 0;
  while ((1 << bits) < bins) ++bits;
  return 32 - bits;
}

// k = 5, the configured shingle width, reads words; any other k bytes.
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
  return TileUnits{lengths, owners, rows, width, most, 0, 0, rows};  // plan() cuts the rows
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

// The fold's walk: consecutive shingles a lane hashes at a time, ranges of
// units per resident warp, fewest shingles in a tile piece.
int astt_oph_lane_shingles() { return kLaneShingles; }
int astt_oph_ranges_per_warp() { return kRangesPerWarp; }
int astt_oph_min_tile_piece() { return kMinPiece; }

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
