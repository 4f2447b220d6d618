// The LSH epilogues by hand for Hopper (sm_90a): band keys, the candidate
// stage's sort and run heads, edge verification and component labels.
//
// Replaces the jnp device code of advanced_scrapper_tpu/ops/lsh.py, which
// XLA fuses into one dispatch (fused_resolve_epilogue, :376) and which the
// port ran as ~100 PyTorch launches with [B, 8, P] int32 transients:
//   lsh_keys       fused_keys_epilogue (:416), band_keys (:56),
//                  band_keys_wide (:68), _coarse_fine_keys (:332),
//                  _fold_bands (:39);
//   lsh_sort       the lax.sort((key, row), num_keys=2) of
//                  _run_head_per_band (:104);
//   lsh_run_heads  _run_head_per_band (:87), duplicate_rep_bands (:158);
//   lsh_verify     resolve_rep_bands (:192), fine_edge_thresholds (:514),
//                  borderline_edge_mask (:462), _fine_only_chunks (:439);
//   lsh_label      _label_components (:251).
// None of them is a Pallas kernel; the plain versions are in
// advanced_scrapper_tpu_torch/ops/lsh.py and the kernels are bit-equal to
// them.
//
// What bounds them on the card, at the main path's shapes (B = 65,536
// rows, P = 128, 16 coarse + 32 fine key sets, nc = 144 candidates):
// - lsh_keys reads 32 MiB of signatures and writes 25 MiB of int64 keys
//   and 25 MiB of packed sort keys: bytes (~25 us at 3.35 TB/s).  A block
//   takes a tile of kKeyRows consecutive rows (one contiguous span of the
//   signatures), loads it into shared memory with 16-byte loads at a row
//   pitch of an odd number of 16-byte words (so the lanes of a quarter warp,
//   one row each, read distinct banks), and each warp folds key sets with
//   its 32 lanes over the tile's rows: FNV-1a over the band's words in
//   order, XOR the salt, fmix32, all uint32 with wrap-around.  The salts
//   travel in the launch's parameter buffer (a 2 KiB struct by value).
//   Lanes over rows make each band's packed keys ((key << row_bits) | row)
//   one contiguous 256-byte store; the keys are staged in shared memory
//   (uint32, an odd row pitch) and written out as one contiguous span with
//   16-byte stores.  A signature that is not 16-byte aligned, a P or band
//   width no multiple of 4 loads words at an odd pitch; a tile that does
//   not fit a block's shared memory folds from global memory (the general
//   paths, bit-equal too).  pack_keys (the packing alone, from keys already
//   made) stages a tile of rows' keys the same way and writes each band's
//   packed keys contiguously.
// - lsh_sort sorts each band's packed keys (key << row_bits) | row.  Only
//   the 32 key bits carry order: the rows enter ascending, so a stable LSD
//   radix sort of the key's digits (kSortPasses passes of kRadixBits) gives
//   the (key, row) order of torch.sort and of the reference.  One launch
//   counts every pass's digits of every band (the counts do not depend on
//   the order); then a launch a pass over every band at once (onesweep): a
//   block takes the next tile of its band by ticket, each warp ranks its
//   items stably (a ballot a digit bit within a round of 32, a
//   warp-private counter a digit across rounds), the block publishes its
//   digit counts and sums the earlier tiles' by a decoupled look-back, then
//   stages its tile in digit order in shared memory and writes each
//   digit's run out contiguously.  Each pass reads and writes the int64
//   keys once, 25 MiB each way, mostly in the 50 MB L2; the passes are
//   bound by the ranking's latency at 3 blocks an SM (80 registers).
// - lsh_run_heads reads the sorted keys once and writes int32[B, 3 nbt]:
//   bytes.  Runs can be long (all padding rows share one U32_MAX run), so
//   no thread walks a run: a block takes a tile of 512 sorted positions
//   and a block-wide max-scan of run starts gives every position its run
//   start.  A tile whose first key continues the previous tile's run finds
//   the run's start by a 256-way search of the positions before it (a load
//   a thread a round, two rounds at 65,536 rows), not by a serial binary
//   search.  The three candidates of a position go to its row, which the
//   sort scattered: one 8-byte record a (band, row) (three 21-bit rows; 16
//   bytes past 2^21 rows), written only where the three differ (the rest
//   are (row, row, row), which the records' all-ones start already says),
//   then a second launch transposes the records of 64 rows through shared
//   memory into their contiguous 64 x 3 nbt int32 of the output, in place
//   of three scattered int32 writes a position (9.4 M at this shape); the
//   scattered records are what is left of the cost.  A row's 3 nbt + 1
//   int32 must fit the 48 KiB tile: at most 4,095 bands.
// - lsh_verify gathers the candidate rows' signatures from the 32 MiB
//   signature matrix, which stays in the 50 MB L2: a warp a row.  It
//   compacts the row's non-self, in-range candidates with match_any and a
//   ballot, each distinct candidate once (a pair shares many bands: 98.7%
//   of the main corpus's non-self columns repeat a candidate of their row),
//   and counts two candidates at a time, 16 lanes each, a lane holding 8
//   words of the row's own signature in registers (loaded at the row's
//   first candidate) and loading the candidate's with 16-byte loads.  The
//   row's coarse keys, in the fine mode, are held in registers too.  With
//   the repeats gone the gather is small; what bounds it is each row's
//   walk of its 144 columns, so it runs at 8 blocks an SM (32 registers).
//   The agreement is count / P in float32 (__fdiv_rn, no fast math)
//   against the bar in float32, as the reference compares.  A P that is
//   no multiple of 64 (or above 512, or a signature not 16-byte aligned)
//   takes a general path in the same kernel: a candidate a warp, a lane a
//   word.
// - lsh_label runs the reference's rounds (pull the min along ok edges,
//   scatter-min it back, pointer-double) in two launches whatever the
//   rounds.  The first, a warp a row, reads rep and ok once (the bytes
//   bound; kLabelGroups groups of 32 columns' loads issued together, for
//   enough bytes in flight) and compacts each row's distinct, in-range, ok
//   candidates other than itself (match_any and a ballot, as lsh_verify)
//   into the row's list in scratch sized for every column distinct: 98.7%
//   of the main corpus's non-self columns repeat a candidate of their row,
//   and min is idempotent, so the lists give the reference's labels with
//   an atomic an edge in place of one a column.  It also sets x = z0 =
//   arange(B).  The second is one cooperative launch (a grid no larger
//   than can be co-resident) that runs every round, a grid sync between
//   the pull and the jump and after the jump: the pull reads x and
//   atomicMins into z (z starts as x, which every value written is at
//   most), the jump reads z and writes x and the next round's z, so nothing
//   is read from a buffer being written and truncated rounds give the
//   reference's labels.  A round that changed nothing ends the loop: each
//   later round would change nothing either.  Buffers written inside the
//   launch are read through L2 (__ldcg), never the non-coherent path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;
constexpr uint32_t kWideOffset = 0xCBF29CE4u;  // ops/lsh.py WIDE_OFFSET
constexpr uint32_t kWidePrime = 0x01000197u;   // ops/lsh.py WIDE_PRIME
constexpr int64_t kU32Max = 0xFFFFFFFFLL;
constexpr int kMaxSalts = 512;
constexpr int kThreads = 256;
constexpr int kHeadItems = 2;
constexpr int kHeadTile = kThreads * kHeadItems;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = kThreads / 32;
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kSortPasses = (32 + kRadixBits - 1) / kRadixBits;
constexpr int kSortItems = 16;
constexpr int kSortTile = kThreads * kSortItems;
constexpr int kDigitCopies = 2;    // copies of the digit counts in shared memory
constexpr int kRecBits = 21;       // 8-byte run-head records where rows fit 21 bits
constexpr int kStageRows = 64;
constexpr int kStageInts = 12288;  // 48 KiB of shared memory: the transpose's tile
constexpr int kMaxHeadBands = (kStageInts - 1) / 3;  // 4,095: a row's 3 nbt + 1 fit the tile
constexpr int kSub = 16;           // lanes a candidate in lsh_verify
constexpr int kVerifyChunk = 192;  // columns compacted at a time
constexpr int kKeyRows = 32;       // rows a keys tile: a warp's lanes
constexpr size_t kMaxBlockSmem = 232448;  // shared memory a block may opt in to (227 KiB)
constexpr int kLabelLaunches = 2;  // astt_lsh_label: the edge lists, then the rounds
constexpr int kLabelGroups = 6;    // groups of 32 columns a label_edges_kernel warp loads at once

struct Salts {
  uint32_t v[kMaxSalts];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// ---- lsh_keys ----------------------------------------------------------

// How a keys tile reads its rows' words: 16-byte words from shared memory,
// 4-byte words from shared memory, or straight from global memory (a tile
// that does not fit a block's shared memory).
enum KeysLoad { kLoadGlobal = 0, kLoadWords = 1, kLoadVec = 2 };

// uint32 words of a keys tile's staged keys: kKeyRows rows of ncol | 1
// (an odd pitch: the lanes, a row each, store to distinct banks), rounded
// up to 16 bytes so the signature tile after them stays aligned.
inline __host__ __device__ int key_stage_words(int ncol) {
  return (kKeyRows * (ncol | 1) + 3) & ~3;
}

// r words from w in order, FNV-1a from k with prime (w in shared or global
// memory).
__device__ __forceinline__ uint32_t fold(const uint32_t* w, int r, uint32_t k, uint32_t prime) {
  for (int i = 0; i < r; ++i) k = (k ^ w[i]) * prime;
  return k;
}

// The same over r / 4 16-byte words of shared memory.
__device__ __forceinline__ uint32_t fold4(const uint4* w, int r4, uint32_t k, uint32_t prime) {
  for (int i = 0; i < r4; ++i) {
    const uint4 v = w[i];
    k = (k ^ v.x) * prime;
    k = (k ^ v.y) * prime;
    k = (k ^ v.z) * prime;
    k = (k ^ v.w) * prime;
  }
  return k;
}

// Block: rows [r0, r0 + kKeyRows).  The tile's signatures into shared
// memory (Load kLoadVec: pitch 16-byte words a row, P / 4 | 1 of them;
// kLoadWords: pitch words, P | 1), then warp w folds key sets w, w +
// kWarps, ..., lane l row r0 + l: sets 0..nb-1 fold P/nb words each with
// salts[j], sets nb..nb+nf-1 P/nf words with salts[j]; wide: lane 1 beside
// lane 0 (nf = 0), out int64[B, nb, 2].  With packed, each set's
// packed[j, r0 + l] = ((valid ? key : U32_MAX) << row_bits) | row in one
// contiguous store a warp; the keys staged as uint32 and written out as
// the tile's contiguous span of keys, 16 bytes a store (keys 16-byte
// aligned).
template <int Load>
__global__ void __launch_bounds__(kThreads)
keys_kernel(const uint32_t* __restrict__ sig, int B, int P, int nb, int nf, const Salts salts,
            int wide, int pitch, int64_t* __restrict__ keys, const bool* __restrict__ valid,
            int row_bits, int64_t* __restrict__ packed) {
  extern __shared__ __align__(16) uint32_t keys_smem[];
  const int nk = nb + nf, ncol = wide ? 2 * nb : nk, kp = ncol | 1;
  uint32_t* stage = keys_smem;
  uint32_t* tile = keys_smem + key_stage_words(ncol);
  const long long r0 = static_cast<long long>(blockIdx.x) * kKeyRows;
  const int nr = static_cast<int>(B - r0 < kKeyRows ? B - r0 : kKeyRows);
  const uint32_t* rows = sig + r0 * P;
  if (Load == kLoadVec) {
    const int c4 = P / 4, p4 = pitch / 4;
    const uint4* src = reinterpret_cast<const uint4*>(rows);
    uint4* dst = reinterpret_cast<uint4*>(tile);
    for (int i = threadIdx.x; i < nr * c4; i += kThreads) {
      const int r = i / c4;
      dst[r * p4 + i - r * c4] = __ldg(src + i);
    }
  } else if (Load == kLoadWords) {
    for (int i = threadIdx.x; i < nr * P; i += kThreads) {
      const int r = i / P;
      tile[r * pitch + i - r * P] = __ldg(rows + i);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = r0 + lane;
  const bool live = lane < nr;
  const bool vb = live && packed != nullptr && valid[b];
  const uint32_t* mine = Load == kLoadGlobal ? sig + b * P : tile + lane * pitch;
  for (int j = warp; j < nk && live; j += kWarps) {
    const int r = j < nb ? P / nb : P / nf;
    const int start = (j < nb ? j : j - nb) * r;
    const uint32_t salt = salts.v[j];
    uint32_t lo, hi = 0;
    if (Load == kLoadVec) {
      const uint4* w = reinterpret_cast<const uint4*>(mine + start);
      lo = fold4(w, r / 4, kFnvOffset, kFnvPrime);
      if (wide) hi = fold4(w, r / 4, kWideOffset, kWidePrime);
    } else {
      lo = fold(mine + start, r, kFnvOffset, kFnvPrime);
      if (wide) hi = fold(mine + start, r, kWideOffset, kWidePrime);
    }
    lo = fmix32(lo ^ salt);
    if (wide) {
      stage[lane * kp + 2 * j] = lo;
      stage[lane * kp + 2 * j + 1] = fmix32(hi ^ ((salt << 13) | (salt >> 19)));
      continue;
    }
    stage[lane * kp + j] = lo;
    if (packed != nullptr) {
      const int64_t k = vb ? static_cast<int64_t>(lo) : kU32Max;
      packed[static_cast<size_t>(j) * B + b] = (k << row_bits) | b;
    }
  }
  __syncthreads();
  int64_t* out = keys + r0 * ncol;
  const int n = nr * ncol;
  for (int e = 2 * threadIdx.x; e < n; e += 2 * kThreads) {
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
}

// Block: rows [r0, r0 + kKeyRows).  Their keys int64[nr, nk], one
// contiguous span, into shared memory (16-byte loads where the span is
// 16-byte aligned; a row pitch of nk | 1), then warp w writes sets w, w +
// kWarps, ... of packed[j, r0 + l] = ((valid ? key : U32_MAX) << row_bits)
// | row, lane l row r0 + l: one contiguous store a warp.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int64_t* __restrict__ keys, int B, int nk, const bool* __restrict__ valid,
            int row_bits, int64_t* __restrict__ packed) {
  extern __shared__ __align__(16) int64_t pack_smem[];
  const int kp = nk | 1;
  const long long r0 = static_cast<long long>(blockIdx.x) * kKeyRows;
  const int nr = static_cast<int>(B - r0 < kKeyRows ? B - r0 : kKeyRows);
  const int64_t* src = keys + r0 * nk;
  const int n = nr * nk;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = 2 * threadIdx.x; e < n; e += 2 * kThreads) {
      int r = e / nk, c = e - r * nk;
      if (e + 1 == n) {
        pack_smem[r * kp + c] = __ldg(src + e);
        break;
      }
      const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(src + e));
      pack_smem[r * kp + c] = v.x;
      if (++c == nk) {
        c = 0;
        ++r;
      }
      pack_smem[r * kp + c] = v.y;
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / nk;
      pack_smem[r * kp + e - r * nk] = __ldg(src + e);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane >= nr) return;  // no barrier below
  const long long b = r0 + lane;
  const bool vb = valid[b];
  for (int j = warp; j < nk; j += kWarps) {
    const int64_t k = vb ? pack_smem[lane * kp + j] : kU32Max;
    packed[static_cast<size_t>(j) * B + b] = (k << row_bits) | b;
  }
}

// The keys kernel a shape takes, its pitch and its shared memory.
struct KeysPlan {
  int load;
  int pitch;
  size_t smem;
};

inline KeysPlan keys_plan(const void* sig, int P, int nb, int nf, int wide) {
  const size_t stage = sizeof(uint32_t) * key_stage_words(wide ? 2 * nb : nb + nf);
  const bool vec = reinterpret_cast<uintptr_t>(sig) % 16 == 0 && P % 4 == 0 &&
                   (P / nb) % 4 == 0 && (nf == 0 || (P / nf) % 4 == 0);
  if (vec) {
    const int pitch = 4 * ((P / 4) | 1);
    const size_t smem = stage + sizeof(uint32_t) * kKeyRows * pitch;
    if (smem <= kMaxBlockSmem) return {kLoadVec, pitch, smem};
  }
  const int pitch = P | 1;
  const size_t smem = stage + sizeof(uint32_t) * kKeyRows * pitch;
  if (smem <= kMaxBlockSmem) return {kLoadWords, pitch, smem};
  return {kLoadGlobal, 0, stage};
}

template <int Load>
cudaError_t launch_keys(const uint32_t* sig, int B, int P, int nb, int nf, const Salts& salts,
                        int wide, int pitch, size_t smem, int64_t* keys, const bool* valid,
                        int row_bits, int64_t* packed, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      keys_kernel<Load>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  keys_kernel<Load><<<(B + kKeyRows - 1) / kKeyRows, kThreads, smem, s>>>(
      sig, B, P, nb, nf, salts, wide, pitch, keys, valid, row_bits, packed);
  return cudaGetLastError();
}

// ---- lsh_sort ---------------------------------------------------------

__device__ __forceinline__ int digit_of(int64_t v, int shift) {
  return static_cast<int>((static_cast<uint64_t>(v) >> shift) & (kBins - 1));
}

// The lanes of the warp whose d (0 .. kBins: kBins marks no digit) equals
// this lane's: a ballot a bit (the instruction match.any is slower).
__device__ __forceinline__ unsigned match_digit(int d) {
  unsigned peers = kFull;
#pragma unroll
  for (int i = 0; i <= kRadixBits; ++i) {
    const bool bit = (d >> i) & 1;
    const unsigned v = __ballot_sync(kFull, bit);
    peers &= bit ? v : ~v;
  }
  return peers;
}

// The sum of x over the block's earlier threads; every thread calls it.
__device__ int block_exclusive_sum(int x, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int y = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, y, o);
    if (lane >= o) y += t;
  }
  if (lane == 31) warp_tot[warp] = y;
  __syncthreads();
  int before = y - x;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  __syncthreads();
  return before;
}

// In place: a[0..kBins) becomes its exclusive prefix sum; every thread of
// the block calls it.  A thread takes kBins / kThreads consecutive digits
// (one, at 8-bit digits).
__device__ void block_exclusive_scan(int* a, int* warp_tot) {
  constexpr int per = kBins >= kThreads ? kBins / kThreads : 1;
  const int t = threadIdx.x;
  const bool on = t * per < kBins;
  int local[per];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < per; ++i) {
    local[i] = on ? a[t * per + i] : 0;
    sum += local[i];
  }
  int before = block_exclusive_sum(sum, warp_tot);
  if (on) {
#pragma unroll
    for (int i = 0; i < per; ++i) {
      a[t * per + i] = before;
      before += local[i];
    }
  }
  __syncthreads();
}

// Block (tile, band): the tile's digit counts of every pass, added into
// ghist[band][pass][digit] (one read of the keys for all passes).  A
// shared atomic a digit, into one of kDigitCopies copies of the counts by
// warp (a warp's equal digits still meet in one copy).
__global__ void __launch_bounds__(kThreads)
sort_digits_kernel(const int64_t* __restrict__ src, int B, int row_bits,
                   int* __restrict__ ghist) {
  constexpr int kCounts = kSortPasses * kBins;
  __shared__ int h[kDigitCopies * kCounts];
  for (int i = threadIdx.x; i < kDigitCopies * kCounts; i += kThreads) h[i] = 0;
  __syncthreads();
  const int64_t* s = src + static_cast<size_t>(blockIdx.y) * B;
  int* mine = h + ((threadIdx.x >> 5) % kDigitCopies) * kCounts;
  const long long lo = static_cast<long long>(blockIdx.x) * kSortTile;
#pragma unroll 4
  for (int i = 0; i < kSortItems; ++i) {
    const long long p = lo + static_cast<long long>(i) * kThreads + threadIdx.x;
    if (p >= B) break;
    const int64_t v = __ldg(s + p);
#pragma unroll
    for (int k = 0; k < kSortPasses; ++k) {
      atomicAdd(mine + k * kBins + digit_of(v, row_bits + k * kRadixBits), 1);
    }
  }
  __syncthreads();
  int* g = ghist + static_cast<size_t>(blockIdx.y) * kCounts;
  for (int i = threadIdx.x; i < kCounts; i += kThreads) {
    int n = 0;
#pragma unroll
    for (int c = 0; c < kDigitCopies; ++c) n += h[c * kCounts + i];
    if (n != 0) atomicAdd(g + i, n);
  }
}

constexpr size_t kScatterSmem = sizeof(int64_t) * kSortTile + sizeof(int) * (kWarps + 2) * kBins;

// A tile's published count of one digit (onesweep): the flag in the high
// word, the count in the low one, one 64-bit store
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own
constexpr unsigned long long kInclusive = 2ull << 32;  // with every earlier tile's
constexpr int kMaxSpins = 1 << 22;

__device__ __forceinline__ unsigned long long load_volatile(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_volatile(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Block (tile, band): the stable scatter of one pass.  Warp w takes the
// tile's positions [w, w + 1) x 32 kSortItems, round i its 32 positions
// from 32 i, lane l the l-th: the order of the positions is (warp, round,
// lane), and a position's rank among its digit's is the digit's start in
// the tile + the digit's count in earlier warps + in earlier rounds of its
// warp + in earlier lanes of its round.  A digit's start in the band: its
// start in the pass's band counts ofs[band][digit] (stride kSortPasses
// kBins) + the counts of the earlier tiles, found by a decoupled look-back
// over their published counts (tiles by ticket, so an earlier tile has
// started and publishes before it looks back).
__global__ void __launch_bounds__(kThreads, 3)
sort_scatter_kernel(const int64_t* __restrict__ src, int64_t* __restrict__ dst, int B, int shift,
                    int ntiles, const int* __restrict__ ofs, unsigned long long* status,
                    int* ticket) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* stage = reinterpret_cast<int64_t*>(smem);
  int* wcnt = reinterpret_cast<int*>(stage + kSortTile);  // [kWarps][kBins]
  int* dstart = wcnt + kWarps * kBins;                    // the digit's start in the tile
  int* gbase = dstart + kBins;                            // ... in the sorted band
  __shared__ int warp_tot[kWarps];
  __shared__ int tile_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t band = blockIdx.y;
  const int64_t* s = src + band * B;
  int64_t* o = dst + band * B;
  if (threadIdx.x == 0) tile_s = atomicAdd(ticket + band, 1);
  __syncthreads();
  const int tile = tile_s;
  const long long lo = static_cast<long long>(tile) * kSortTile;
  const long long base = lo + static_cast<long long>(warp) * 32 * kSortItems;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) wcnt[i] = 0;
  int64_t v[kSortItems];
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const long long p = base + 32 * i + lane;
    v[i] = p < B ? __ldg(s + p) : 0;
  }
  __syncthreads();
  int* mine = wcnt + warp * kBins;
  const unsigned lt = (1u << lane) - 1u;
  int rk[kSortItems];
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const bool in = base + 32 * i + lane < B;
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
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * kBins + d];
      wcnt[w * kBins + d] = run;
      run += c;
    }
    dstart[d] = run;
    gbase[d] = ofs[band * kSortPasses * kBins + d];
    store_volatile(status + (band * ntiles + tile) * kBins + d,
                   (tile == 0 ? kInclusive : kAggregate) | static_cast<unsigned>(run));
  }
  __syncthreads();
  block_exclusive_scan(gbase, warp_tot);
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
  block_exclusive_scan(dstart, warp_tot);
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    if (base + 32 * i + lane < B) {
      const int d = digit_of(v[i], shift);
      stage[dstart[d] + mine[d] + rk[i]] = v[i];
    }
  }
  __syncthreads();
  const int n = static_cast<int>(B - lo < kSortTile ? B - lo : kSortTile);
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int64_t val = stage[q];
    const int d = digit_of(val, shift);
    o[gbase[d] + q - dstart[d]] = val;
  }
}

// ---- lsh_run_heads ------------------------------------------------------

// A (band, row)'s record for heads_out_kernel: its head, predecessor and
// predecessor², three rows of kRecBits in one int64 (Pack) or an int4.
template <bool Pack>
struct Rec;
template <>
struct Rec<true> {
  using T = int64_t;
  __device__ static T make(int h, int p1, int p2) {
    return static_cast<int64_t>(h) | (static_cast<int64_t>(p1) << kRecBits) |
           (static_cast<int64_t>(p2) << (2 * kRecBits));
  }
  __device__ static int get(T v, int k) {
    return static_cast<int>((v >> (k * kRecBits)) & ((int64_t{1} << kRecBits) - 1));
  }
};
template <>
struct Rec<false> {
  using T = int4;
  __device__ static T make(int h, int p1, int p2) { return make_int4(h, p1, p2, 0); }
  __device__ static int get(T v, int k) { return k == 0 ? v.x : k == 1 ? v.y : v.z; }
};

// Block (tile, band): sorted int64[nbt, B] (each band ascending) -> run
// head, predecessor, predecessor² of each position's row (self where there
// is none; self for invalid rows), key = packed >> row_bits, row = packed &
// mask, as one record a (band, row) for heads_out_kernel.
template <bool Pack>
__global__ void __launch_bounds__(kThreads)
run_heads_kernel(const int64_t* __restrict__ sorted, const bool* __restrict__ valid, int B,
                 int row_bits, typename Rec<Pack>::T* __restrict__ rec) {
  const int band = blockIdx.y;
  const int64_t* s = sorted + static_cast<size_t>(band) * B;
  const int lo = blockIdx.x * kHeadTile;
  const int64_t mask = (int64_t{1} << row_bits) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ int warp_max[kWarps];
  // the run start of position lo: lo, unless its key continues the run of
  // lo - 1; then the first position of [0, lo] with its key, by a
  // kThreads-way search (a load a thread a round; the positions below the
  // key come first)
  const int64_t tkey = s[lo] >> row_bits;
  long long a = lo;
  if (lo > 0 && (s[lo - 1] >> row_bits) == tkey) {
    a = 0;
    long long z = lo;
    while (a < z) {
      const long long step = (z - a + kThreads - 1) / kThreads;
      const long long m = a + threadIdx.x * step;
      const int c = __syncthreads_count(m < z && (s[m] >> row_bits) < tkey);
      if (c == 0) {
        z = a;
      } else {
        const long long top = a + c * step;
        a += (c - 1) * step + 1;
        z = top < z ? top : z;
      }
    }
  }
  const int carry = static_cast<int>(a);
  const int p0 = lo + threadIdx.x * kHeadItems;
  int starts[kHeadItems];
  int last = -1;
  int64_t prev = p0 > 0 && p0 < B ? s[p0 - 1] >> row_bits : -1;
#pragma unroll
  for (int i = 0; i < kHeadItems; ++i) {
    const int p = p0 + i;
    if (p < B) {
      const int64_t key = s[p] >> row_bits;
      if (p == 0 || key != prev) last = p;
      prev = key;
    }
    starts[i] = last;
  }
  // block-wide exclusive max-scan of each thread's last run start
  int x = last;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) warp_max[warp] = x;
  int before = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) before = -1;
  __syncthreads();
  before = max(before, carry);
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
#pragma unroll
  for (int i = 0; i < kHeadItems; ++i) {
    const int p = p0 + i;
    if (p >= B) break;
    const int64_t v = s[p];
    const int64_t key = v >> row_bits;
    const int row = static_cast<int>(v & mask);
    int h = row, p1 = row, p2 = row;
    if (valid[row]) {
      h = static_cast<int32_t>(s[max(before, starts[i])] & mask);
      const int64_t v1 = p >= 1 ? s[p - 1] : -1;
      const int64_t v2 = p >= 2 ? s[p - 2] : -1;
      if (p >= 1 && (v1 >> row_bits) == key) p1 = static_cast<int32_t>(v1 & mask);
      if (p >= 2 && (v2 >> row_bits) == key) p2 = static_cast<int32_t>(v2 & mask);
    }
    // a record whose three rows are equal is (row, row, row): the run's
    // first row, a row alone in its run, an invalid row; the records start
    // all ones (three equal fields), so those are not written
    if (h != p1 || p1 != p2) {
      rec[static_cast<size_t>(band) * B + row] = Rec<Pack>::make(h, p1, p2);
    }
  }
}

// Block: `rows` consecutive rows.  rec[band][row] of every band into a
// shared tile of rows x (3 nbt + 1) int32 (the padding keeps the column
// writes off one bank), then the rows' 3 nbt columns out contiguously.
template <bool Pack>
__global__ void __launch_bounds__(kThreads)
heads_out_kernel(const typename Rec<Pack>::T* __restrict__ rec, int B, int nbt, int rows,
                 int32_t* __restrict__ out) {
  extern __shared__ int32_t tile_s[];
  const int nc = 3 * nbt, pitch = nc + 1;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const int nr = static_cast<int>(B - r0 < rows ? B - r0 : rows);
  for (int idx = threadIdx.x; idx < nbt * nr; idx += kThreads) {
    const int band = idx / nr, r = idx - band * nr;
    const typename Rec<Pack>::T v = __ldg(rec + static_cast<size_t>(band) * B + r0 + r);
    int h = Rec<Pack>::get(v, 0), p1 = Rec<Pack>::get(v, 1), p2 = Rec<Pack>::get(v, 2);
    if (h == p1 && p1 == p2) h = p1 = p2 = static_cast<int>(r0 + r);  // not written: self
    int32_t* t = tile_s + r * pitch;
    t[band] = h;
    t[nbt + band] = p1;
    t[2 * nbt + band] = p2;
  }
  __syncthreads();
  int32_t* o = out + r0 * nc;
  for (int idx = threadIdx.x; idx < nr * nc; idx += kThreads) {
    const int r = idx / nc;
    o[idx] = tile_s[r * pitch + idx - r * nc];
  }
}

// Rows a heads_out_kernel block takes at nbt <= kMaxHeadBands bands.
inline int stage_rows(int nbt) {
  const int rows = kStageInts / (3 * nbt + 1);
  return rows < kStageRows ? rows : kStageRows;
}

// Whether a run-head record packs its three rows into 8 bytes (Rec<true>).
inline bool packed_records(int row_bits) { return row_bits <= kRecBits; }

// ---- lsh_verify ---------------------------------------------------------

enum ThrMode { kThrScalar = 0, kThrColumn = 1, kThrEdge = 2, kThrFine = 3 };

struct VerifyArgs {
  const uint32_t* sig;  // null: the bars alone
  int P;
  const int32_t* rep;   // int32[B, nc]
  int B;
  int nc;
  const bool* valid;
  const int64_t* keys;  // int64[B, nk]; null unless fine-only edges are asked
  int nk;
  int num_coarse;
  const float* thr;     // kThrColumn: float32[nc]; kThrEdge: float32[B, nc]
  int thr_mode;
  float base;
  float strict;
  float band;
  bool* ok;             // each output null when not asked
  bool* need;
  float* bars;
};

constexpr unsigned char kShares = 1;  // a coarse key shared with the row
constexpr unsigned char kValid = 2;   // the candidate is valid

// A warp a row b, over its columns in chunks of kVerifyChunk:
// 1. compaction: each group of 32 columns' non-self, in-range candidates,
//    each distinct j given a slot once (match_any within the group, a scan
//    of the chunk's earlier slots across groups), each lane keeping its
//    columns' candidates and slots in registers;
// 2. each slot's agreement count, whether it shares a coarse key with b
//    and whether it is valid: R > 0 takes kSub lanes a candidate and 32 /
//    kSub candidates at once, a lane R 16-byte words of each signature
//    (P = 4 kSub R), the row's own words held in registers; R = 0 takes a
//    candidate at a time, a lane every 32nd word;
// 3. each column's bar, ok, need or bar alone, from its slot (self: P
//    words agree; out of range: no edge).
template <int R>
__global__ void __launch_bounds__(kThreads, 8) verify_kernel(const VerifyArgs a) {
  __shared__ int s_j[kWarps][kVerifyChunk];
  __shared__ int s_cnt[kWarps][kVerifyChunk];
  __shared__ unsigned char s_flag[kWarps][kVerifyChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.B) return;  // no block-wide barrier below
  const int g = lane & (kSub - 1), sg = lane / kSub;
  const unsigned lt = (1u << lane) - 1u;
  const bool vb = a.valid != nullptr && a.valid[b];
  const float fp = static_cast<float>(a.P);
  const size_t rb = static_cast<size_t>(b) * a.nc;
  uint4 mine[R > 0 ? R : 1];  // loaded with the row's first candidate
  bool have_mine = false;
  const int64_t* kb = a.keys != nullptr ? a.keys + static_cast<size_t>(b) * a.nk : nullptr;
  const int64_t kb0 = kb != nullptr && g < a.num_coarse ? kb[g] : 0;
  const int64_t kb1 = kb != nullptr && g + kSub < a.num_coarse ? kb[g + kSub] : 0;
  int* uj = s_j[warp];
  int* ucnt = s_cnt[warp];
  unsigned char* uflag = s_flag[warp];
  constexpr int kGroups = kVerifyChunk / 32;
  for (int c0 = 0; c0 < a.nc; c0 += kVerifyChunk) {
    const int cn = min(kVerifyChunk, a.nc - c0);
    int nu = 0;
    int jr[kGroups], sr[kGroups];  // the lane's column of each group: its j and slot
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int cl = gi * 32 + lane;
      const int j = cl < cn ? a.rep[rb + c0 + cl] : b;
      const bool cand = cl < cn && j != b && j >= 0 && j < a.B;
      jr[gi] = j;
      sr[gi] = -1;
      if (__ballot_sync(kFull, cand) == 0) continue;  // self or out of range: no slot
      const unsigned peers = __match_any_sync(kFull, cand ? j : -1);
      const int first = __ffs(peers) - 1;
      bool fresh = cand && lane == first;
      int slot = -1;
      if (fresh) {
        // a j of an earlier group of the chunk keeps its slot
        for (int u = 0; u < nu; ++u) {
          if (uj[u] == j) {
            slot = u;
            fresh = false;
            break;
          }
        }
      }
      const unsigned fm = __ballot_sync(kFull, fresh);
      if (fresh) {
        slot = nu + __popc(fm & lt);
        uj[slot] = j;
      }
      slot = __shfl_sync(kFull, slot, first);
      sr[gi] = cand ? slot : -1;
      nu += __popc(fm);
    }
    __syncwarp();
    if (R > 0) {
      constexpr int kAtOnce = 32 / kSub;
      if (nu > 0 && !have_mine) {  // R > 0: sig is given
        const uint4* sb = reinterpret_cast<const uint4*>(a.sig + static_cast<size_t>(b) * a.P);
#pragma unroll
        for (int r = 0; r < R; ++r) mine[r] = __ldg(sb + r * kSub + g);
        have_mine = true;
      }
      for (int u0 = 0; u0 < nu; u0 += kAtOnce) {
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
    } else {
      for (int u = 0; u < nu; ++u) {
        const int j = uj[u];
        int m = 0;
        if (a.sig != nullptr) {
          const uint32_t* sb = a.sig + static_cast<size_t>(b) * a.P;
          const uint32_t* sj = a.sig + static_cast<size_t>(j) * a.P;
          for (int p = lane; p < a.P; p += 32) m += __ldg(sb + p) == __ldg(sj + p);
          m = __reduce_add_sync(kFull, m);
        }
        bool eq = false;
        if (kb != nullptr) {
          const int64_t* kj = a.keys + static_cast<size_t>(j) * a.nk;
          for (int i = lane; i < a.num_coarse && !eq; i += 32) eq = kj[i] == kb[i];
        }
        const bool shares = __any_sync(kFull, eq);
        if (lane == 0) {
          ucnt[u] = m;
          uflag[u] = (shares ? kShares : 0) | (a.valid != nullptr && a.valid[j] ? kValid : 0);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int cl = gi * 32 + lane;
      if (cl >= cn) break;
      const int c = c0 + cl;
      const size_t e = rb + c;
      const int j = jr[gi], slot = sr[gi];
      const bool in_range = j >= 0 && j < a.B;
      int count = 0;
      bool shares = true, vj = false;
      if (j == b) {
        count = a.P;  // self: every word agrees
        shares = a.num_coarse > 0;
        vj = vb;
      } else if (slot >= 0) {
        count = ucnt[slot];
        shares = uflag[slot] & kShares;
        vj = uflag[slot] & kValid;
      }
      const bool fo = kb != nullptr && in_range && c % a.nk >= a.num_coarse && !shares;
      if (a.bars != nullptr) {
        a.bars[e] = fo ? a.strict : a.base;
        continue;
      }
      const float agree = __fdiv_rn(static_cast<float>(count), fp);
      float bar = a.base;
      if (a.thr_mode == kThrColumn) bar = a.thr[c];
      else if (a.thr_mode == kThrEdge) bar = a.thr[e];
      else if (a.thr_mode == kThrFine) bar = fo ? a.strict : a.base;
      const bool ok = in_range && agree >= bar && vb && vj;
      if (a.ok != nullptr) a.ok[e] = ok;
      if (a.need != nullptr) a.need[e] = ok && j != b && (fo || agree < a.band);
    }
    __syncwarp();
  }
}

// The words of a P-word signature that one lane of kSub loads a round are
// 4: R = P / (4 kSub) rounds where that is 1, 2, 4 or 8 and the rows are
// 16-byte aligned; 0 (the general path) otherwise.
inline int verify_rounds(const void* sig, int P) {
  if (sig == nullptr || P % (4 * kSub) != 0 || reinterpret_cast<uintptr_t>(sig) % 16 != 0) {
    return 0;
  }
  const int r = P / (4 * kSub);
  return r == 1 || r == 2 || r == 4 || r == 8 ? r : 0;
}

// ---- lsh_label ---------------------------------------------------------

// A warp a row b: its distinct ok candidates c in [0, B), c != b, into
// edges[b * nc, + deg[b]) (kLabelGroups groups of 32 columns loaded at
// once, a group matched with match_any, each new c checked against the
// row's earlier ones); x[b] = z0[b] = b; the round stamp cleared.
__global__ void __launch_bounds__(kThreads)
label_edges_kernel(const int32_t* __restrict__ rep, const bool* __restrict__ ok, int B, int nc,
                   int32_t* edges, int32_t* __restrict__ deg, int32_t* __restrict__ x,
                   int32_t* __restrict__ z0, int32_t* __restrict__ stamp) {
  const int b = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  if (b >= B) return;  // no block-wide barrier below
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int32_t* rb = rep + static_cast<size_t>(b) * nc;
  const bool* ob = ok + static_cast<size_t>(b) * nc;
  int32_t* list = edges + static_cast<size_t>(b) * nc;
  int n = 0;
  for (int c0 = 0; c0 < nc; c0 += 32 * kLabelGroups) {
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
      if (__ballot_sync(kFull, cand) == 0) continue;
      const unsigned peers = __match_any_sync(kFull, cand ? j : B);  // B: no candidate
      bool fresh = cand && lane == __ffs(peers) - 1;
      for (int u = 0; fresh && u < n; ++u) fresh = list[u] != j;
      const unsigned fm = __ballot_sync(kFull, fresh);
      if (fresh) list[n + __popc(fm & lt)] = j;
      n += __popc(fm);
      __syncwarp();  // the list's new entries seen by the next group's lanes
    }
  }
  if (lane == 0) {
    deg[b] = n;
    x[b] = z0[b] = b;
    if (b == 0) *stamp = 0;
  }
}

// One cooperative launch, every round; rows grid-strided, a thread a row.
// Round r: the pull (m = min(x[b], x[c] over b's edges), atomicMin of m
// into z[b] and each z[c]; z = z[r & 1], which is x), a grid sync, the jump
// (n = z[z[b]]; x[b] = z[(r + 1) & 1][b] = n; the stamp set to r + 1 where
// n differs from x[b]), a grid sync, then every thread reads the stamp and
// stops if round r changed nothing.  Last, out[b] = valid ? x[b] : b.
__global__ void __launch_bounds__(kThreads)
label_rounds_kernel(const int32_t* __restrict__ edges, const int32_t* __restrict__ deg,
                    const bool* __restrict__ valid, int B, int nc, int rounds, int32_t* x,
                    int32_t* z0, int32_t* z1, int32_t* stamp, int32_t* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int round = 0; round < rounds; ++round) {
    int32_t* z = round & 1 ? z1 : z0;
    int32_t* zn = round & 1 ? z0 : z1;
    for (int b = t0; b < B; b += stride) {
      const int n = __ldg(deg + b);
      if (n == 0) continue;
      const int32_t* e = edges + static_cast<size_t>(b) * nc;
      int m = __ldcg(x + b);
      for (int u = 0; u < n; ++u) m = min(m, __ldcg(x + __ldg(e + u)));
      atomicMin(z + b, m);
      for (int u = 0; u < n; ++u) atomicMin(z + __ldg(e + u), m);
    }
    grid.sync();
    bool moved = false;
    for (int b = t0; b < B; b += stride) {
      const int nx = __ldcg(z + __ldcg(z + b));
      moved |= nx != __ldcg(x + b);
      x[b] = nx;
      zn[b] = nx;
    }
    if (__any_sync(kFull, moved) && (threadIdx.x & 31) == 0) __stcg(stamp, round + 1);
    grid.sync();
    if (__ldcg(stamp) != round + 1) break;  // the same value for every thread
  }
  for (int b = t0; b < B; b += stride) out[b] = valid[b] ? __ldcg(x + b) : b;
}

// int32 words of astt_lsh_label's scratch: the edge lists [B, nc], deg,
// x, z0, z1 [B] each, the round stamp.
inline long long label_scratch_words(int B, int nc) {
  return static_cast<long long>(B) * (nc + 4) + 1;
}

template <bool Pack>
cudaError_t run_heads(const void* sorted, const void* valid, int B, int nbt, int row_bits,
                      void* out, void* rec, cudaStream_t s) {
  using T = typename Rec<Pack>::T;
  auto* r = static_cast<T*>(rec);
  cudaError_t err = cudaMemsetAsync(r, 0xFF, sizeof(T) * B * static_cast<size_t>(nbt), s);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kHeadTile - 1) / kHeadTile, nbt);
  run_heads_kernel<Pack><<<grid, kThreads, 0, s>>>(static_cast<const int64_t*>(sorted),
                                                   static_cast<const bool*>(valid), B,
                                                   row_bits, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = stage_rows(nbt);
  const size_t smem = sizeof(int32_t) * rows * (3 * nbt + 1);  // at most 48 KiB
  heads_out_kernel<Pack><<<(B + rows - 1) / rows, kThreads, smem, s>>>(
      r, B, nbt, rows, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

inline unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int astt_lsh_max_salts() { return kMaxSalts; }

// sig uint32[B, P] -> keys int64[B, nb + nf] (wide: int64[B, nb, 2], nf
// must be 0) in [0, 2^32); with packed (not wide), also the sort keys
// int64[nb + nf, B] of valid[B].  salts: nb + nf uint32 on the host.
int astt_lsh_keys(const void* sig, int B, int P, int nb, int nf, const void* salts, int wide,
                  void* keys, const void* valid, int row_bits, void* packed, void* stream) {
  const int nk = nb + nf;
  if (B < 0 || P < 1 || nb < 1 || nf < 0 || nk > kMaxSalts || P % nb != 0 ||
      (nf > 0 && P % nf != 0) || (wide && nf != 0) || row_bits < 0 || row_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(keys) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (B == 0) return 0;
  Salts s{};
  const auto* src = static_cast<const uint32_t*>(salts);
  for (int i = 0; i < nk; ++i) s.v[i] = src[i];
  const KeysPlan plan = keys_plan(sig, P, nb, nf, wide);
  auto* g = static_cast<const uint32_t*>(sig);
  auto* k = static_cast<int64_t*>(keys);
  auto* v = static_cast<const bool*>(valid);
  auto* pk = static_cast<int64_t*>(packed);
  auto* st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (plan.load) {
    case kLoadVec:
      err = launch_keys<kLoadVec>(g, B, P, nb, nf, s, wide, plan.pitch, plan.smem, k, v,
                                  row_bits, pk, st);
      break;
    case kLoadWords:
      err = launch_keys<kLoadWords>(g, B, P, nb, nf, s, wide, plan.pitch, plan.smem, k, v,
                                    row_bits, pk, st);
      break;
    default:
      err = launch_keys<kLoadGlobal>(g, B, P, nb, nf, s, wide, plan.pitch, plan.smem, k, v,
                                     row_bits, pk, st);
      break;
  }
  return static_cast<int>(err);
}

// Which load astt_lsh_keys takes for this shape (KeysLoad: 2 16-byte words
// in shared memory, 1 4-byte words, 0 global memory).
int astt_lsh_keys_load(const void* sig, int P, int nb, int nf, int wide) {
  if (P < 1 || nb < 1 || nf < 0) return -1;
  return keys_plan(sig, P, nb, nf, wide).load;
}

// keys int64[B, nk], valid bool[B] -> packed int64[nk, B].
int astt_lsh_pack(const void* keys, int B, int nk, const void* valid, int row_bits, void* packed,
                  void* stream) {
  if (B < 0 || nk < 1 || nk > kMaxSalts || row_bits < 0 || row_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t smem = sizeof(int64_t) * kKeyRows * (nk | 1);
  cudaError_t err = cudaFuncSetAttribute(pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_kernel<<<(B + kKeyRows - 1) / kKeyRows, kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), B, nk, static_cast<const bool*>(valid), row_bits,
      static_cast<int64_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}

int astt_lsh_sort_passes() { return kSortPasses; }

// Launches of one astt_lsh_sort call with B > 0: a digit count, then a
// scatter a pass.
int astt_lsh_sort_launches() { return 1 + kSortPasses; }

// The bytes of astt_lsh_sort's scratch: each pass's published tile counts
// (uint64 [passes][nbt][ntiles][kBins]), the band counts (int32
// [nbt][passes][kBins]) and the tile tickets (int32 [passes][nbt]), zeroed
// by the call.
long long astt_lsh_sort_scratch(int B, int nbt) {
  const long long ntiles = (B + kSortTile - 1) / kSortTile;
  return 8LL * kSortPasses * nbt * ntiles * kBins + 4LL * nbt * kSortPasses * kBins +
         4LL * kSortPasses * nbt;
}

// packed int64[nbt, B] -> out int64[nbt, B], each band ascending; packed is
// (key << row_bits) | row with key < 2^32 and each band's rows ascending.
// tmp int64[nbt, B] and astt_lsh_sort_scratch bytes are scratch.
int astt_lsh_sort(const void* packed, int B, int nbt, int row_bits, void* out, void* tmp,
                  void* scratch, void* stream) {
  if (B < 0 || nbt < 1 || nbt > 65535 || row_bits < 0 || row_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(sort_scatter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kScatterSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (B + kSortTile - 1) / kSortTile;
  const dim3 grid(ntiles, nbt);
  // the passes alternate between tmp and out, the last one into out
  int64_t* bufs[2] = {static_cast<int64_t*>(tmp), static_cast<int64_t*>(out)};
  const int64_t* src = static_cast<const int64_t*>(packed);
  const size_t per_pass = static_cast<size_t>(nbt) * ntiles * kBins;
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* counts = reinterpret_cast<int*>(status + kSortPasses * per_pass);
  int* tickets = counts + static_cast<size_t>(nbt) * kSortPasses * kBins;
  err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(astt_lsh_sort_scratch(B, nbt)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_digits_kernel<<<grid, kThreads, 0, s>>>(src, B, row_bits, counts);
  err = cudaGetLastError();
  for (int pass = 0; pass < kSortPasses && err == cudaSuccess; ++pass) {
    const int shift = row_bits + pass * kRadixBits;
    int64_t* dst = bufs[(pass + kSortPasses) & 1];
    sort_scatter_kernel<<<grid, kThreads, kScatterSmem, s>>>(
        src, dst, B, shift, ntiles, counts + pass * kBins, status + pass * per_pass,
        tickets + pass * nbt);
    src = dst;
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// The most bands astt_lsh_run_heads takes.
int astt_lsh_max_head_bands() { return kMaxHeadBands; }

// The bytes of astt_lsh_run_heads' rec scratch.
long long astt_lsh_run_heads_scratch(int B, int nbt, int row_bits) {
  const size_t rec = packed_records(row_bits) ? sizeof(int64_t) : sizeof(int4);
  return static_cast<long long>(B) * nbt * static_cast<long long>(rec);
}

// sorted int64[nbt, B] (each band ascending), valid bool[B] -> out
// int32[B, 3 nbt], nbt <= kMaxHeadBands; rec: astt_lsh_run_heads_scratch
// bytes of scratch.  Two launches: the records, then their transpose.
int astt_lsh_run_heads(const void* sorted, const void* valid, int B, int nbt, int row_bits,
                       void* out, void* rec, void* stream) {
  if (B < 0 || nbt < 1 || nbt > kMaxHeadBands || row_bits < 0 || row_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  auto* s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed_records(row_bits)
          ? run_heads<true>(sorted, valid, B, nbt, row_bits, out, rec, s)
          : run_heads<false>(sorted, valid, B, nbt, row_bits, out, rec, s);
  return static_cast<int>(err);
}

// See VerifyArgs: the ok / need / bars matrices of rep int32[B, nc].
int astt_lsh_verify(const void* sig, int P, const void* rep, int B, int nc, const void* valid,
                    const void* keys, int nk, int num_coarse, const void* thr, int thr_mode,
                    float base, float strict, float band, void* ok, void* need, void* bars,
                    void* stream) {
  if (B < 0 || nc < 1 || (sig != nullptr && P < 1) || thr_mode < kThrScalar ||
      thr_mode > kThrFine || (keys != nullptr && (nk < 1 || nc % nk != 0 || num_coarse > nk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  VerifyArgs a{static_cast<const uint32_t*>(sig), P, static_cast<const int32_t*>(rep), B, nc,
               static_cast<const bool*>(valid), static_cast<const int64_t*>(keys), nk,
               num_coarse, static_cast<const float*>(thr), thr_mode, base, strict, band,
               static_cast<bool*>(ok), static_cast<bool*>(need), static_cast<float*>(bars)};
  const unsigned blocks = (B + kWarps - 1) / kWarps;
  auto* s = static_cast<cudaStream_t>(stream);
  switch (verify_rounds(sig, P)) {
    case 1: verify_kernel<1><<<blocks, kThreads, 0, s>>>(a); break;
    case 2: verify_kernel<2><<<blocks, kThreads, 0, s>>>(a); break;
    case 4: verify_kernel<4><<<blocks, kThreads, 0, s>>>(a); break;
    case 8: verify_kernel<8><<<blocks, kThreads, 0, s>>>(a); break;
    default: verify_kernel<0><<<blocks, kThreads, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int astt_lsh_label_launches() { return kLabelLaunches; }

// The bytes of astt_lsh_label's scratch.
long long astt_lsh_label_scratch(int B, int nc) { return 4 * label_scratch_words(B, nc); }

// rep int32[B, nc], ok bool[B, nc], valid bool[B] -> out int32[B] after at
// most `rounds` rounds; work: astt_lsh_label_scratch bytes.  kLabelLaunches
// launches whatever the rounds: the edge lists, then one cooperative launch
// of every round (raises, with CUDA's error, where the card refuses it).
int astt_lsh_label(const void* rep, const void* ok, const void* valid, int B, int nc, int rounds,
                   void* work, void* out, void* stream) {
  if (B < 0 || nc < 0 || rounds < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<int32_t*>(work);
  int32_t* edges = w;
  int32_t* deg = w + static_cast<size_t>(B) * nc;
  int32_t* x = deg + B;
  int32_t* z0 = x + B;
  int32_t* z1 = z0 + B;
  int32_t* stamp = z1 + B;
  const auto* r = static_cast<const int32_t*>(rep);
  const auto* k = static_cast<const bool*>(ok);
  const auto* v = static_cast<const bool*>(valid);
  auto* o = static_cast<int32_t*>(out);
  label_edges_kernel<<<blocks_for(32LL * B), kThreads, 0, s>>>(r, k, B, nc, edges, deg, x, z0,
                                                               stamp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, label_rounds_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned want = blocks_for(B);
  const unsigned fit = static_cast<unsigned>(per_sm) * static_cast<unsigned>(sms);
  const dim3 grid(want < fit ? want : fit);
  void* args[] = {&edges, &deg, &v, &B, &nc, &rounds, &x, &z0, &z1, &stamp, &o};
  err = cudaLaunchCooperativeKernel((void*)label_rounds_kernel, grid, dim3(kThreads), args, 0, s);
  return static_cast<int>(err);
}

const char* astt_lsh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
