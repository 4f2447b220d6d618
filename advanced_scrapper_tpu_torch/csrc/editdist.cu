// The matcher's Myers alignment bound, by hand for Hopper (sm_90a): two
// kernels.  myers_bound (Kernel F, below first) takes every refine pattern
// against every row with the prune compare fused in; myers_pairs (at the
// end) takes one pattern per pair, for the legacy screen's refine.
//
// Replaces the reference's jnp semiglobal_dist_shared
// (advanced_scrapper_tpu/ops/editdist.py:144) together with the compare
// that its fused screen step applies (ops/match.py:make_screen_step,
// :258-285).  There is no Pallas original; XLA runs a lax.scan over
// [patterns, rows, tiles] state there.
//
// Input: the chunk's rows ragged in one text (row r: row_len[r] bytes at
// row_off[r], the combined title "\n" text), text_len and flags per row;
// K patterns as Myers masks uint32[K, 256] (bit j of masks[k][c] set
// where pattern k has byte c at j), plens int32[K] (0..32), ok uint8[K],
// and cols int64[K], each pattern's column in the screen's mask
// uint8[rows, n_names].  For every pair it computes
//
//   d = min over tiles of the least Levenshtein distance between the
//       pattern and a substring of the tile (Myers 1999, search variant:
//       each step shifts without OR-ing in bit 0), where tiles start at
//       multiples of 512, are live for min(len - start, 543) bytes and
//       start from pv = ~0, mv = 0, score = best = max(m, 1)
//
// and ORs 2 into mask[r][cols[k]] where ok[k], text_len[r] > m, the row's
// flag bit 0 and 100*d >= (2*m)*(100 - t) in float32 all hold (every
// product __fmul_rn, 100 - t rounded once on the host).  These are the
// reference's blocked semantics exactly: a scan of the whole row at once
// could find a smaller d where the best substring is longer than 32
// bytes.  A tile that is not live gives max(m, 1), so the result does not
// depend on any padding.  With dist given, every (row, pattern) pair is
// computed and d written to dist int32[rows, K]; without it, rows the
// gates exclude for every pattern of a block are skipped (the bit is the
// same either way).
//
// Bound: operations.  Each live byte of each tile costs 14 INT32
// operations per pattern: the table address, xv, the carry add and the
// three logic ops around it, ph, mh, the two sign bits into the score, the
// two shifts, pv, mv and the min (the two shared loads, the byte and its
// mask, are not INT32 work).  At S&P scale, 20,000 rows of ~2 kB against
// ~3,900 refine patterns, that is ~1.8e11 steps, ~2.5e12 operations,
// ~74 ms at the card's INT32 rate (IMAD and the ALU pipe side by side).
// The bytes (the text once, the masks, the mask bytes) are small beside
// it.
//
// Design: kChains tiles a thread, run as independent Myers chains.
// - A block of 128 threads holds 128 patterns, one per thread, with their
//   masks for the printable bytes 32..126 in shared memory laid out
//   [byte][pattern] (so the 32 lanes of a warp, which all read the same
//   text byte, read 32 consecutive words, without bank conflicts), plus a
//   row of zeros: 48 KiB, so 4 blocks fit in an SM.  blockIdx.y picks the
//   pattern group; the blocks of a group take its rows in turn (row
//   blockIdx.x, then + gridDim.x, ...), whole rows.
// - Each thread runs kChains chains.  Every chain works through rows of
//   its own: it takes the block's next row, runs the row's tiles in order
//   (state reset per tile, best kept over the row), writes the row's bit
//   and distance, and takes the next row.  Rows no pattern of the group
//   needs (gated mode: flag bit 0 clear, or text no longer than any ok
//   pattern) are never taken; a row of no bytes is written at once.  The
//   choice of rows is the same for every thread, so control stays uniform.
//   A warp with no pattern (the last group's tail) walks the rows with
//   the block but runs no steps.
// - The loop runs in rounds: each round steps every chain as far as the
//   nearest end of a live tile, without a guard, one step of each chain in
//   turn, so the ALU sees kChains independent chains at every step.  A
//   chain whose tile ended then takes its next tile, and the block stages
//   the new tiles (one slot of 576 bytes a chain, 16-byte loads from the
//   aligned word below the tile's start, byte loads only for the words
//   that straddle the tile's ends) between two barriers.
// - Other bytes (the "\n" between title and text, bytes of 128 and
//   above): where no pattern of the block has a mask bit for such a byte
//   (the matcher's refine names are printable ASCII), staging maps it to
//   the row of zeros and the step needs no branch.  Otherwise the block
//   runs a second instance of the loop that reads the pattern's mask for
//   such a byte from global memory.
// - The pattern sits in the top m bits of its lane (masks shifted up by
//   32 - m when the table is filled), so the two high-bit tests are the
//   sign bits, added by two shifts; bits below the pattern stay pv = 1,
//   mv = ph = mh = 0, so nothing carries or shifts into it and every
//   distance is the same.  The carry add, the two shifts and the table
//   address are multiply-adds by values ptxas cannot see (1, 2, the row
//   stride), so they issue as IMAD on the FMA pipe beside the logic ops
//   on the ALU pipe.  In the SASS a step is 7 LOP3, 2 LEA and 1 VIMNMX
//   on the ALU pipe, 4 IMAD on the FMA pipe and 2 LDS: the ALU pipe sets
//   the floor.  myers_probe.py (at the repo's root) times other values of
//   kChains and kUnroll on the card.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kPatterns = 128;               // threads per block, one pattern each
constexpr int kChains = 4;                   // tiles in flight per thread
constexpr int kUnroll = 8;                   // steps a chain per loop pass
constexpr int kBlock = 512;                  // tile stride
constexpr int kTile = kBlock + 31;           // live bytes of a tile at most
constexpr int kSlot = 576;                   // staged bytes of a tile: 15 of lead + kTile
constexpr int kSlotWords = kSlot / 16;
// the table holds the masks of the printable bytes kLo .. kLo + kRows - 1
// (32 .. 126), then a row of zeros
constexpr int kLo = 32;
constexpr int kRows = 95;
constexpr int kTableBytes = (kRows + 1) * kPatterns * 4;
constexpr int kSmem = kTableBytes + kChains * kSlot;
constexpr int kMinBlocks = 4;  // 48 KiB of table and 2.3 KiB of slots a block

// How far a pattern's masks are shifted up: its last byte sits at bit 31
// for every length m.
__device__ __forceinline__ int top_shift(int m) { return 32 - m; }

static_assert(kSlot >= 15 + kTile && kSlot % 16 == 0, "a slot holds a tile and its lead");
static_assert(kChains >= 1 && kChains <= 16, "chains per thread");

struct Args {
  const uint8_t* text;
  const int64_t* row_off;
  const int32_t* row_len;
  const int32_t* text_len;
  const int32_t* flags;
  int rows;
  const uint32_t* masks;
  const int32_t* plens;
  const uint8_t* ok;
  const int64_t* cols;
  int n_pat;
  float hundred_minus_t;
  uint8_t* mask;
  int n_names;
  int32_t* dist;
  uint32_t one;     // 1, 2 and the table's row stride in bytes, as values
  uint32_t two;     // ptxas cannot fold, so that the arithmetic on them
  uint32_t stride;  // issues as IMAD on the FMA pipe
};

// One step of the search variant of Myers' recurrence.
__device__ __forceinline__ void myers_step(uint32_t eq, uint32_t& pv, uint32_t& mv,
                                           int& score, int& best, uint32_t one, uint32_t two) {
  const uint32_t xv = eq | mv;
  const uint32_t xh = (((eq & pv) * one + pv) ^ pv) | eq;
  uint32_t ph = mv | ~(xh | pv);
  uint32_t mh = pv & xh;
  // the high-bit tests are the sign bits: +1 where ph's is set, -1 where mh's is
  score += static_cast<int>(ph >> 31) + (static_cast<int>(mh) >> 31);
  ph *= two;  // the shifts by one
  mh *= two;
  pv = mh | ~(xv | ph);
  mv = ph & xv;
  best = min(best, score);
}

// The mask of text byte c (as staged) for this thread's pattern.
template <bool kGlobal>
__device__ __forceinline__ uint32_t eq_of(const char* eq_col, const uint32_t* gmask,
                                          uint32_t c, uint32_t stride, int shift) {
  if (kGlobal) {  // raw bytes
    const uint32_t d = c - kLo;
    if (d >= static_cast<uint32_t>(kRows)) return __ldg(gmask + c) << shift;
    c = d;
  }
  return *reinterpret_cast<const uint32_t*>(eq_col + c * stride);
}

// Each byte to its table row: byte - kLo where the table holds it, else
// kRows (the row of zeros); four at once.
__device__ __forceinline__ uint32_t table_rows(uint32_t x) {
  uint32_t out = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t d = ((x >> (8 * b)) & 0xFFu) - kLo;
    out |= (d < static_cast<uint32_t>(kRows) ? d : static_cast<uint32_t>(kRows)) << (8 * b);
  }
  return out;
}

// Copy the live bytes [src, src + n) of a tile into a slot, as 16-byte
// words from the aligned word at or below src; thread `w` of the block
// copies word w.  Returns the lead (src's offset in its word).
template <bool kGlobal>
__device__ __forceinline__ int stage_tile(uint8_t* slot, const uint8_t* src, int n, int w) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t base = s & ~static_cast<uintptr_t>(15);
  const int lead = static_cast<int>(s - base);
  const int words = (lead + n + 15) >> 4;
  if (w < words) {
    const uintptr_t p = base + 16 * static_cast<uintptr_t>(w);
    uint4 v;
    if (p >= s && p + 16 <= s + n) {
      v = __ldg(reinterpret_cast<const uint4*>(p));
    } else {  // a word that straddles an end of the tile
      uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (p + j >= s && p + j < s + n) {
          wv[j >> 2] |= static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(p + j))
                        << (8 * (j & 3));
        }
      }
      v = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
    if (!kGlobal) {
      v = make_uint4(table_rows(v.x), table_rows(v.y), table_rows(v.z), table_rows(v.w));
    }
    reinterpret_cast<uint4*>(slot)[w] = v;
  }
  return lead;
}

template <bool kGlobal>
__device__ __forceinline__ void run_chains(const Args& a, uint8_t* slots, const char* eq_col,
                                           int min_plen) {
  const int k = blockIdx.y * kPatterns + threadIdx.x;
  const bool has_pattern = k < a.n_pat;
  const int plen = has_pattern ? a.plens[k] : 0;
  const int m = max(plen, 1);
  const int shift = top_shift(m);
  // a warp with no pattern (the last group's tail) walks the rows but
  // runs no steps
  const bool warp_steps = __any_sync(0xFFFFFFFFu, has_pattern);
  const bool pat_ok = has_pattern && a.ok[k] != 0;
  const int64_t col = has_pattern ? a.cols[k] : 0;
  const uint32_t* gmask = a.masks + static_cast<int64_t>(has_pattern ? k : 0) * 256;
  const float rhs = __fmul_rn(2.0f * static_cast<float>(plen), a.hundred_minus_t);
  const bool every_pair = a.dist != nullptr;
  const uint32_t one = a.one, two = a.two, stride = a.stride;

  auto finish_row = [&](int row, int best) {
    if (!has_pattern) return;
    if (every_pair) a.dist[static_cast<int64_t>(row) * a.n_pat + k] = best;
    if (pat_ok && a.text_len[row] > plen && (a.flags[row] & 1) != 0 &&
        __fmul_rn(static_cast<float>(best), 100.0f) >= rhs) {
      uint8_t* cell = a.mask + static_cast<int64_t>(row) * a.n_names + col;
      *cell = static_cast<uint8_t>(*cell | 2u);  // one thread per cell: no race
    }
  };
  // the block's next row with at least one byte that some pattern needs
  // (rows of no bytes are finished on the way); -1 when none is left
  int next = blockIdx.x;
  auto take_row = [&]() -> int {
    for (; next < a.rows; next += gridDim.x) {
      const int r = next;
      if (!every_pair && ((a.flags[r] & 1) == 0 || a.text_len[r] <= min_plen)) continue;
      if (a.row_len[r] > 0) {
        next += gridDim.x;
        return r;
      }
      finish_row(r, m);
    }
    return -1;
  };

  int row[kChains], len[kChains], start[kChains], rem[kChains], pos[kChains];
  const uint8_t* src[kChains];
  uint32_t pv[kChains], mv[kChains];
  int score[kChains], best[kChains];
  unsigned need = 0;  // chains whose next tile is to be staged
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    row[i] = take_row();
    len[i] = row[i] >= 0 ? a.row_len[row[i]] : 0;
    src[i] = row[i] >= 0 ? a.text + a.row_off[row[i]] : a.text;
    start[i] = 0;
    rem[i] = min(len[i], kTile);
    pos[i] = i * kSlot;
    pv[i] = ~0u;
    mv[i] = 0u;
    score[i] = best[i] = m;
    if (row[i] >= 0) need |= 1u << i;
  }

  for (;;) {
    if (need) {  // stage the chains' new tiles
      __syncthreads();  // every reader of the old tiles is done
#pragma unroll
      for (int i = 0; i < kChains; ++i) {
        if (need & (1u << i)) {
          const int w = (static_cast<int>(threadIdx.x) - i * kSlotWords) & (kPatterns - 1);
          pos[i] = i * kSlot +
                   stage_tile<kGlobal>(slots + i * kSlot, src[i] + start[i], rem[i], w);
        }
      }
      __syncthreads();
      need = 0;
    }
    int steps = INT_MAX;
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (row[i] >= 0) steps = min(steps, rem[i]);
    }
    if (steps == INT_MAX) break;

    // every chain steps to the nearest end of a live tile; an idle chain
    // steps over its stale slot and its result is never read
    int j = warp_steps ? 0 : steps;
    for (; j + kUnroll <= steps; j += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < kChains; ++i) {
          const uint32_t c = slots[pos[i] + j + u];
          myers_step(eq_of<kGlobal>(eq_col, gmask, c, stride, shift), pv[i], mv[i], score[i],
                     best[i], one, two);
        }
      }
    }
    for (; j < steps; ++j) {
#pragma unroll
      for (int i = 0; i < kChains; ++i) {
        const uint32_t c = slots[pos[i] + j];
        myers_step(eq_of<kGlobal>(eq_col, gmask, c, stride, shift), pv[i], mv[i], score[i],
                   best[i], one, two);
      }
    }

#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (row[i] < 0) continue;
      pos[i] += steps;
      rem[i] -= steps;
      if (rem[i] > 0) continue;
      start[i] += kBlock;
      if (start[i] >= len[i]) {  // the row is done: its min over tiles is best
        finish_row(row[i], best[i]);
        best[i] = m;
        start[i] = 0;
        row[i] = take_row();
        if (row[i] < 0) {
          pos[i] = i * kSlot;
          continue;
        }
        len[i] = a.row_len[row[i]];
        src[i] = a.text + a.row_off[row[i]];
      }
      rem[i] = min(len[i] - start[i], kTile);
      pv[i] = ~0u;
      mv[i] = 0u;
      score[i] = m;
      need |= 1u << i;
    }
  }
}

__global__ void __launch_bounds__(kPatterns, kMinBlocks)
    bound_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int warp_min[kPatterns / 32];
  uint32_t* eqs = reinterpret_cast<uint32_t*>(smem);  // [kRows + 1][kPatterns]
  uint8_t* slots = smem + kTableBytes;                // [kChains][kSlot]
  const int k = blockIdx.y * kPatterns + threadIdx.x;
  const bool has_pattern = k < a.n_pat;
  for (int i = threadIdx.x; i < kRows * kPatterns; i += kPatterns) {
    const int p = i / kRows;
    const int c = i % kRows;  // consecutive threads read consecutive bytes' words
    const int kk = blockIdx.y * kPatterns + p;
    eqs[c * kPatterns + p] =
        kk < a.n_pat
            ? a.masks[static_cast<int64_t>(kk) * 256 + kLo + c] << top_shift(max(a.plens[kk], 1))
            : 0u;
  }
  eqs[kRows * kPatterns + threadIdx.x] = 0u;
  for (int i = threadIdx.x; i < kChains * kSlot / 4; i += kPatterns) {
    reinterpret_cast<uint32_t*>(slots)[i] = 0u;  // idle chains read these
  }
  // does a pattern of the block match a byte outside the table; the least
  // length of its ok patterns (the gated mode skips rows no longer)
  bool outside = false;
  if (has_pattern) {
    const uint32_t* g = a.masks + static_cast<int64_t>(k) * 256;
    for (int c = 0; c < 256; ++c) {
      if (c - kLo < 0 || c - kLo >= kRows) outside |= __ldg(g + c) != 0u;
    }
  }
  const int own = has_pattern && a.ok[k] != 0 ? a.plens[k] : INT_MAX;
  const int wmin = __reduce_min_sync(0xFFFFFFFFu, own);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = wmin;
  outside = __syncthreads_or(outside);
  int min_plen = INT_MAX;
#pragma unroll
  for (int w = 0; w < kPatterns / 32; ++w) min_plen = min(min_plen, warp_min[w]);
  const char* eq_col = reinterpret_cast<const char*>(eqs + threadIdx.x);
  if (outside) {
    run_chains<true>(a, slots, eq_col, min_plen);
  } else {
    run_chains<false>(a, slots, eq_col, min_plen);
  }
}

// ---------------------------------------------------------------------------
// myers_pairs: one pattern per pair.
//
// Replaces the reference's jnp semiglobal_dist (advanced_scrapper_tpu/ops/
// editdist.py:66 _semiglobal_core, :120), which prune_mask_tables (:222)
// and the legacy screen's _refine_batch launch on the pairs that survived
// the screen.  Input: the batch's texts joined in one buffer (text i:
// tlens[i] bytes at row_off[i]), the index's masks uint32[K, 256] and
// plens int32[K], and per pair its text pair_text[p] and pattern
// pair_pat[p]; output out[p] = the same blocked distance as myers_bound's
// (tiles at multiples of 512, live for min(len - start, 543) bytes, state
// reset per tile, min over tiles, max(m, 1) for an empty text), or -1
// where the pair's indices, its text's bounds or its pattern's length lie
// out of range.  The prune compare (float64, as the reference's) runs on
// the host.  The pattern sits in the low m bits and the high-bit tests
// read bit m - 1, as the reference writes the recurrence.
//
// Bounds.  Operations: 14 INT32 operations per live byte of each tile, as
// for myers_bound; bytes: the texts, indices and masks read once and the
// distances written.  On the S&P chunk's legacy batches (~186 pairs a
// launch) they come to ~0.0002 and ~0.0001 ms a launch on one H100, and
// neither binds: each tile is a chain of up to 543 dependent steps, so a
// launch takes at least its longest live tile times the time of one step
// of a lone chain, plus the launch itself.  chip_smoke.py's kernel_timing row gives that
// chain floor beside both bounds; the design aims at it.
//
// Design: a block per pair, the block's lanes over the pair's tiles.
// - Tile t runs on thread t mod kPairLanes as one chain, in round
//   t / kPairLanes.  A pair of up to 32 tiles (16 KiB) is one warp's work,
//   and the block's other warps go straight to the fold; a pair of up to
//   kPairLanes tiles (64 KiB, the legacy screen's screen_block) takes one
//   round, a longer one more rounds.  The earlier design (a thread per
//   pair and 4 tiles) left most of the card idle with ~186 pairs a launch,
//   and its 32 lanes held 32 pairs and ran as long as the longest.
// - The pattern's 256 mask words are staged in shared memory once a block:
//   a step reads its mask with one LDS, where the earlier design made two
//   dependent global loads a step, the byte and then its mask.
// - The bytes are read ahead, a window of kWindow steps at a time.  A
//   thread loads the 16-byte-aligned words that hold its tile's next
//   window into registers while it runs the current one, and then stores
//   them into its own buffer in shared memory (two, used in turn; 84 bytes
//   each, an odd count of words, so that the 32 lanes' bytes fall in 32
//   banks).  Every tile of a pair starts at the same offset in its word
//   (tiles start at multiples of 512), so a step reads its byte with one
//   LDS.U8 at a fixed offset past that lead.  A word that holds no live
//   byte of a tile is never read, so nothing outside the texts is.
// - Each step's mask is read kAhead steps before it (a ring of registers),
//   so the step waits on neither shared load: what is left is the
//   recurrence's own path, 7 dependent instructions a step as ptxas
//   emits it.
// - The steps past a tile's end run on stale bytes without touching the
//   minimum (one compare a step); a warp runs whole windows of its longest
//   tile.
// - Fold: each warp's minimum by __reduce_min_sync, the warps' through
//   shared memory, one plain store of out[p]: no memset and no atomics.
//   Thread 0 writes -1 for a pair out of range and max(m, 1) for an empty
//   text.
// myers_probe.py --pairs (at the repo's root) times other values of the
// constants below, and an earlier checkout's kernel, on the card.

constexpr int kPairWarps = 4;                       // warps a block (one pair)
constexpr int kPairLanes = 32 * kPairWarps;         // threads a block: the tiles of a round
constexpr int kWindow = 64;                         // steps between two refills of a buffer
constexpr int kAhead = 8;                           // steps a mask is loaded before its step
constexpr int kWindowWords = kWindow / 16 + 1;      // aligned 16-byte words a window spans
constexpr int kWindowStride = 16 * kWindowWords + 4;  // bytes a buffer: an odd count of words
constexpr int kHalfBytes = kPairLanes * kWindowStride;  // one buffer of every thread
constexpr int kPairSmem = 256 * 4 + 2 * kHalfBytes;

static_assert(kWindow % 16 == 0 && (kWindowStride / 4) % 2 == 1, "conflict-free buffers");
static_assert(15 + kWindow <= 16 * kWindowWords, "a window's steps lie in its words at any lead");
static_assert(kWindow % kAhead == 0 && 2 * kAhead <= kWindow, "masks ahead within a window");
static_assert(kPairSmem <= 48 * 1024, "above 48 KiB the launch needs cudaFuncSetAttribute");

struct PairArgs {
  const uint8_t* text;
  long long n_text;
  const int64_t* row_off;
  const int32_t* tlens;
  int n_texts;
  const uint32_t* masks;
  const int32_t* plens;
  int n_pat;
  const int32_t* pair_text;
  const int32_t* pair_pat;
  int n_pairs;
  int32_t* out;
};

// The block's shared memory: the pattern's masks (256 words), then the
// threads' buffers.  Named here so that every function reads it as shared
// memory (LDS), not through a generic pointer.
extern __shared__ __align__(16) uint8_t pair_smem[];

__device__ __forceinline__ const uint32_t* pair_masks() {
  return reinterpret_cast<const uint32_t*>(pair_smem);
}

// This thread's buffer in the first half.
__device__ __forceinline__ uint8_t* own_buffer() {
  return pair_smem + 256 * 4 + threadIdx.x * kWindowStride;
}

// What every thread of a block knows of its pair.
struct Pair {
  const uint8_t* base;  // the aligned word at or below the text's first byte
  int lead;             // the text's first byte in that word; every tile's, too
  int len;              // the text's bytes
  int m;                // max(plen, 1)
  uint32_t high;        // bit m - 1
};

// The aligned words of window k of the thread's tile: word i of the tile
// is the 16 bytes at src + 16 i; those at or past `words` (no live byte)
// are left zero, never read.
__device__ __forceinline__ void load_window(uint4 (&w)[kWindowWords], const uint8_t* src,
                                            int words, int k) {
#pragma unroll
  for (int i = 0; i < kWindowWords; ++i) {
    const int word = k * (kWindow / 16) + i;
    w[i] = word < words ? __ldg(reinterpret_cast<const uint4*>(src) + word)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Store a window's words into one of this thread's buffers.
__device__ __forceinline__ void store_window(uint8_t* buf, const uint4 (&w)[kWindowWords]) {
  uint32_t* b = reinterpret_cast<uint32_t*>(buf);
#pragma unroll
  for (int i = 0; i < kWindowWords; ++i) {
    b[4 * i] = w[i].x;
    b[4 * i + 1] = w[i].y;
    b[4 * i + 2] = w[i].z;
    b[4 * i + 3] = w[i].w;
  }
}

// The chain's state: the Myers vectors, the score, and the least score
// over the tile's live steps.
struct Chain {
  uint32_t pv, mv;
  int score, best;
};

// Step j of the chain, whose mask is eqs[r]; the mask kAhead steps on is
// read from *ahead into its place.  The minimum takes the score only
// while j < eff, the tile's live bytes.
__device__ __forceinline__ void step(int r, const uint8_t* ahead, int j, int eff,
                                     uint32_t (&eqs)[kAhead], Chain& c, uint32_t high) {
  const uint32_t eq = eqs[r];
  eqs[r] = pair_masks()[*ahead];
  const uint32_t xv = eq | c.mv;
  const uint32_t xh = (((eq & c.pv) + c.pv) ^ c.pv) | eq;
  uint32_t ph = c.mv | ~(xh | c.pv);
  uint32_t mh = c.pv & xh;
  c.score += ((ph & high) != 0u) - ((mh & high) != 0u);
  // search variant: row 0 is free, so shift without OR-ing in bit 0
  ph <<= 1;
  mh <<= 1;
  c.pv = mh | ~(xv | ph);
  c.mv = ph & xv;
  if (j < eff) c.best = min(c.best, c.score);
}

// The steps j0 .. j0 + kWindow - 1, step j0 + u reading the byte at cur[u]
// of the thread's buffer, unrolled whole (kept a loop of kAhead-step
// passes, ~8x less code, it runs slower: myers_probe.py's pairs_passes).
// Each step's mask was read kAhead steps before (eqs, a ring), so neither
// shared load waits in the step; for the last kAhead steps the masks
// ahead are the next window's, whose words (w) are stored into `next`
// first where `more`.
__device__ __forceinline__ void run_window(const uint8_t* cur, uint8_t* next, bool more,
                                           const uint4 (&w)[kWindowWords], int j0, int eff,
                                           uint32_t (&eqs)[kAhead], Chain& c, const Pair& q) {
#pragma unroll
  for (int u0 = 0; u0 < kWindow - kAhead; u0 += kAhead) {
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      step(r, cur + u0 + kAhead + r, j0 + u0 + r, eff, eqs, c, q.high);
    }
  }
  if (more) store_window(next, w);
#pragma unroll
  for (int r = 0; r < kAhead; ++r) {
    step(r, next + q.lead + r, j0 + kWindow - kAhead + r, eff, eqs, c, q.high);
  }
}

// The thread's tile in the round from tile t0: tile t0 + threadIdx.x.
// Returns its least score (m if it has none).
__device__ int run_round(int t0, const Pair& q) {
  const long long start =
      static_cast<long long>(t0 + static_cast<int>(threadIdx.x)) * kBlock;
  const int eff = static_cast<int>(min(max(q.len - start, 0LL), static_cast<long long>(kTile)));
  const int words = eff > 0 ? (q.lead + eff + 15) >> 4 : 0;
  const uint8_t* src = q.base + (eff > 0 ? start : 0);
  Chain c{~0u, 0u, q.m, q.m};
  const int steps = __reduce_max_sync(0xFFFFFFFFu, eff);  // the warp walks its longest tile
  uint8_t* own = own_buffer();
  uint4 w[kWindowWords];
  uint32_t eqs[kAhead];
  load_window(w, src, words, 0);
  store_window(own, w);
#pragma unroll
  for (int r = 0; r < kAhead; ++r) eqs[r] = pair_masks()[own[q.lead + r]];
  for (int k = 0; k * kWindow < steps; ++k) {
    const bool more = (k + 1) * kWindow < steps;
    if (more) load_window(w, src, words, k + 1);  // in flight over the window
    run_window(own + (k & 1) * kHalfBytes + q.lead, own + ((k + 1) & 1) * kHalfBytes, more, w,
               k * kWindow, eff, eqs, c, q);
  }
  return c.best;
}

__global__ void __launch_bounds__(kPairLanes) pairs_kernel(const PairArgs a) {
  __shared__ int warp_min[kPairWarps];
  const int p = blockIdx.x;
  const int ti = a.pair_text[p];
  const int pk = a.pair_pat[p];
  long long off = -1;
  int len = -1, plen = -1;
  if (ti >= 0 && ti < a.n_texts && pk >= 0 && pk < a.n_pat) {
    off = a.row_off[ti];
    len = a.tlens[ti];
    plen = a.plens[pk];
  }
  if (off < 0 || len < 0 || off + len > a.n_text || plen < 0 || plen > 32) {
    if (threadIdx.x == 0) a.out[p] = -1;
    return;
  }
  const int m = max(plen, 1);
  if (len == 0) {
    if (threadIdx.x == 0) a.out[p] = m;
    return;
  }
  uint32_t* pm = reinterpret_cast<uint32_t*>(pair_smem);
  for (int i = threadIdx.x; i < 256; i += kPairLanes) {
    pm[i] = __ldg(a.masks + static_cast<int64_t>(pk) * 256 + i);
  }
  __syncthreads();
  Pair q;
  const uint8_t* first = a.text + off;
  q.lead = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15);
  q.base = first - q.lead;
  q.len = len;
  q.m = m;
  q.high = 1u << (m - 1);
  const int tiles = (len - 1) / kBlock + 1;
  const int warp_first = static_cast<int>(threadIdx.x) & ~31;  // the warp's first tile
  int best = m;
  for (int t0 = 0; t0 + warp_first < tiles; t0 += kPairLanes) best = min(best, run_round(t0, q));
  best = __reduce_min_sync(0xFFFFFFFFu, best);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kPairWarps; ++w) best = min(best, warp_min[w]);
    a.out[p] = best;
  }
}

}  // namespace

extern "C" {

// See the header.  dist may be null; launches nothing for rows or n_pat 0.
int astt_myers_bound(const void* text, const void* row_off, const void* row_len,
                     const void* text_len, const void* flags, long long rows,
                     const void* masks, const void* plens, const void* ok, const void* cols,
                     int n_pat, float hundred_minus_t, void* mask, int n_names, void* dist,
                     void* stream) {
  if (rows <= 0 || n_pat <= 0) return 0;
  if (rows > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bound_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  int device = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bound_kernel, kPatterns,
                                                           kSmem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int groups = (n_pat + kPatterns - 1) / kPatterns;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // one wave: every resident block slot takes a share of the rows
  const int resident = sms * std::max(per_sm, 1);
  const int row_blocks = static_cast<int>(
      std::min<long long>(rows, std::max(1, resident / groups)));
  const dim3 grid(row_blocks, groups);
  Args a;
  a.text = static_cast<const uint8_t*>(text);
  a.row_off = static_cast<const int64_t*>(row_off);
  a.row_len = static_cast<const int32_t*>(row_len);
  a.text_len = static_cast<const int32_t*>(text_len);
  a.flags = static_cast<const int32_t*>(flags);
  a.rows = static_cast<int>(rows);
  a.masks = static_cast<const uint32_t*>(masks);
  a.plens = static_cast<const int32_t*>(plens);
  a.ok = static_cast<const uint8_t*>(ok);
  a.cols = static_cast<const int64_t*>(cols);
  a.n_pat = n_pat;
  a.hundred_minus_t = hundred_minus_t;
  a.mask = static_cast<uint8_t*>(mask);
  a.n_names = n_names;
  a.dist = static_cast<int32_t*>(dist);
  a.one = 1u;
  a.two = 2u;
  a.stride = kPatterns * 4u;
  bound_kernel<<<grid, kPatterns, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The chains each thread runs.
int astt_myers_chains(void) { return kChains; }

// See myers_pairs above: a block a pair.  Launches nothing for n_pairs 0.
int astt_myers_pairs(const void* text, long long n_text, const void* row_off, const void* tlens,
                     int n_texts, const void* masks, const void* plens, int n_pat,
                     const void* pair_text, const void* pair_pat, int n_pairs, void* out,
                     void* stream) {
  if (n_pairs <= 0) return 0;
  PairArgs a;
  a.text = static_cast<const uint8_t*>(text);
  a.n_text = n_text;
  a.row_off = static_cast<const int64_t*>(row_off);
  a.tlens = static_cast<const int32_t*>(tlens);
  a.n_texts = n_texts;
  a.masks = static_cast<const uint32_t*>(masks);
  a.plens = static_cast<const int32_t*>(plens);
  a.n_pat = n_pat;
  a.pair_text = static_cast<const int32_t*>(pair_text);
  a.pair_pat = static_cast<const int32_t*>(pair_pat);
  a.n_pairs = n_pairs;
  a.out = static_cast<int32_t*>(out);
  pairs_kernel<<<n_pairs, kPairLanes, kPairSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* astt_myers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
