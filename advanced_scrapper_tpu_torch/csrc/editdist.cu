// The matcher's Myers alignment bound with its prune compare fused in, by
// hand for Hopper (sm_90a): Kernel F.
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
// computed and d written to dist int32[rows, K]; without it, pairs the
// gates exclude are skipped (the bit is the same either way).
//
// Bound: operations.  Each live byte of each tile costs ~15 INT32
// operations per pattern (the mask lookup, xv, the carry add and its
// three logic ops, ph, mh, two high-bit tests and the score update, two
// shifts, pv, mv, the min); at S&P scale, 20,000 rows of ~2 kB against
// ~3,500 refine patterns, that is ~1.5e11 steps, ~2e12 operations, tens of
// ms at the card's INT32 rate.  The bytes (the text once, the masks, the
// mask bytes) are small beside it.
//
// Design (the simple one): a block of 128 threads holds 128 patterns, one
// per thread, with their masks for the ASCII bytes in shared memory laid
// out [byte][pattern] (64 KiB), so the 32 lanes of a warp read 32
// consecutive words for one text byte, without bank conflicts; a byte of
// 128 or more reads the pattern's mask from global memory (rare: refine
// names are ASCII, and rows are gated on ASCII text).  The grid is one
// wave: blockIdx.y picks the pattern group, blockIdx.x strides over rows.
// The block stages each tile's bytes in shared memory; each thread runs
// the Myers recurrence of its pattern over the tile, the text read four
// bytes to a load, and keeps the min over the row's tiles in a register.
// Rows that no pattern of the group needs (gated mode) are skipped by the
// whole block.  More patterns per thread or tiles interleaved per thread
// (more independent chains for the ALU pipes) are work for a later PR.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kPatterns = 128;               // threads per block, one pattern each
constexpr int kBlock = 512;                  // tile stride
constexpr int kTile = kBlock + 31;           // live bytes of a tile at most
constexpr int kTileBytes = (kTile + 3) / 4 * 4;
constexpr int kAscii = 128;                  // mask rows held in shared memory
constexpr int kSmem = kAscii * kPatterns * 4 + kTileBytes;

__global__ void __launch_bounds__(kPatterns) bound_kernel(
    const uint8_t* __restrict__ text, const int64_t* __restrict__ row_off,
    const int32_t* __restrict__ row_len, const int32_t* __restrict__ text_len,
    const int32_t* __restrict__ flags, int rows, const uint32_t* __restrict__ masks,
    const int32_t* __restrict__ plens, const uint8_t* __restrict__ ok,
    const int64_t* __restrict__ cols, int n_pat, float hundred_minus_t,
    uint8_t* __restrict__ mask, int n_names, int32_t* __restrict__ dist) {
  extern __shared__ uint32_t smem[];
  uint32_t* eqs = smem;  // [kAscii][kPatterns]
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem + kAscii * kPatterns);
  const int k = blockIdx.y * kPatterns + threadIdx.x;
  const bool has_pattern = k < n_pat;
  for (int i = threadIdx.x; i < kAscii * kPatterns; i += kPatterns) {
    const int p = i / kAscii;
    const int c = i % kAscii;  // consecutive threads read consecutive bytes' words
    const int kk = blockIdx.y * kPatterns + p;
    eqs[c * kPatterns + p] = kk < n_pat ? masks[static_cast<int64_t>(kk) * 256 + c] : 0u;
  }
  const int plen = has_pattern ? plens[k] : 0;
  const int m = max(plen, 1);
  const uint32_t high = 1u << (m - 1);
  const bool pat_ok = has_pattern && ok[k] != 0;
  const int64_t col = has_pattern ? cols[k] : 0;
  const uint32_t* gmask = masks + static_cast<int64_t>(has_pattern ? k : 0) * 256;
  const float rhs = __fmul_rn(2.0f * static_cast<float>(plen), hundred_minus_t);
  const bool every_pair = dist != nullptr;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const bool pair = pat_ok && text_len[row] > plen && (flags[row] & 1) != 0;
    if (!__syncthreads_or(every_pair || pair)) continue;  // uniform: nobody needs it
    const bool run = has_pattern && (every_pair || pair);
    const int len = row_len[row];
    const uint8_t* r = text + row_off[row];
    int best = m;
    for (int start = 0; start < len; start += kBlock) {
      const int eff = min(len - start, kTile);
      __syncthreads();  // the previous tile's readers are done
      for (int i = threadIdx.x; i < kTileBytes; i += kPatterns) {
        tile[i] = i < eff ? r[start + i] : 0;
      }
      __syncthreads();
      if (!run) continue;
      uint32_t pv = ~0u;
      uint32_t mv = 0u;
      int score = m;
      for (int j0 = 0; j0 < eff; j0 += 4) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(tile + j0);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (j0 + b < eff) {  // uniform over the block
            const uint32_t c = (word >> (8 * b)) & 0xFFu;
            const uint32_t eq = c < kAscii ? eqs[c * kPatterns + threadIdx.x] : __ldg(gmask + c);
            const uint32_t xv = eq | mv;
            const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
            uint32_t ph = mv | ~(xh | pv);
            uint32_t mh = pv & xh;
            score += ((ph & high) != 0u) - ((mh & high) != 0u);
            ph <<= 1;
            mh <<= 1;
            pv = mh | ~(xv | ph);
            mv = ph & xv;
            best = min(best, score);
          }
        }
      }
    }
    if (run && every_pair) dist[static_cast<int64_t>(row) * n_pat + k] = best;
    if (run && pair && __fmul_rn(static_cast<float>(best), 100.0f) >= rhs) {
      uint8_t* cell = mask + static_cast<int64_t>(row) * n_names + col;
      *cell = static_cast<uint8_t>(*cell | 2u);  // one thread per cell: no race
    }
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
  bound_kernel<<<grid, kPatterns, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const int64_t*>(row_off),
      static_cast<const int32_t*>(row_len), static_cast<const int32_t*>(text_len),
      static_cast<const int32_t*>(flags), static_cast<int>(rows),
      static_cast<const uint32_t*>(masks), static_cast<const int32_t*>(plens),
      static_cast<const uint8_t*>(ok), static_cast<const int64_t*>(cols), n_pat,
      hundred_minus_t, static_cast<uint8_t*>(mask), n_names, static_cast<int32_t*>(dist));
  return static_cast<int>(cudaGetLastError());
}

const char* astt_myers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
