// The matcher's q-gram screen, by hand for Hopper (sm_90a): Kernel E.
//
// Replaces the reference's jnp screen,
// advanced_scrapper_tpu/ops/match.py:_screen_core (reached by
// make_screen_step and _screen_impl).  There is no Pallas original; XLA
// builds a [rows, 2^15] bitmap and a [rows, names, 96] gather there.
//
// Input: the chunk's rows ragged in one text, as the port's matcher holds
// them (row r is row_len[r] bytes at row_off[r]: title "\n" text, utf-8),
// the parts' lengths text_len / title_len, and the names' tables of
// ops/match.py:screen_tensors: kept / total / name_len int32[N] and fuzzy
// uint8[N] in the index's name order, and the layout the kernel reads the
// grams in (ops/match.py:screen_layout).  Within each tile of tile_cols
// columns the names are sorted by kept-gram count and dealt to groups of
// 32 (a warp's lanes); slot_col int32[G*32] is each slot's column (-1 for
// a padding slot), group_off int32[G+1] each group's first gram step and
// grams_il uint16[group_off[G]*32] gram j of the group's 32 names side by
// side, padded to the group's longest name with gram 2^15, which no row
// has; tile_groups int32[T+1] the groups of each tile.  A gram repeated in
// a name is counted once per occurrence, as the reference's gather counts
// it.  Output: out uint8[rows, N], 1 where the (row, name) pair survives,
// else 0, in the index's column order:
//
//   bitmap  = { fmix32(FNV-1a(row[p .. p+2])) mod 2^15 : p < len - 2 }
//   count   = the name's kept grams present in bitmap
//   fuzzy:  bound(D) = D >= m ? kept - 3*floor(m*frac)
//                             : truncated ? 0 : (D - 2) - 3*floor(min(D,m)*frac)
//           req = min(bound(text_len), bound(title_len))
//           keep = req <= 0 || count >= max(req, 1)
//   exact:  keep = count >= kept && max(text_len, title_len) >= m
//
// which is keep = count >= min(b(text_len), b(title_len)) with b(D) = D >= m
// ? long : short(D): long is kept - 3*floor(m*frac) (fuzzy) or kept
// (exact); short(D) = (D - 2) - 3*floor(D*frac) for a fuzzy name, 0 for a
// truncated one and "never" for an exact one (a count is never negative,
// so req <= 0 keeps).  frac is float32 and comes from the host
// (ops/match.py:screen_frac, which reproduces the reference's rounding);
// the products are __fmul_rn, so no contraction can move a floor.
//
// Bound: bytes are small (the text once, the name tables, one mask byte
// per pair); operations are the hashes (~16 per window), the bitmap
// probes (one per (row, kept gram)) and the bounds (~16 per pair), so
// operations bound it.
//
// Design.  A block takes kRows = 32 rows and builds one row-sliced bitmap in
// shared memory: entry b is a uint32 whose bit r says that row r of the
// block has gram b (128 KiB, dynamic shared memory, one block of 1,024
// threads an SM).  The rows' bytes are cut into 16-byte-aligned chunks,
// flattened over the block's threads: one 16-byte load brings the 16 windows
// that start in a chunk (the loads miss to device memory, so a thread waits
// once per 16 windows, not per window), each window hashed and ORed in with
// an atomic.  A row's first and last chunk reach up to 15 bytes outside the
// row (and the text), within its aligned 16 bytes, which no allocation ends
// inside; those windows are skipped.  Then each warp takes groups of 32
// names (sorted by gram count, so a warp's lanes run about as long as each
// other): one coalesced uint16 load of a gram and one shared load answer it
// for all 32 rows, counted in SWAR: four registers of nibble counters (n_k
// += (v >> k) & 0x11111111 counts rows 4i + k in nibble i), folded every 15
// grams into eight registers of byte counters (a name has at most 127 kept
// grams, MAX_GRAMS is 96).  The bounds then give each name a 32-bit keep
// mask over the block's rows: where every part of the block's rows is at
// least the name's m bytes long (most names against most blocks) the
// requirement is one number, compared with the byte counters in SWAR, four
// rows an instruction; else one requirement a row.  The masks are staged in
// shared memory by column; once a tile's names are done the block writes its
// rows' mask bytes out column after column, consecutive threads on
// consecutive bytes. So the name tables are read once per 32 rows, not once
// per row as a block-per-row design reads them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 3;
constexpr int kBits = 1 << 15;
using Entry = uint32_t;  // one bit per row of the block
constexpr int kThreads = 1024;
constexpr int kMinBlocks = 1;
constexpr int kRows = 8 * sizeof(Entry);
constexpr int kPerWord = 4 / static_cast<int>(sizeof(Entry));
constexpr int kEntries = kBits + 16;  // entry kBits is the padding gram's, never set
constexpr int kLanes = 32;
constexpr int kFlush = 15;          // grams a nibble counter holds
constexpr int kNever = 1 << 20;     // a requirement no count meets
constexpr int kMaxCount = 127;      // kept grams a name may have: byte counters, SWAR compares
constexpr uint32_t kNibbles = 0x11111111u;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;

static_assert(kRows <= kLanes, "one warp scans the block's rows");
static_assert((kEntries * sizeof(Entry)) % 16 == 0, "the bitmap is cleared in 16-byte stores");

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The fuzzy names' gram bound for a part of D < m bytes (reference :126-134).
__device__ __forceinline__ int short_bound(int D, float frac) {
  const int dmax = static_cast<int>(floorf(__fmul_rn(static_cast<float>(D), frac)));
  return (D - kQ + 1) - kQ * dmax;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) screen_kernel(
    const uint8_t* __restrict__ text, const int64_t* __restrict__ row_off,
    const int32_t* __restrict__ row_len, const int32_t* __restrict__ text_len,
    const int32_t* __restrict__ title_len, long long rows, const int32_t* __restrict__ slot_col,
    const int32_t* __restrict__ group_off, const uint16_t* __restrict__ grams_il,
    const int32_t* __restrict__ tile_groups, int tile_cols, const int32_t* __restrict__ kept,
    const int32_t* __restrict__ total, const int32_t* __restrict__ name_len,
    const uint8_t* __restrict__ fuzzy, int n_names, float frac, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* bitmap = reinterpret_cast<Entry*>(smem);
  Entry* keep = bitmap + kEntries;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  __shared__ int4 rowv[kRows];  // text_len, short_bound(text_len), title_len, its short_bound
  __shared__ int chunk_end[kRows];         // the running sum of the rows' chunks
  __shared__ const uint8_t* first[kRows];  // each row's first chunk: 16-byte aligned
  __shared__ int lead[kRows];              // the row's bytes before it in that chunk
  __shared__ int nwin[kRows];              // the row's windows
  __shared__ int min_part;  // the shortest text or title of the block's rows

  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int nrows = static_cast<int>(min(static_cast<long long>(kRows), rows - row0));
  uint4* clear = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < kEntries * static_cast<int>(sizeof(Entry)) / 16; i += kThreads)
    clear[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x < kLanes) {  // the block's rows and their chunks' running sum
    const int r = threadIdx.x;
    int tl = 0, ttl = 0, win = 0, lead_bytes = 0;
    const uint8_t* start = text;
    if (r < nrows) {
      tl = text_len[row0 + r];
      ttl = title_len[row0 + r];
      win = max(row_len[row0 + r] - (kQ - 1), 0);
      const uint8_t* row_start = text + row_off[row0 + r];
      start = reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(row_start) & ~uintptr_t{15});
      lead_bytes = static_cast<int>(row_start - start);
    }
    int ends = win > 0 ? (lead_bytes + win + 15) / 16 : 0;
    for (int d = 1; d < kLanes; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, ends, d);
      if (r >= d) ends += v;
    }
    if (r < kRows) {
      rowv[r] = make_int4(tl, short_bound(tl, frac), ttl, short_bound(ttl, frac));
      chunk_end[r] = ends;
      first[r] = start;
      lead[r] = lead_bytes;
      nwin[r] = win;
    }
    const int part = __reduce_min_sync(0xFFFFFFFFu, r < nrows ? min(tl, ttl) : 0x7FFFFFFF);
    if (r == 0) min_part = part;
  }
  __syncthreads();

  // the bitmap: the rows' 16-byte-aligned chunks flattened over the block's
  // threads, one 16-byte load (and two byte loads past it where a window
  // reaches there) for the 16 windows that start in a chunk
  const int chunks = chunk_end[kRows - 1];
  int r = 0, cstart = 0, cend = chunk_end[0];
  for (int q = threadIdx.x; q < chunks; q += kThreads) {
    while (q >= cend) {
      cstart = cend;
      cend = chunk_end[++r];
    }
    const uint8_t* a = first[r] + 16 * (q - cstart);
    const int rel = 16 * (q - cstart) - lead[r];  // the row's window at byte 0 of the chunk
    const int nw = nwin[r];
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(a));
    const uint32_t b16 = rel + 14 < nw ? __ldg(a + 16) : 0u;
    const uint32_t b17 = rel + 15 < nw ? __ldg(a + 17) : 0u;
    const uint32_t w[5] = {v.x, v.y, v.z, v.w, b16 | (b17 << 8)};
    const uint32_t row_bit = 1u << r;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (rel + j < 0 || rel + j >= nw) continue;
      uint32_t h = kFnvOffset;
      h = (h ^ ((w[j >> 2] >> (8 * (j & 3))) & 0xFFu)) * kFnvPrime;
      h = (h ^ ((w[(j + 1) >> 2] >> (8 * ((j + 1) & 3))) & 0xFFu)) * kFnvPrime;
      h = (h ^ ((w[(j + 2) >> 2] >> (8 * ((j + 2) & 3))) & 0xFFu)) * kFnvPrime;
      const uint32_t bit = fmix32(h) & (kBits - 1);
      atomicOr(&words[bit / kPerWord], row_bit << ((bit % kPerWord) * kRows));
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n_tiles = (n_names + tile_cols - 1) / tile_cols;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * tile_cols;
    const int g1 = tile_groups[t + 1];
    for (int g = tile_groups[t] + warp; g < g1; g += kThreads / kLanes) {
      const int col = slot_col[g * kLanes + lane];
      const int j0 = group_off[g], len = group_off[g + 1] - j0;
      const uint16_t* gp = grams_il + static_cast<long long>(j0) * kLanes + lane;
      uint32_t lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};  // byte counters
      for (int a = 0; a < len; a += kFlush) {
        const int b = min(a + kFlush, len);
        uint32_t n0 = 0, n1 = 0, n2 = 0, n3 = 0;  // nibble counters
#pragma unroll 4
        for (int j = a; j < b; ++j) {
          const uint32_t v = bitmap[__ldg(gp + j * kLanes)];
          n0 += v & kNibbles;
          n1 += (v >> 1) & kNibbles;
          n2 += (v >> 2) & kNibbles;
          n3 += (v >> 3) & kNibbles;
        }
        lo[0] += n0 & 0x0F0F0F0Fu;
        hi[0] += (n0 >> 4) & 0x0F0F0F0Fu;
        lo[1] += n1 & 0x0F0F0F0Fu;
        hi[1] += (n1 >> 4) & 0x0F0F0F0Fu;
        lo[2] += n2 & 0x0F0F0F0Fu;
        hi[2] += (n2 >> 4) & 0x0F0F0F0Fu;
        lo[3] += n3 & 0x0F0F0F0Fu;
        hi[3] += (n3 >> 4) & 0x0F0F0F0Fu;
      }
      if (col >= 0) {
        const int k = __ldg(kept + col);
        const int m = __ldg(name_len + col);
        int lng = k, mul = 0, add = kNever;  // exact: every gram, a part of m bytes
        if (__ldg(fuzzy + col)) {
          lng = k - kQ * static_cast<int>(floorf(__fmul_rn(static_cast<float>(m), frac)));
          mul = k < __ldg(total + col) ? 0 : 1;  // truncated: 0 below m
          add = 0;
        }
        Entry mask = 0;
        if (m <= min_part) {
          // every part is m bytes or more: req = long for every row, and the
          // byte counters (< 128) compare in SWAR, bit 7 of a byte of
          // (count | 0x80) - req set where count >= req; row 8b + k is byte b
          // of lo[k], row 8b + 4 + k byte b of hi[k]
          const uint32_t need = static_cast<uint32_t>(min(max(lng, 0), kMaxCount + 1)) * 0x01010101u;
          uint32_t bits = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            bits |= (((lo[k] | 0x80808080u) - need) & 0x80808080u) >> (7 - k);
            bits |= (((hi[k] | 0x80808080u) - need) & 0x80808080u) >> (3 - k);
          }
          mask = static_cast<Entry>(bits);
        } else {
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {  // row rr = 4i + k: nibble i of n_k
            const int4 rv = rowv[rr];
            const int bt = rv.x >= m ? lng : rv.y * mul + add;
            const int btt = rv.z >= m ? lng : rv.w * mul + add;
            const uint32_t c = (((rr >> 2) & 1) ? hi[rr & 3] : lo[rr & 3]) >> (8 * (rr >> 3)) & 0xFFu;
            mask |= static_cast<Entry>(static_cast<int>(c) >= min(bt, btt)) << rr;
          }
        }
        keep[col - c0] = mask;
      }
    }
    __syncthreads();
    const int cols = min(tile_cols, n_names - c0);
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      const Entry bits = keep[c];
      uint8_t* o = out + row0 * n_names + c0 + c;
      for (int rr = 0; rr < nrows; ++rr) o[static_cast<long long>(rr) * n_names] = (bits >> rr) & 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// See the header.  rows, n_names >= 0; launches nothing when either is 0.
int astt_match_screen(const void* text, const void* row_off, const void* row_len,
                      const void* text_len, const void* title_len, long long rows,
                      const void* slot_col, const void* group_off, const void* grams_il,
                      const void* tile_groups, int tile_cols, const void* kept, const void* total,
                      const void* name_len, const void* fuzzy, int n_names, float frac, void* out,
                      void* stream) {
  if (rows <= 0 || n_names <= 0) return 0;
  if (tile_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(kEntries) + tile_cols) * sizeof(Entry);
  cudaError_t err = cudaFuncSetAttribute(screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  screen_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const int64_t*>(row_off),
      static_cast<const int32_t*>(row_len), static_cast<const int32_t*>(text_len),
      static_cast<const int32_t*>(title_len), rows, static_cast<const int32_t*>(slot_col),
      static_cast<const int32_t*>(group_off), static_cast<const uint16_t*>(grams_il),
      static_cast<const int32_t*>(tile_groups), tile_cols, static_cast<const int32_t*>(kept),
      static_cast<const int32_t*>(total), static_cast<const int32_t*>(name_len),
      static_cast<const uint8_t*>(fuzzy), n_names, frac, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int astt_match_rows_per_block(void) { return kRows; }

const char* astt_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
