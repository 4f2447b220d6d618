// The matcher's q-gram screen, by hand for Hopper (sm_90a): Kernel E.
//
// Replaces the reference's jnp screen,
// advanced_scrapper_tpu/ops/match.py:_screen_core (reached by
// make_screen_step and _screen_impl).  There is no Pallas original; XLA
// builds a [rows, 2^15] bitmap and a [rows, names, 96] gather there.
//
// Input: the chunk's rows ragged in one text, as the port's matcher holds
// them (row r is row_len[r] bytes at row_off[r]: title "\n" text, utf-8),
// the parts' lengths text_len / title_len, and the names as a CSR table of
// their kept gram indices (gram_off int32[N+1], grams uint16, repeats kept
// and counted once each, as the reference's gather counts them), with
// kept / total / name_len int32[N] and fuzzy uint8[N].  Output: out
// uint8[rows, N], 1 where the (row, name) pair survives, else 0:
//
//   bitmap  = { fmix32(FNV-1a(row[p .. p+2])) mod 2^15 : p < len - 2 }
//   count   = the name's kept grams present in bitmap
//   fuzzy:  bound(D) = D >= m ? kept - 3*floor(m*frac)
//                             : truncated ? 0 : (D - 2) - 3*floor(min(D,m)*frac)
//           req = min(bound(text_len), bound(title_len))
//           keep = req <= 0 || count >= max(req, 1)
//   exact:  keep = count >= kept && max(text_len, title_len) >= m
//
// frac is float32 and comes from the host (ops/match.py:screen_frac, which
// reproduces the reference's rounding); the products are __fmul_rn, so no
// contraction can move a floor.
//
// Bound: bytes are small (the text once, the name tables, one mask byte
// per pair); operations are the hashes (~16 per window) and the bitmap
// probes (~4 per (row, kept gram)) and the bounds (~16 per pair) at the
// INT32 rate, so operations bound it: at 20,000 rows of ~2 kB against
// ~4,700 names of ~15 grams that is ~1.4e9 probes, well under a
// millisecond of the card's INT32 rate.
//
// Design (the simple one): a block per row.  The row's 4 KiB bitmap is
// built in shared memory with atomicOr from the row's windows, read
// straight from the device-resident text; then each thread walks names at
// a stride of the block, counts its name's grams from the CSR table (which
// stays in L2: ~70k uint16 grams at S&P scale) with one shared-memory
// probe each, applies the bounds and stores one byte (consecutive threads,
// consecutive bytes).  Reading the tables once for several rows per block
// is work for a later PR.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 3;
constexpr int kBits = 1 << 15;
constexpr int kWords = kBits / 32;
constexpr int kThreads = 256;
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

// The fuzzy names' gram bound for a part of D bytes (reference :126-134).
__device__ __forceinline__ int fuzzy_bound(int D, int m, int kept, int dmax_m, bool truncated,
                                           float frac) {
  if (D >= m) return kept - kQ * dmax_m;
  if (truncated) return 0;
  const int dmax = static_cast<int>(floorf(__fmul_rn(static_cast<float>(min(D, m)), frac)));
  return (D - kQ + 1) - kQ * dmax;
}

__global__ void __launch_bounds__(kThreads) screen_kernel(
    const uint8_t* __restrict__ text, const int64_t* __restrict__ row_off,
    const int32_t* __restrict__ row_len, const int32_t* __restrict__ text_len,
    const int32_t* __restrict__ title_len, const int32_t* __restrict__ gram_off,
    const uint16_t* __restrict__ grams, const int32_t* __restrict__ kept,
    const int32_t* __restrict__ total, const int32_t* __restrict__ name_len,
    const uint8_t* __restrict__ fuzzy, int n_names, float frac, uint8_t* __restrict__ out) {
  __shared__ uint32_t bitmap[kWords];
  const int64_t row = blockIdx.x;
  for (int w = threadIdx.x; w < kWords; w += kThreads) bitmap[w] = 0;
  __syncthreads();
  const uint8_t* r = text + row_off[row];
  const int windows = row_len[row] - (kQ - 1);
  for (int p = threadIdx.x; p < windows; p += kThreads) {
    uint32_t h = kFnvOffset;
    h = (h ^ r[p]) * kFnvPrime;
    h = (h ^ r[p + 1]) * kFnvPrime;
    h = (h ^ r[p + 2]) * kFnvPrime;
    const uint32_t bit = fmix32(h) & (kBits - 1);
    atomicOr(&bitmap[bit >> 5], 1u << (bit & 31));
  }
  __syncthreads();
  const int tl = text_len[row];
  const int ttl = title_len[row];
  const int part_max = max(tl, ttl);
  uint8_t* o = out + row * n_names;
  for (int n = threadIdx.x; n < n_names; n += kThreads) {
    const int g1 = __ldg(gram_off + n + 1);
    int count = 0;
    for (int g = __ldg(gram_off + n); g < g1; ++g) {
      const uint32_t b = __ldg(grams + g);
      count += (bitmap[b >> 5] >> (b & 31)) & 1u;
    }
    const int k = __ldg(kept + n);
    const int m = __ldg(name_len + n);
    bool keep;
    if (__ldg(fuzzy + n)) {
      const bool truncated = k < __ldg(total + n);
      const int dmax_m = static_cast<int>(floorf(__fmul_rn(static_cast<float>(m), frac)));
      const int req = min(fuzzy_bound(tl, m, k, dmax_m, truncated, frac),
                          fuzzy_bound(ttl, m, k, dmax_m, truncated, frac));
      keep = req <= 0 || count >= max(req, 1);
    } else {
      keep = count >= k && part_max >= m;
    }
    o[n] = keep ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// See the header.  rows, n_names >= 0; launches nothing when either is 0.
int astt_match_screen(const void* text, const void* row_off, const void* row_len,
                      const void* text_len, const void* title_len, long long rows,
                      const void* gram_off, const void* grams, const void* kept,
                      const void* total, const void* name_len, const void* fuzzy,
                      int n_names, float frac, void* out, void* stream) {
  if (rows <= 0 || n_names <= 0) return 0;
  if (rows > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  screen_kernel<<<static_cast<unsigned>(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const int64_t*>(row_off),
      static_cast<const int32_t*>(row_len), static_cast<const int32_t*>(text_len),
      static_cast<const int32_t*>(title_len), static_cast<const int32_t*>(gram_off),
      static_cast<const uint16_t*>(grams), static_cast<const int32_t*>(kept),
      static_cast<const int32_t*>(total), static_cast<const int32_t*>(name_len),
      static_cast<const uint8_t*>(fuzzy), n_names, frac, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* astt_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
