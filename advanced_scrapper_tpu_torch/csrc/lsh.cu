// The LSH epilogues by hand for Hopper (sm_90a): band keys, candidate run
// heads, edge verification and component labels.
//
// Replaces the jnp device code of advanced_scrapper_tpu/ops/lsh.py, which
// XLA fuses into one dispatch (fused_resolve_epilogue, :376) and which the
// port ran as ~100 PyTorch launches with [B, 8, P] int32 transients:
//   lsh_keys       fused_keys_epilogue (:416), band_keys (:56),
//                  band_keys_wide (:68), _coarse_fine_keys (:332),
//                  _fold_bands (:39);
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
//   and packed sort keys: bytes (~17 us at 3.35 TB/s).  A thread a key:
//   it folds P/nb consecutive words of its row (the row's 512 bytes are
//   read once from memory and then hit L1), XORs the salt, applies
//   fmix32, all uint32 with wrap-around.  The salts travel in the launch's
//   parameter buffer (a 2 KiB struct by value): no copy to the card.
// - lsh_run_heads reads the sorted packed keys once and writes
//   int32[B, 3 nbt]: bytes.  Runs can be long (all padding rows share one
//   U32_MAX run), so no thread walks a run: a block takes a tile of 2,048
//   sorted positions, finds the run start of its first position by one
//   binary search, and a block-wide max-scan of run starts gives every
//   position its run start.  Predecessors compare neighbouring keys.
// - lsh_verify gathers nc candidate rows per row from the 32 MiB signature
//   matrix, which stays in the 50 MB L2: a warp a row, a lane a word of P,
//   the equal words counted with one warp reduction a candidate.  Bound by
//   the 4.8 GB gathered through L2 at this shape; the bytes it must move
//   from memory are the signatures, candidates and outputs once.  The
//   agreement is count / P in float32 (__fdiv_rn, no fast math) against
//   the bar in float32, as the reference compares.
// - lsh_label runs the reference's rounds (pull the min along ok edges,
//   scatter-min it back, pointer-double) as two launches a round over
//   three int32[B] buffers: the pull reads X and atomicMins into Z (Z
//   starts as X, which every value written is at most), the jump reads Z
//   and writes X and the next round's Z.  Nothing is read from a buffer
//   being written, so truncated rounds give the reference's labels.  A
//   round that changed nothing leaves a zero flag, and the later rounds'
//   launches return at once: each of them would change nothing either.

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
constexpr int kHeadItems = 8;
constexpr int kHeadTile = kThreads * kHeadItems;
constexpr unsigned kFull = 0xFFFFFFFFu;

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

__device__ __forceinline__ uint32_t fold(const uint32_t* w, int r, uint32_t k, uint32_t prime) {
  for (int i = 0; i < r; ++i) k = (k ^ __ldg(w + i)) * prime;
  return k;
}

// A thread a (row, key set): key sets 0..nb-1 fold P/nb words each with
// salts[j], sets nb..nb+nf-1 fold P/nf words with salts[j]; wide: lane 1
// beside lane 0 (nf = 0), out int64[B, nb, 2].  With packed, also
// packed[j, b] = ((valid[b] ? key : U32_MAX) << row_bits) | b.
__global__ void keys_kernel(const uint32_t* __restrict__ sig, int B, int P, int nb, int nf,
                            const Salts salts, int wide, int64_t* __restrict__ keys,
                            const bool* __restrict__ valid, int row_bits,
                            int64_t* __restrict__ packed) {
  const int nk = nb + nf;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * nk) return;
  const int b = static_cast<int>(t / nk);
  const int j = static_cast<int>(t - static_cast<long long>(b) * nk);
  const int r = j < nb ? P / nb : P / nf;
  const int start = j < nb ? j * r : (j - nb) * r;
  const uint32_t* w = sig + static_cast<size_t>(b) * P + start;
  const uint32_t salt = salts.v[j];
  const uint32_t lo = fmix32(fold(w, r, kFnvOffset, kFnvPrime) ^ salt);
  if (wide) {
    const uint32_t rot = (salt << 13) | (salt >> 19);
    const uint32_t hi = fmix32(fold(w, r, kWideOffset, kWidePrime) ^ rot);
    keys[2 * t] = lo;
    keys[2 * t + 1] = hi;
    return;
  }
  keys[t] = lo;
  if (packed != nullptr) {
    const int64_t k = valid[b] ? static_cast<int64_t>(lo) : kU32Max;
    packed[static_cast<size_t>(j) * B + b] = (k << row_bits) | b;
  }
}

// The packing alone, from keys already made: packed[j, b] as above.
__global__ void pack_kernel(const int64_t* __restrict__ keys, int B, int nk,
                            const bool* __restrict__ valid, int row_bits,
                            int64_t* __restrict__ packed) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * nk) return;
  const int b = static_cast<int>(t / nk);
  const int j = static_cast<int>(t - static_cast<long long>(b) * nk);
  const int64_t k = valid[b] ? keys[t] : kU32Max;
  packed[static_cast<size_t>(j) * B + b] = (k << row_bits) | b;
}

// Block (tile, band): sorted int64[nbt, B] (each band ascending) ->
// out[row, band], out[row, nbt + band], out[row, 2 nbt + band]: run head,
// predecessor, predecessor² (self where there is none; self for invalid
// rows).  key = packed >> row_bits, row = packed & mask.
__global__ void __launch_bounds__(kThreads)
run_heads_kernel(const int64_t* __restrict__ sorted, const bool* __restrict__ valid, int B,
                 int nbt, int row_bits, int32_t* __restrict__ out) {
  const int band = blockIdx.y;
  const int64_t* s = sorted + static_cast<size_t>(band) * B;
  const int lo = blockIdx.x * kHeadTile;
  const int64_t mask = (int64_t{1} << row_bits) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ int carry;
  __shared__ int warp_max[kThreads / 32];
  if (threadIdx.x == 0) {
    // the first position in [0, lo] whose key equals the tile's first key
    const int64_t target = (s[lo] >> row_bits) << row_bits;
    int a = 0, z = lo;
    while (a < z) {
      const int m = (a + z) >> 1;
      if (s[m] < target) a = m + 1; else z = m;
    }
    carry = a;
  }
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
  const int nc = 3 * nbt;
#pragma unroll
  for (int i = 0; i < kHeadItems; ++i) {
    const int p = p0 + i;
    if (p >= B) break;
    const int64_t v = s[p];
    const int64_t key = v >> row_bits;
    const int row = static_cast<int>(v & mask);
    int32_t* o = out + static_cast<size_t>(row) * nc + band;
    if (!valid[row]) {
      o[0] = o[nbt] = o[2 * nbt] = row;
      continue;
    }
    const int rs = max(before, starts[i]);
    o[0] = static_cast<int32_t>(s[rs] & mask);
    const int64_t v1 = p >= 1 ? s[p - 1] : -1;
    const int64_t v2 = p >= 2 ? s[p - 2] : -1;
    o[nbt] = p >= 1 && (v1 >> row_bits) == key ? static_cast<int32_t>(v1 & mask) : row;
    o[2 * nbt] = p >= 2 && (v2 >> row_bits) == key ? static_cast<int32_t>(v2 & mask) : row;
  }
}

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

// True when column c of row b is a fine column whose candidate j shares no
// coarse key with b (the reference's _fine_only_chunks).
__device__ __forceinline__ bool fine_only(const VerifyArgs& a, int b, int c, int j) {
  if (c % a.nk < a.num_coarse) return false;
  const int64_t* kb = a.keys + static_cast<size_t>(b) * a.nk;
  const int64_t* kj = a.keys + static_cast<size_t>(j) * a.nk;
  for (int i = 0; i < a.num_coarse; ++i) {
    if (kb[i] == kj[i]) return false;
  }
  return true;
}

// A warp a row: lane l takes column c0 + l of each group of 32 columns;
// the warp counts the agreement of every column's candidate in turn.
__global__ void __launch_bounds__(kThreads) verify_kernel(const VerifyArgs a) {
  const int b = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  if (b >= a.B) return;
  const int lane = threadIdx.x & 31;
  const uint32_t* sb = a.sig != nullptr ? a.sig + static_cast<size_t>(b) * a.P : nullptr;
  const bool vb = a.valid != nullptr && a.valid[b];
  const float fp = static_cast<float>(a.P);
  for (int c0 = 0; c0 < a.nc; c0 += 32) {
    const int c = c0 + lane;
    const size_t e = static_cast<size_t>(b) * a.nc + c;
    const int j = c < a.nc ? a.rep[e] : b;
    const bool in_range = j >= 0 && j < a.B;
    int count = 0;
    if (sb != nullptr) {
      const int group = min(32, a.nc - c0);
      for (int t = 0; t < group; ++t) {
        const int jt = __shfl_sync(kFull, j, t);
        int n;
        if (jt == b) {
          n = a.P;  // self: every word agrees
        } else if (jt < 0 || jt >= a.B) {
          n = 0;
        } else {
          const uint32_t* sj = a.sig + static_cast<size_t>(jt) * a.P;
          int m = 0;
          for (int p = lane; p < a.P; p += 32) m += __ldg(sb + p) == __ldg(sj + p);
          n = __reduce_add_sync(kFull, m);
        }
        if (lane == t) count = n;
      }
    }
    if (c >= a.nc) continue;
    const bool fo = a.keys != nullptr && in_range && fine_only(a, b, c, j);
    if (a.bars != nullptr) {
      a.bars[e] = fo ? a.strict : a.base;
      continue;
    }
    const float agree = __fdiv_rn(static_cast<float>(count), fp);
    float bar = a.base;
    if (a.thr_mode == kThrColumn) bar = a.thr[c];
    else if (a.thr_mode == kThrEdge) bar = a.thr[e];
    else if (a.thr_mode == kThrFine) bar = fo ? a.strict : a.base;
    const bool ok = in_range && agree >= bar && vb && a.valid[j];
    if (a.ok != nullptr) a.ok[e] = ok;
    if (a.need != nullptr) a.need[e] = ok && j != b && (fo || agree < a.band);
  }
}

// x = z0 = out = arange(B); the round flags cleared.
__global__ void label_init_kernel(int B, int rounds, int32_t* x, int32_t* z0, int32_t* out,
                                  int32_t* changed) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < rounds) changed[b] = 0;
  if (b >= B) return;
  x[b] = z0[b] = out[b] = b;
}

// A warp a row: l1 = min(x[b], x[c] over ok candidates c), then
// atomicMin(z[b], l1) and atomicMin(z[c], l1) for every ok candidate c.
__global__ void __launch_bounds__(kThreads)
label_pull_kernel(const int32_t* __restrict__ rep, const bool* __restrict__ ok, int B, int nc,
                  int round, const int32_t* __restrict__ x, int32_t* z,
                  const int32_t* __restrict__ changed) {
  if (round > 0 && changed[round - 1] == 0) return;
  const int b = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  if (b >= B) return;
  const int lane = threadIdx.x & 31;
  const int32_t* rb = rep + static_cast<size_t>(b) * nc;
  const bool* ob = ok + static_cast<size_t>(b) * nc;
  int m = x[b];
  for (int c = lane; c < nc; c += 32) {
    const int j = rb[c];
    if (ob[c] && j >= 0 && j < B) m = min(m, x[j]);
  }
  m = __reduce_min_sync(kFull, m);
  if (lane == 0) atomicMin(z + b, m);
  for (int c = lane; c < nc; c += 32) {
    const int j = rb[c];
    if (ob[c] && j >= 0 && j < B && j != b) atomicMin(z + j, m);
  }
}

// A thread a row: n = z[z[b]]; x[b] = z_next[b] = n; out[b] = valid ? n : b;
// the round's flag set where n differs from x[b].
__global__ void label_jump_kernel(const bool* __restrict__ valid, int B, int round, int32_t* x,
                                  const int32_t* __restrict__ z, int32_t* __restrict__ z_next,
                                  int32_t* __restrict__ out, int32_t* changed) {
  if (round > 0 && changed[round - 1] == 0) return;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = z[z[b]];
  if (n != x[b]) changed[round] = 1;
  x[b] = n;
  z_next[b] = n;
  out[b] = valid[b] ? n : b;
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
  if (B == 0) return 0;
  Salts s{};
  const auto* src = static_cast<const uint32_t*>(salts);
  for (int i = 0; i < nk; ++i) s.v[i] = src[i];
  keys_kernel<<<blocks_for(static_cast<long long>(B) * nk), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sig), B, P, nb, nf, s, wide, static_cast<int64_t*>(keys),
      static_cast<const bool*>(valid), row_bits, static_cast<int64_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}

// keys int64[B, nk], valid bool[B] -> packed int64[nk, B].
int astt_lsh_pack(const void* keys, int B, int nk, const void* valid, int row_bits, void* packed,
                  void* stream) {
  if (B < 0 || nk < 1 || row_bits < 0 || row_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  pack_kernel<<<blocks_for(static_cast<long long>(B) * nk), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), B, nk, static_cast<const bool*>(valid), row_bits,
      static_cast<int64_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}

// sorted int64[nbt, B] (each band ascending), valid bool[B] -> out
// int32[B, 3 nbt].
int astt_lsh_run_heads(const void* sorted, const void* valid, int B, int nbt, int row_bits,
                       void* out, void* stream) {
  if (B < 0 || nbt < 1 || nbt > 65535 || row_bits < 0 || row_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const dim3 grid((B + kHeadTile - 1) / kHeadTile, nbt);
  run_heads_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sorted), static_cast<const bool*>(valid), B, nbt, row_bits,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
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
  verify_kernel<<<blocks_for(32LL * B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// rep int32[B, nc], ok bool[B, nc], valid bool[B] -> out int32[B] after
// `rounds` rounds; work int32[3 B + rounds].  1 + 2 rounds launches.
int astt_lsh_label(const void* rep, const void* ok, const void* valid, int B, int nc, int rounds,
                   void* work, void* out, void* stream) {
  if (B < 0 || nc < 0 || rounds < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<int32_t*>(work);
  int32_t* x = w;
  int32_t* z[2] = {w + B, w + 2LL * B};
  int32_t* changed = w + 3LL * B;
  auto* o = static_cast<int32_t*>(out);
  const auto* r = static_cast<const int32_t*>(rep);
  const auto* k = static_cast<const bool*>(ok);
  const auto* v = static_cast<const bool*>(valid);
  label_init_kernel<<<blocks_for(B > rounds ? B : rounds), kThreads, 0, s>>>(
      B, rounds, x, z[0], o, changed);
  cudaError_t err = cudaGetLastError();
  for (int round = 0; round < rounds && err == cudaSuccess; ++round) {
    label_pull_kernel<<<blocks_for(32LL * B), kThreads, 0, s>>>(r, k, B, nc, round, x,
                                                                z[round & 1], changed);
    label_jump_kernel<<<blocks_for(B), kThreads, 0, s>>>(v, B, round, x, z[round & 1],
                                                         z[(round + 1) & 1], o, changed);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

const char* astt_lsh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
