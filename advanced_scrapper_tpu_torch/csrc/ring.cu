// The mesh's ring join by hand for Hopper (sm_90a): one launch a (hop,
// shard) of make_ring_dedup.
//
// Replaces the jnp device code of advanced_scrapper_tpu/parallel/ring.py:
// _best_match_against_sorted (:59; its band_body :82 under lax.scan) and the
// rep = min(rep, cand) of make_ring_dedup's hop (:139).  There is no Pallas
// original; the port ran a Python loop over the bands, each a searchsorted,
// two gathers, a [Bl, P] compare and a reduction (~10 launches a band).  The
// presort (_presort_bands :43) runs on lsh_sort (csrc/lsh.cu), so what a
// transit block carries is each band's packed keys (key << bits) | i sorted
// ascending, where i indexes perm, the block's rows valid first (each group
// ascending): within a key that is the reference's (key, gidx_eff) order.
//
// For each local row r and each band b, the transit position
// searchsorted(keys of band b, key_l[r, b], side="left"), clamped to Bt - 1:
// the run head only, as in the reference.  A hit (the key there equals the
// row's) names the transit row perm[i] and its global index gidx_eff; the
// candidate verifies when its signature agrees with the row's on count / P
// of the words (float32, __fdiv_rn) >= thr (the threshold rounded to float32)
// and it comes before the row (gidx_eff < gidx_l).  The row's result is the
// smallest verified candidate, else its own index, and rep[r] takes the
// minimum of that and what it held.
//
// Bound, at the mesh plane's shape (65,536 articles on 8 shards: Bl = Bt =
// 8,192, 16 bands, P = 128): bytes.  A launch must read the local keys (1
// MiB) and the transit keys (1 MiB), perm and gidx_eff where a band hits,
// both signatures of each pair it verifies (a few hundred rows), and read
// and write rep: ~2.4 MB, under 1 us at 3.35 TB/s.  What bounds this design
// is the binary search's chain of dependent loads (13 at 8,192 rows),
// hidden by the SM's other warps.
//
// Design:
// - A warp a local row, 8 warps a block; a lane a band (bands in rounds of
//   32), so a row's searches run side by side.
// - The candidates of a round are verified in ascending global index, each
//   distinct one once: the warp takes the smallest candidate left (a min
//   reduction), counts its agreement (a lane a 16-byte word group of both
//   signatures, an add reduction), and stops at the first that verifies,
//   which is the minimum the reference takes; a candidate that fails drops
//   out of every lane that holds it (bands repeat candidates: 98.7% of the
//   main corpus's non-self candidate columns repeat one of their row), and
//   candidates that cannot lower the current best are never verified.  The
//   minimum does not depend on the order, so this is the reference's result.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int32_t kBig = 0x7FFFFFFF;  // int32 max: no candidate

// Words where the two signature rows agree, summed over the warp.
template <int kVec>
__device__ __forceinline__ int agree_count(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b, int P, int lane) {
  int c = 0;
  if (kVec == 4) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    for (int w = lane; w < P / 4; w += 32) {
      const uint4 x = __ldg(a4 + w), y = __ldg(b4 + w);
      c += (x.x == y.x) + (x.y == y.y) + (x.z == y.z) + (x.w == y.w);
    }
  } else {
    for (int w = lane; w < P; w += 32) c += __ldg(a + w) == __ldg(b + w);
  }
  return __reduce_add_sync(0xFFFFFFFFu, c);
}

template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    ring_join_kernel(const int64_t* __restrict__ keys_l, const uint32_t* __restrict__ sig_l,
                     const int32_t* __restrict__ gidx_l, const int64_t* __restrict__ sorted,
                     const int32_t* __restrict__ perm, const int32_t* __restrict__ gidx_eff,
                     const uint32_t* __restrict__ sig_b, int Bl, int Bt, int nb, int P, int bits,
                     float thr, int32_t* __restrict__ rep) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= Bl) return;  // the whole warp leaves together
  const int32_t gl = gidx_l[r];
  const int64_t mask = (int64_t{1} << bits) - 1;
  const uint32_t* own = sig_l + static_cast<int64_t>(r) * P;
  int32_t best = kBig;
  for (int b0 = 0; b0 < nb; b0 += 32) {
    const int b = b0 + lane;
    int32_t cand = kBig, crow = 0;
    if (b < nb) {
      const int64_t kl = keys_l[static_cast<int64_t>(r) * nb + b];
      const int64_t target = kl << bits;
      const int64_t* band = sorted + static_cast<int64_t>(b) * Bt;
      int lo = 0, hi = Bt;  // the first position whose packed key is >= target
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(band + mid) < target) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int64_t v = __ldg(band + (lo < Bt ? lo : Bt - 1));
      if ((v >> bits) == kl) {
        crow = __ldg(perm + (v & mask));
        const int32_t cg = __ldg(gidx_eff + crow);
        if (cg < gl && cg < best) cand = cg;
      }
    }
    for (;;) {
      const int32_t m = __reduce_min_sync(0xFFFFFFFFu, cand);
      if (m == kBig) break;
      const int owner = __ffs(__ballot_sync(0xFFFFFFFFu, cand == m)) - 1;
      const int32_t row = __shfl_sync(0xFFFFFFFFu, crow, owner);
      const int count = agree_count<kVec>(own, sig_b + static_cast<int64_t>(row) * P, P, lane);
      if (__fdiv_rn(static_cast<float>(count), static_cast<float>(P)) >= thr) {
        best = m;
        break;
      }
      if (cand == m) cand = kBig;
    }
  }
  if (lane == 0) {
    const int32_t c = best == kBig ? gl : best;
    const int32_t old = rep[r];
    rep[r] = c < old ? c : old;
  }
}

}  // namespace

extern "C" {

// keys_l int64[Bl, nb] (values < 2^32), sig_l uint32[Bl, P], gidx_l
// int32[Bl]; the transit block: sorted int64[nb, Bt] (each band's packed
// keys ascending, row field `bits` wide), perm int32[Bt], gidx_eff
// int32[Bt], sig_b uint32[Bt, P]; thr the bar as float32 -> rep int32[Bl]
// updated in place to min(rep, the join).  Launches nothing for Bl == 0.
int astt_ring_join(const void* keys_l, const void* sig_l, const void* gidx_l, const void* sorted,
                   const void* perm, const void* gidx_eff, const void* sig_b, int Bl, int Bt,
                   int nb, int P, int bits, float thr, void* rep, void* stream) {
  if (Bl < 0 || Bt < 1 || nb < 1 || P < 1 || bits < 0 || bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Bl == 0) return 0;
  const int grid = (Bl + kWarps - 1) / kWarps;
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* kl = static_cast<const int64_t*>(keys_l);
  const auto* sl = static_cast<const uint32_t*>(sig_l);
  const auto* gl = static_cast<const int32_t*>(gidx_l);
  const auto* sk = static_cast<const int64_t*>(sorted);
  const auto* pm = static_cast<const int32_t*>(perm);
  const auto* ge = static_cast<const int32_t*>(gidx_eff);
  const auto* sb = static_cast<const uint32_t*>(sig_b);
  auto* out = static_cast<int32_t*>(rep);
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(sig_l) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sig_b) % 16 == 0;
  if (vec) {
    ring_join_kernel<4><<<grid, kWarps * 32, 0, s>>>(kl, sl, gl, sk, pm, ge, sb, Bl, Bt, nb, P,
                                                     bits, thr, out);
  } else {
    ring_join_kernel<1><<<grid, kWarps * 32, 0, s>>>(kl, sl, gl, sk, pm, ge, sb, Bl, Bt, nb, P,
                                                     bits, thr, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* astt_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
