// The exact 128-bit hash of ExactDedup's grouping tier, by hand for Hopper
// (sm_90a).
//
// Replaces the jnp device code of advanced_scrapper_tpu/ops/exact.py:
// _block_hash_impl (:126) under ExactHasher.hash_docs (:61) and
// _row_hash_impl (:147) under ExactHasher.__call__ (:57).  There is no Pallas
// original; the port ran both as int64 products in row chunks, a lane at a
// time, then index_add_.  For document d and lane j in 0..3:
//
//   h[d, j] = fmix32((sum_i coef[i, j] * x[d, i] mod 2^32)
//                    ^ fmix32(mixlen[d] * 0x9E3779B9) ^ j * 0x85EBCA77)
//
// where i runs over the span[d] bytes at text[starts[d]] and coef is
// ExactHasher's per-lane stream, interleaved as uint32[cols, 4].  The stream
// is prefix-consistent, so the reference's block p, dotted with the stream at
// p * block_len, is the stream at each byte's offset in its document: the
// kernel reads ragged documents straight from one joined buffer and builds no
// blocks, as minhash_fold_segments reads chunk text.  The row form dots all L
// columns of a padded row (bytes past its length count when not zero) and
// mixes its length: the caller passes span = L and mixlen = lengths[b].  The
// arithmetic is uint32 and wraps mod 2^32 as the reference's uint32 sums do;
// that addition is associative, so any order of the sum gives the same bits.
//
// Bound, at the grouping tier's shape (262,144 urls of ~49 bytes): the text
// (~13 MB), 16 bytes of descriptors and 16 of hash a document: bytes, a few
// microseconds at 3.35 TB/s; 4 multiply-adds a byte are fewer.  The first
// design (PR 26: a warp a document, a lane a byte, four warp reductions and
// one lane mixing while 31 waited, each document's text a dependent round
// trip after its descriptors) took 0.0834 ms on an H100 80GB HBM3 at 700 W,
// 7.6% of that bound: per-document latency.  This design streams the text
// in tiles, so what bounds it is the instructions a byte and a document cost
// (the multiply-adds, the group reduction, the mix) against the SMs' issue
// rate, and the copies' latency where too few tiles are in flight.
//
// Design:
// - A persistent grid of 256-thread blocks walks tiles of kTileDocs
//   consecutive documents.  A tile's descriptors are read coalesced, a
//   thread a document, into shared memory two tiles ahead.  When the tile's
//   documents lie back to back in text (starts[d + 1] = starts[d] +
//   span[d], every one inside text and the stream) and their bytes fit
//   kBufBytes, its text span is staged into shared memory with 16-byte
//   cp.async (the 16-byte words at its ends that pass text's bounds by plain
//   loads), double-buffered: the next tile's bytes arrive while this tile
//   hashes.  Both callers lay documents out so (hash_docs: starts are the
//   lengths' cumsum; the row form: b * L).
// - The tile path: a group of kGroup lanes (8, 16 or 32, following max_span:
//   8 for urls, 7 positions a lane for a 49-byte one) takes a document;
//   lane l of the group sums positions l, l + kGroup, ... from the staged
//   bytes and the stream's prefix; the group reduce-scatters its four sums
//   (4 shuffles at 8 lanes, where a plain reduction of each takes 12),
//   lanes 0, 2, 4 and 6 of the group each mix one of the four sums side by
//   side and write its 4 bytes: a document's 16 bytes in one store
//   instruction, contiguous across the warp's groups.
// - The per-document path: a warp a document, a lane a byte from global
//   memory (the first design's walk, four steps' loads in flight), in the
//   same launch for a tile whose documents are not back to back or whose
//   span passes the buffer (every document of it), and for a document of a
//   staged tile longer than the group's reach (kGroup * kReachSteps bytes,
//   and the stream's prefix in shared memory), up to MAX_DOC_LEN (4 MiB).  It clamps every read to text and the stream,
//   so any starts stay safe.
// - The stream's first positions (up to kPrefixMax, as far as the longest
//   span needs) sit in shared memory, 16 bytes a position; a group reads
//   consecutive positions, so no bank conflict.  Positions past the prefix
//   are read through L1/L2.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileDocs = kThreads;  // documents a tile: a descriptor a thread
constexpr int kBufBytes = 16384;     // a staged tile's text at most
constexpr int kBufPitch = kBufBytes + 32;  // with the alignment slack at both ends
constexpr int kReachSteps = 16;      // positions a lane of the tile path at most
// the most stream positions held in shared memory (16 KiB)
constexpr int kPrefixMax = 1024;
constexpr uint32_t kLenMul = 0x9E3779B9u;
constexpr uint32_t kLaneSalt = 0x85EBCA77u;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

struct Sums {
  uint32_t s0, s1, s2, s3;
};

__device__ __forceinline__ void mad(Sums& s, uint32_t x, uint4 c) {
  s.s0 += x * c.x;
  s.s1 += x * c.y;
  s.s2 += x * c.z;
  s.s3 += x * c.w;
}

__device__ __forceinline__ uint4 coef_at(const uint4* sm, int pre, const uint4* coef, int64_t i) {
  return i < pre ? sm[i] : __ldg(coef + i);
}

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {  // all but the latest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Args {
  const uint8_t* text;
  int64_t text_len;
  const int64_t* starts;
  const int32_t* span;
  const uint32_t* mixlen;
  const uint4* coef;
  int64_t cols;
  int pre;
  int n;
  uint32_t* out;  // uint32[n, 4]
};

// A tile's descriptors in shared memory: slot s of each array.
struct Desc {
  int64_t* st;  // [2][kTileDocs]
  int32_t* sp;
  uint32_t* mx;
};

// How a tile is hashed, the same in every thread of the block.
struct Plan {
  bool staged;
  int64_t base;  // starts of the tile's first document
  int64_t off;   // where text[base] lies in the staged buffer
};

// Document d, a warp: lane l sums positions l, l + 32, ... from global
// memory; the reads clamped to text and the stream.
__device__ void warp_doc(const Args& a, const uint4* sm, int64_t d, int64_t st, int32_t sp,
                         uint32_t mix, int lane) {
  const int64_t start = lmin(st > 0 ? st : 0, a.text_len);
  const int64_t len = lmin(lmin(sp > 0 ? sp : 0, a.cols), a.text_len - start);
  const uint8_t* p = a.text + start;
  Sums s{0u, 0u, 0u, 0u};
#pragma unroll 4
  for (int64_t i = lane; i < len; i += 32) mad(s, p[i], coef_at(sm, a.pre, a.coef, i));
  s.s0 = __reduce_add_sync(kFull, s.s0);
  s.s1 = __reduce_add_sync(kFull, s.s1);
  s.s2 = __reduce_add_sync(kFull, s.s2);
  s.s3 = __reduce_add_sync(kFull, s.s3);
  if (lane == 0) {
    const uint32_t lm = fmix32(mix * kLenMul);
    reinterpret_cast<uint4*>(a.out)[d] = make_uint4(
        fmix32(s.s0 ^ lm), fmix32(s.s1 ^ lm ^ kLaneSalt), fmix32(s.s2 ^ lm ^ (2u * kLaneSalt)),
        fmix32(s.s3 ^ lm ^ (3u * kLaneSalt)));
  }
}

// Tile t's descriptor of this thread's document, or an empty one past n.
__device__ __forceinline__ void load_desc(const Args& a, int t, int64_t& st, int32_t& sp,
                                          uint32_t& mx) {
  const int64_t d = static_cast<int64_t>(t) * kTileDocs + threadIdx.x;
  st = 0;
  sp = 0;
  mx = 0;
  if (d < a.n) {
    st = __ldg(a.starts + d);
    sp = __ldg(a.span + d);
    mx = __ldg(a.mixlen + d);
  }
}

// Tile t's plan from its descriptors in slot s (a block-wide vote).
__device__ Plan plan_tile(const Args& a, const Desc& ds, int s, int t) {
  const int i = threadIdx.x;
  const int nd = static_cast<int>(lmin(kTileDocs, a.n - static_cast<int64_t>(t) * kTileDocs));
  const int64_t* st = ds.st + s * kTileDocs;
  const int32_t* sp = ds.sp + s * kTileDocs;
  bool ok = true;
  if (i < nd) {
    const int64_t x = st[i];
    const int32_t y = sp[i];
    ok = x >= 0 && y >= 0 && y <= a.cols && x <= a.text_len - y;
    if (i + 1 < nd) ok = ok && st[i + 1] == x + y;
  }
  Plan p{false, st[0], 0};
  if (__syncthreads_and(ok)) {
    const int64_t end = st[nd - 1] + sp[nd - 1];
    p.staged = end - p.base <= kBufBytes;
    p.off = reinterpret_cast<uintptr_t>(a.text + p.base) & 15;
  }
  return p;
}

// The staged tile's bytes [base, base + bytes) into buf, from the 16-byte
// word that holds its first byte: cp.async for words inside text, plain
// loads for the words at its ends that pass text's bounds.
__device__ void stage_tile(const Args& a, const Plan& p, int64_t bytes, uint8_t* buf) {
  const uint8_t* a0 = a.text + p.base - p.off;
  const int64_t words = (p.off + bytes + 15) >> 4;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(a.text);
  const uintptr_t hi = lo + a.text_len;
  for (int64_t w = threadIdx.x; w < words; w += kThreads) {
    const uint8_t* src = a0 + 16 * w;
    const uintptr_t at = reinterpret_cast<uintptr_t>(src);
    if (at >= lo && at + 16 <= hi) {
      cp_async16(buf + 16 * w, src);
    } else {
      for (int b = 0; b < 16; ++b) {
        buf[16 * w + b] = at + b >= lo && at + b < hi ? src[b] : 0;
      }
    }
  }
}

// A staged tile: a group of kGroup lanes a document of up to kGroup *
// kReachSteps bytes whose stream positions all sit in shared memory
// (pre); longer ones go on the block's list for a warp each.
template <int kGroup>
__device__ void hash_staged(const Args& a, const uint4* sm, const Desc& ds, int s, int t,
                            const Plan& p, const uint8_t* buf, int* longs, int* nlong) {
  constexpr int kGroups = kThreads / kGroup;
  constexpr unsigned kOnes = kGroup == 32 ? kFull : (1u << (kGroup % 32)) - 1;
  const int lane = threadIdx.x & 31;
  const int sub = threadIdx.x % kGroup;
  const unsigned gmask = kOnes << (lane & (32 - kGroup));
  const int reach = min(kGroup * kReachSteps, a.pre);
  const int64_t d0 = static_cast<int64_t>(t) * kTileDocs;
  const int nd = static_cast<int>(lmin(kTileDocs, a.n - d0));
  const int64_t* st = ds.st + s * kTileDocs;
  const int32_t* sp = ds.sp + s * kTileDocs;
  const uint32_t* mx = ds.mx + s * kTileDocs;
  for (int i = threadIdx.x / kGroup; i < nd; i += kGroups) {
    const int len = sp[i];
    if (len > reach) {
      if (sub == 0) longs[atomicAdd(nlong, 1)] = i;
      continue;
    }
    const uint8_t* q = buf + p.off + (st[i] - p.base);
    Sums v{0u, 0u, 0u, 0u};
#pragma unroll 4
    for (int j = sub; j < len; j += kGroup) mad(v, q[j], sm[j]);
    // A reduce-scatter over each 8 lanes: lane bits 2 and 1 pick the sum a
    // lane keeps (2 * b2 + b1), the partner's half of the others is added
    // at each step; then the 8-lane parts are added across the group.
    const bool b2 = sub & 4, b1 = sub & 2;
    uint32_t k0 = b2 ? v.s2 : v.s0, k1 = b2 ? v.s3 : v.s1;
    k0 += __shfl_xor_sync(gmask, b2 ? v.s0 : v.s2, 4, kGroup);
    k1 += __shfl_xor_sync(gmask, b2 ? v.s1 : v.s3, 4, kGroup);
    uint32_t k = b1 ? k1 : k0;
    k += __shfl_xor_sync(gmask, b1 ? k0 : k1, 2, kGroup);
#pragma unroll
    for (int o = 1; o < kGroup; o <<= 1) {
      if (o != 2 && o != 4) k += __shfl_xor_sync(gmask, k, o, kGroup);
    }
    if ((sub & ~6) == 0) {  // lanes 0, 2, 4, 6 mix sums 0-3 side by side
      const uint32_t j = static_cast<uint32_t>(sub) >> 1;
      const uint32_t lm = fmix32(mx[i] * kLenMul);
      a.out[(d0 + i) * 4 + j] = fmix32(k ^ lm ^ (j * kLaneSalt));
    }
  }
}

template <int kGroup>
__global__ void __launch_bounds__(kThreads) exact_hash_kernel(Args a) {
  extern __shared__ uint4 sm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < a.pre; i += kThreads) {
    sm[i] = i < a.cols ? a.coef[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  Desc ds;
  ds.st = reinterpret_cast<int64_t*>(sm + a.pre);
  ds.sp = reinterpret_cast<int32_t*>(ds.st + 2 * kTileDocs);
  ds.mx = reinterpret_cast<uint32_t*>(ds.sp + 2 * kTileDocs);
  uint8_t* bufs = reinterpret_cast<uint8_t*>(ds.mx + 2 * kTileDocs);
  int* longs = reinterpret_cast<int*>(bufs + 2 * kBufPitch);
  int* nlong = longs + kTileDocs;

  const int tiles = static_cast<int>((static_cast<int64_t>(a.n) + kTileDocs - 1) / kTileDocs);
  const int grid = gridDim.x;
  int t = blockIdx.x;
  int64_t st;
  int32_t sp;
  uint32_t mx;
  for (int k = 0; k < 2; ++k) {  // the first two tiles' descriptors
    if (t + k * grid < tiles) {
      load_desc(a, t + k * grid, st, sp, mx);
      ds.st[k * kTileDocs + threadIdx.x] = st;
      ds.sp[k * kTileDocs + threadIdx.x] = sp;
      ds.mx[k * kTileDocs + threadIdx.x] = mx;
    }
  }
  if (threadIdx.x == 0) *nlong = 0;
  __syncthreads();
  Plan cur = plan_tile(a, ds, 0, t);
  auto tile_bytes = [&](int s, int tt) {
    const int nd = static_cast<int>(lmin(kTileDocs, a.n - static_cast<int64_t>(tt) * kTileDocs));
    return ds.st[s * kTileDocs + nd - 1] + ds.sp[s * kTileDocs + nd - 1] - ds.st[s * kTileDocs];
  };
  if (cur.staged) stage_tile(a, cur, tile_bytes(0, t), bufs);
  cp_async_commit();
  for (int k = 0; t < tiles; ++k, t += grid) {
    const int s = k & 1, sn = s ^ 1;
    const int tn = t + grid;
    Plan next{false, 0, 0};
    if (tn < tiles) {  // the next tile's bytes in flight while this one hashes
      next = plan_tile(a, ds, sn, tn);
      if (next.staged) stage_tile(a, next, tile_bytes(sn, tn), bufs + sn * kBufPitch);
    }
    cp_async_commit();
    const bool ahead = tn + grid < tiles;  // the tile after: descriptors into registers
    if (ahead) load_desc(a, tn + grid, st, sp, mx);
    cp_async_wait_prior();
    __syncthreads();
    const int64_t* dst = ds.st + s * kTileDocs;
    const int32_t* dsp = ds.sp + s * kTileDocs;
    const uint32_t* dmx = ds.mx + s * kTileDocs;
    const int64_t d0 = static_cast<int64_t>(t) * kTileDocs;
    const int nd = static_cast<int>(lmin(kTileDocs, a.n - d0));
    if (cur.staged) {
      hash_staged<kGroup>(a, sm, ds, s, t, cur, bufs + s * kBufPitch, longs, nlong);
      __syncthreads();
      for (int q = warp; q < *nlong; q += kWarps) {
        const int i = longs[q];
        warp_doc(a, sm, d0 + i, dst[i], dsp[i], dmx[i], lane);
      }
    } else {
      for (int i = warp; i < nd; i += kWarps) warp_doc(a, sm, d0 + i, dst[i], dsp[i], dmx[i], lane);
    }
    __syncthreads();  // slot s and its buffer are free
    if (ahead) {
      ds.st[s * kTileDocs + threadIdx.x] = st;
      ds.sp[s * kTileDocs + threadIdx.x] = sp;
      ds.mx[s * kTileDocs + threadIdx.x] = mx;
    }
    if (threadIdx.x == 0) *nlong = 0;
    __syncthreads();
    cur = next;
  }
}

template <int kGroup>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  auto* kernel = exact_hash_kernel<kGroup>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(a.n) + kTileDocs - 1) / kTileDocs;
  const long long resident = static_cast<long long>(sms) * std::max(per_sm, 1);
  const int grid = static_cast<int>(std::min(resident, tiles));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// text uint8[text_len]; starts int64[n], span int32[n] (the bytes dotted),
// mixlen uint32[n] (the length mixed in); coef uint32[cols, 4], 16-byte
// aligned; max_span the longest span (sizes the shared prefix and the
// group) -> out uint32[n, 4], 16-byte aligned.  Launches nothing for n == 0.
int astt_exact_hash(const void* text, long long text_len, const void* starts, const void* span,
                    const void* mixlen, const void* coef, long long cols, long long max_span,
                    int n, void* out, void* stream) {
  if (n < 0 || text_len < 0 || cols < 0 || max_span < 0 ||
      reinterpret_cast<uintptr_t>(coef) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long need = std::min(max_span, cols);
  const int pre = static_cast<int>(std::min<long long>(kPrefixMax, (need + 15) / 16 * 16));
  const int smem = pre * static_cast<int>(sizeof(uint4)) +
                   2 * kTileDocs * static_cast<int>(sizeof(int64_t) + 2 * sizeof(int32_t)) +
                   2 * kBufPitch + (kTileDocs + 1) * static_cast<int>(sizeof(int));
  const Args a{static_cast<const uint8_t*>(text), text_len, static_cast<const int64_t*>(starts),
               static_cast<const int32_t*>(span), static_cast<const uint32_t*>(mixlen),
               static_cast<const uint4*>(coef), cols, pre, n, static_cast<uint32_t*>(out)};
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (need <= 8 * 8) {
    err = launch<8>(a, smem, s);
  } else if (need <= 16 * 8) {
    err = launch<16>(a, smem, s);
  } else {
    err = launch<32>(a, smem, s);
  }
  return static_cast<int>(err);
}

const char* astt_exact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
