// Shared 64-bit byte-string hash (wyhash-flavoured multiply-mix over
// 8-byte words) for the exact-dedup tiers (hostbatch.cpp blob pass,
// exactdedup.cpp zero-copy pass).  ONE definition so the two tiers can
// never drift: equality decisions are always settled by memcmp, so hash
// quality only affects probe-chain length — but both tiers must still
// agree about what "the hash" is when results are compared side by side.
#pragma once

#include <cstdint>
#include <cstring>
#include <new>

namespace bytehash {

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 32;
  x *= 0xD6E8FEB86659FD93ULL;
  x ^= x >> 32;
  x *= 0xD6E8FEB86659FD93ULL;
  x ^= x >> 32;
  return x;
}

inline uint64_t hash_bytes(const uint8_t* p, uint64_t len) {
  uint64_t h = 0x9E3779B97F4A7C15ULL ^ len;
  uint64_t i = 0;
  for (; i + 8 <= len; i += 8) {
    uint64_t w;
    std::memcpy(&w, p + i, 8);
    h = mix64(h ^ w) * 0x9E3779B97F4A7C15ULL;
  }
  uint64_t tail = 0;
  if (i < len) {
    std::memcpy(&tail, p + i, len - i);
    h = mix64(h ^ tail) * 0x9E3779B97F4A7C15ULL;
  }
  return mix64(h);
}

// Shared open-addressing first-seen membership pass for the exact-dedup
// tiers.  ptr_of(i)/len_of(i) view item i's bytes (zero-copy in the list
// tier, blob+offsets in the portable tier); out_keep[i] = 1 iff item i is
// the first occurrence of its byte string.  Every hash-equal probe is
// settled by full memcmp — a collision lengthens a probe chain, never
// drops a distinct row.  Returns items kept, or -1 on allocation failure.
// ONE implementation so the tiers' probe/confirm semantics cannot drift.
template <typename PtrFn, typename LenFn>
long keep_first(long n, PtrFn ptr_of, LenFn len_of, uint8_t* out_keep) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  struct Slot {
    uint64_t hash;
    int64_t idx;
  };
  // power-of-two table at >= 2n (load factor <= 0.5); hash and index
  // interleave so a probe costs one cache line, not two
  size_t cap = 16;
  while (cap < static_cast<size_t>(n) * 2) cap <<= 1;
  void* raw = nullptr;
  {
    // no std::vector here: this header serves a translation unit compiled
    // against Python.h; keep the dependency surface minimal
    raw = ::operator new[](cap * sizeof(Slot), std::nothrow);
    if (!raw) return -1;
  }
  Slot* table = static_cast<Slot*>(raw);
  for (size_t s = 0; s < cap; ++s) table[s] = Slot{0, -1};
  const size_t mask = cap - 1;
  long kept = 0;
  for (long i = 0; i < n; ++i) {
    const uint8_t* item = ptr_of(i);
    const int64_t len = len_of(i);
    if (len < 0) {
      ::operator delete[](raw);
      return -1;
    }
    const uint64_t h = hash_bytes(item, static_cast<uint64_t>(len));
    size_t pos = static_cast<size_t>(h) & mask;
    int keep = 1;
    while (table[pos].idx != -1) {
      if (table[pos].hash == h) {
        const int64_t j = table[pos].idx;
        if (len_of(j) == len &&
            std::memcmp(ptr_of(j), item, static_cast<size_t>(len)) == 0) {
          keep = 0;  // true duplicate of an earlier item
          break;
        }
      }
      pos = (pos + 1) & mask;  // collision (hash or table slot): probe on
    }
    if (keep) {
      table[pos] = Slot{h, i};
      kept++;
    }
    out_keep[i] = static_cast<uint8_t>(keep);
  }
  ::operator delete[](raw);
  return kept;
}

}  // namespace bytehash
