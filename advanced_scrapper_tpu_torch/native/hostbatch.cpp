// The blob tier of ExactDedup (pipeline/dedup.py): exact first-seen dedup
// over byte items joined into one blob with an offset table.  The port's
// copy of hb_exact_keep_first, the one function of the reference's host
// batcher that this tier needs; the probe/confirm loop lives in
// bytehash.h, shared with the zero-copy tier (exactdedup.cpp).
//
// Build: g++ -O3 -shared -fPIC hostbatch.cpp, into build/host/ under a
// hashed name (cpu/native.py, driven by cpu/hostbatch.py).

#include <cstdint>

#include "bytehash.h"

extern "C" {

// Returns items kept, or -1 on allocation failure.
long hb_exact_keep_first(const uint8_t* data, const long long* offsets,
                         long n, uint8_t* out_keep) {
  return bytehash::keep_first(
      n, [&](long i) { return data + offsets[i]; },
      [&](long i) { return static_cast<int64_t>(offsets[i + 1] - offsets[i]); },
      out_keep);
}

}  // extern "C"
