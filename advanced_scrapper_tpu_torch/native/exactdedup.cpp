// Exact first-seen dedup straight over a CPython list — the zero-copy tier
// of ExactDedup (pipeline/dedup.py).
//
// The portable tier (hb_exact_keep_first in hostbatch.cpp) needs the host
// to flatten the corpus into one blob + offsets first; at bench scale that
// "".join + per-item len() costs as much as the dedup itself.  This kernel
// reads each str/bytes item's buffer in place (compact-ASCII strings expose
// their bytes directly; anything else goes through the object's cached
// UTF-8 view, which is injective, so byte equality ⟺ string equality) and
// runs the same open-addressing first-seen table with full memcmp
// confirmation — no blob, no offsets, no per-item Python arithmetic.
//
// Must be called with the GIL HELD (ctypes.PyDLL, not CDLL): it touches
// Python objects throughout.  Returns the number kept, -1 on allocation
// failure, or -2 when an item isn't str/bytes or can't be UTF-8-viewed
// (lone surrogates) — callers route such an input on to the blob or
// grouping tier, which handle those routes.
//
// Build: g++ -O3 -shared -fPIC -I<python-include> exactdedup.cpp, into
// build/host/ under a hashed name (cpu/native.py, driven by
// cpu/exactdedup.py; a failed build or load raises).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

#include "bytehash.h"

namespace {

// Borrowed view of an item's bytes; false when the item type is unsupported.
inline bool item_view(PyObject* o, const uint8_t** data, Py_ssize_t* len) {
  if (PyUnicode_Check(o)) {
    if (PyUnicode_IS_COMPACT_ASCII(o)) {
      *data = reinterpret_cast<const uint8_t*>(
          reinterpret_cast<PyASCIIObject*>(o) + 1);
      *len = PyUnicode_GET_LENGTH(o);
      return true;
    }
    const char* u8 = PyUnicode_AsUTF8AndSize(o, len);
    if (u8 == nullptr) {
      PyErr_Clear();  // lone surrogates etc.: signal fallback, don't raise
      return false;
    }
    *data = reinterpret_cast<const uint8_t*>(u8);
    return true;
  }
  if (PyBytes_Check(o)) {
    *data = reinterpret_cast<const uint8_t*>(PyBytes_AS_STRING(o));
    *len = PyBytes_GET_SIZE(o);
    return true;
  }
  return false;
}

}  // namespace

extern "C" {

long ed_keep_first_list(PyObject* list, uint8_t* out_keep) {
  if (!PyList_Check(list)) return -2;
  const Py_ssize_t n = PyList_GET_SIZE(list);
  if (n == 0) return 0;
  std::vector<const uint8_t*> ptrs;
  std::vector<int64_t> lens;
  try {
    ptrs.resize(n);
    lens.resize(n);
  } catch (...) {
    return -1;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    const uint8_t* data;
    Py_ssize_t len;
    // str items mix with bytes items fine here: a str's UTF-8 view can
    // equal a bytes item's bytes, but pandas keeps "a" and b"a" distinct,
    // so mixed-TYPE lists must take the confirm-capable fallback tier.
    // Detect the mix cheaply: remember the first item's kind.
    if (!item_view(PyList_GET_ITEM(list, i), &data, &len)) return -2;
    if (i > 0 && PyBytes_Check(PyList_GET_ITEM(list, i)) !=
                     PyBytes_Check(PyList_GET_ITEM(list, 0)))
      return -2;
    ptrs[i] = data;
    lens[i] = len;
  }
  // probe/confirm loop shared with the blob tier (bytehash.h)
  return bytehash::keep_first(
      static_cast<long>(n), [&](long i) { return ptrs[i]; },
      [&](long i) { return lens[i]; }, out_keep);
}

}  // extern "C"
