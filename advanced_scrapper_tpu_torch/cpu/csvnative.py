"""ctypes loader for the C++ CSV column scanner (``native/csvscan.cpp``).

The port's copy of the reference's ``cpu/csvnative.py``.  The library is
built by ``cpu/native.py:build`` at first use (``build/host/``, named by a
hash of the source) and a failed build raises, as every port build does:
there is no fallback for a missing compiler.  What stays is the
reference's routing by input: :func:`scan_column` returns ``None`` when
the file or the column is missing, when the bytes are not valid UTF-8, or
when a value holds a NUL (the arena's separator), and the caller
(``storage/csvio.py:read_url_column``) reads that file with the ``csv``
module instead.
"""

from __future__ import annotations

import ctypes
import threading

from advanced_scrapper_tpu_torch.cpu import native

SOURCE = native.PACKAGE_DIR / "native" / "csvscan.cpp"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(native.build(SOURCE)))
        lib.csv_scan_column.restype = ctypes.POINTER(ctypes.c_char)
        lib.csv_scan_column.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.csv_free.restype = None
        lib.csv_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        _lib = lib
        return lib


def scan_column(path: str, column: str) -> list[str] | None:
    """All values of ``column`` from a well-formed CSV, or ``None`` when
    the file/column is missing or the bytes are not valid UTF-8 or a value
    holds a NUL (callers read those with the csv module)."""
    lib = _load()
    count = ctypes.c_longlong()
    nbytes = ctypes.c_longlong()
    ptr = lib.csv_scan_column(
        path.encode("utf-8"), column.encode("utf-8"),
        ctypes.byref(count), ctypes.byref(nbytes),
    )
    if not ptr:
        return None
    try:
        raw = ctypes.string_at(ptr, nbytes.value)
    finally:
        lib.csv_free(ptr)
    if count.value == 0:
        return []
    try:
        text = raw.decode("utf-8")
    except UnicodeDecodeError:
        return None  # Python open() would also have raised; let csv path decide
    vals = text.split("\0")
    assert vals and vals[-1] == ""  # arena is value+NUL repeated
    vals.pop()
    if len(vals) != count.value:
        return None  # a value contained NUL — ambiguous split; fall back
    return vals
