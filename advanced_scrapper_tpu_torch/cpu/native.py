"""The port's host C++ builder, and the ctypes loader for the host verify
library (``native/fastmatch.cpp``).

:func:`build` compiles a named source of ``native/`` (the verify library
here, the exact-dedup tiers in ``cpu/exactdedup.py`` and
``cpu/hostbatch.py``) with ``g++ -O3 -shared -fPIC`` and the source's own
extra flags, at first use, into ``build/host/`` at the root of the
checkout (never next to the source); the file name carries a hash of the
source, the headers it includes with ``#include "..."`` and the flags, so
an edited source is rebuilt and a stale library never loads.  The build
writes a temporary file and renames it into place, so processes that build
at the same moment (test workers, verify-pool workers) never load a
half-written library.  A failed build raises with the compiler's output:
there is no pure-Python route here (``cpu/fuzz.py`` is the plain version
the tests hold the verify library against).

Routing, as in the reference: ``bytes`` and ASCII ``str`` go to the byte
entry points; a non-ASCII ``str`` pair goes to the ``_u32`` entry points
(rapidfuzz scores code points, not bytes); :class:`CutoffArena` sends
non-ASCII names and non-ASCII haystacks to the per-pair route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "fastmatch.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "host"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _hashed_bytes(source: Path) -> bytes:
    """The source's bytes, then those of each header it includes with
    quotes (from its own directory)."""
    text = source.read_bytes()
    parts = [text]
    for name in _LOCAL_INCLUDE.findall(text):
        parts.append((source.parent / name.decode()).read_bytes())
    return b"".join(parts)


def library_path(source: Path = SOURCE, flags: Sequence[str] = CXX_FLAGS) -> Path:
    """``build/host/lib<stem>-<hash>.so`` for ``source`` built with
    ``flags``."""
    source = Path(source)
    digest = hashlib.sha256(
        _hashed_bytes(source) + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: Path = SOURCE, flags: Sequence[str] = CXX_FLAGS) -> Path:
    """Compile ``source`` with ``flags`` unless its current build exists;
    returns the library's path.  Raises ``RuntimeError`` when g++ fails or
    is missing."""
    source = Path(source)
    lib = library_path(source, flags)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300,
        )
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {source.name} needs it") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on {source.name} (exit {proc.returncode}):\n{proc.stdout}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:  # hot path: no lock once loaded (set once)
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        for name in ("fm_ratio", "fm_partial_ratio", "fm_ratio_u32",
                     "fm_partial_ratio_u32"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_double
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ]
        for name in ("fm_partial_ratio_cutoff", "fm_partial_ratio_cutoff_u32"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_double
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_double,
            ]
        select = lib.fm_partial_ratio_cutoff_select
        select.restype = None
        select.argtypes = [
            ctypes.c_char_p, ctypes.c_int,           # haystack
            ctypes.c_char_p, ctypes.c_void_p,        # needle arena + offsets
            ctypes.c_void_p,                         # lengths
            ctypes.c_void_p, ctypes.c_int,           # select rows + count
            ctypes.c_double, ctypes.c_void_p,        # cutoff + out scores
        ]
        lib.fm_ac_build.restype = ctypes.c_void_p
        lib.fm_ac_build.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long]
        lib.fm_ac_scan.restype = ctypes.c_long
        lib.fm_ac_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.fm_ac_destroy.restype = None
        lib.fm_ac_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _enc(s: str | bytes) -> bytes:
    return s if isinstance(s, bytes) else s.encode("utf-8", "replace")


def _call(byte_fn: str, u32_fn: str, s1: str | bytes, s2: str | bytes, *extra) -> float:
    """bytes/ASCII → byte entry point; a non-ASCII ``str`` pair → the
    UTF-32 entry point.  ``extra`` (a score cutoff) goes to both."""
    lib = _load()
    if isinstance(s1, str) and isinstance(s2, str) and not (
        s1.isascii() and s2.isascii()
    ):
        # surrogatepass: scraped text may carry lone surrogates; rapidfuzz
        # scores raw ord() values, and strict utf-32 would raise on them
        a32 = s1.encode("utf-32-le", "surrogatepass")
        b32 = s2.encode("utf-32-le", "surrogatepass")
        return getattr(lib, u32_fn)(a32, len(s1), b32, len(s2), *extra)
    a, b = _enc(s1), _enc(s2)
    return getattr(lib, byte_fn)(a, len(a), b, len(b), *extra)


def ratio(s1: str | bytes, s2: str | bytes) -> float:
    return _call("fm_ratio", "fm_ratio_u32", s1, s2)


def partial_ratio(s1: str | bytes, s2: str | bytes) -> float:
    return _call("fm_partial_ratio", "fm_partial_ratio_u32", s1, s2)


def partial_ratio_cutoff(s1: str | bytes, s2: str | bytes, cutoff: float) -> float:
    """rapidfuzz ``score_cutoff`` semantics: the exact partial_ratio when it
    reaches ``cutoff``, else 0.0."""
    return _call(
        "fm_partial_ratio_cutoff", "fm_partial_ratio_cutoff_u32", s1, s2, cutoff
    )


class CutoffArena:
    """Persistent packed-needle arena for repeated cutoff scoring.

    Built once per fixed name set (an entity index); each call ships only
    the selected row ids to the native kernel.  Non-ASCII names and
    non-ASCII haystacks take the per-pair route with identical scores.
    """

    def __init__(self, names: list[str | bytes]):
        self.names = list(names)
        self._per_pair_rows = {
            i for i, nd in enumerate(self.names)
            if isinstance(nd, str) and not nd.isascii()
        }
        enc = [
            b"" if i in self._per_pair_rows else _enc(nd)
            for i, nd in enumerate(self.names)
        ]
        self._lengths = np.array([len(e) for e in enc], dtype=np.int32)
        self._offsets = np.zeros(len(enc), dtype=np.int64)
        if len(enc) > 1:
            self._offsets[1:] = np.cumsum(self._lengths[:-1], dtype=np.int64)
        self._arena = b"".join(enc)

    def scores(self, haystack: str | bytes, rows, cutoff: float) -> np.ndarray:
        """``float64[len(rows)]`` — ``partial_ratio_cutoff(haystack,
        names[r], cutoff)`` for each selected row ``r``."""
        rows = np.asarray(rows, dtype=np.int32)
        out = np.zeros(len(rows), dtype=np.float64)
        if len(rows) == 0:
            return out
        lib = _load()
        if not (isinstance(haystack, bytes) or haystack.isascii()):
            for i, r in enumerate(rows):
                out[i] = partial_ratio_cutoff(haystack, self.names[r], cutoff)
            return out
        if self._per_pair_rows:
            batch = np.array(
                [r for r in rows if int(r) not in self._per_pair_rows],
                dtype=np.int32,
            )
        else:
            batch = rows
        if len(batch):
            hay = _enc(haystack)
            scores = np.zeros(len(batch), dtype=np.float64)
            lib.fm_partial_ratio_cutoff_select(
                hay, len(hay), self._arena, self._offsets.ctypes.data,
                self._lengths.ctypes.data, batch.ctypes.data, len(batch),
                cutoff, scores.ctypes.data,
            )
            if len(batch) == len(rows):
                return scores
            by_row = dict(zip(batch.tolist(), scores.tolist()))
            for i, r in enumerate(rows.tolist()):
                if r in by_row:
                    out[i] = by_row[r]
        for i, r in enumerate(rows.tolist()):
            if r in self._per_pair_rows:
                out[i] = partial_ratio_cutoff(haystack, self.names[r], cutoff)
        return out


class MultiPattern:
    """Multi-pattern exact matcher (native Aho-Corasick over bytes).

    Built once per fixed pattern set; :meth:`scan` enumerates every
    occurrence of every pattern in one pass over the text.  Byte-level:
    callers gate on ASCII (byte offsets == char offsets there) and apply
    word-boundary and non-overlap semantics themselves.
    """

    def __init__(self, patterns: list[bytes]):
        self.patterns = [bytes(p) for p in patterns]
        self._lib = _load()
        lens = np.fromiter(map(len, self.patterns), np.int64, len(self.patterns))
        offsets = np.zeros((len(self.patterns) + 1,), dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        blob = b"".join(self.patterns)
        handle = self._lib.fm_ac_build(blob, offsets.ctypes.data, len(self.patterns))
        self._handle = ctypes.c_void_p(handle) if handle else None

    @property
    def available(self) -> bool:
        return self._handle is not None

    def scan(self, text: bytes):
        """``(ids int32[k], starts int64[k])`` — every (pattern, start)
        occurrence, in end-position order (per-pattern starts ascending)."""
        if self._handle is None:
            raise RuntimeError("MultiPattern built over no patterns")
        cap = 256
        while True:
            ids = np.zeros((cap,), dtype=np.int32)
            starts = np.zeros((cap,), dtype=np.int64)
            n = self._lib.fm_ac_scan(
                self._handle, text, len(text),
                ids.ctypes.data, starts.ctypes.data, cap,
            )
            if n <= cap:
                return ids[:n], starts[:n]
            cap = int(n)  # exact total reported: one retry always suffices

    def __del__(self):
        h, self._handle = getattr(self, "_handle", None), None
        if h is not None:
            try:
                self._lib.fm_ac_destroy(h)
            except Exception:
                pass  # interpreter teardown: the OS reclaims it anyway
