"""Append-only CSV writing, torn-tail safe.

The port's copy of the reference's ``storage/csvio.py:_clean_end``,
``repair_torn_tail`` and ``AppendCsv`` (with ``_stat_sig`` and its clean
cache), unchanged but for two things: the reference's quarantine counters
and trace event (ROADMAP item 14) are left out, and so are the readers
``read_url_column``, ``scraped_url_set`` and ``count_rows`` with their
native scanner (item 18).

A process killed mid-``write_row`` leaves a *torn tail*, a final partial
record.  :func:`repair_torn_tail` moves those bytes to a
``<path>.quarantine`` sidecar and truncates the file back to its last
complete record; :class:`AppendCsv` runs it before it opens the file for
appending (append mode, header if the file is empty, flush per row, a
lock around each write).  All I/O goes through the ``storage.fsio`` seam.
"""

from __future__ import annotations

import csv
import os
import threading
from typing import Sequence

from advanced_scrapper_tpu_torch.storage.fsio import default_fs

_CHUNK = 1 << 20


def _clean_end(fh) -> int:
    """Byte offset just past the last COMPLETE record of an open binary CSV.

    A newline terminates a record iff the number of quote characters before
    it is even (inside a quoted field the running count is odd — embedded
    newlines and doubled escape quotes both preserve this, per the csv
    quoting grammar).  One forward chunked pass: splitting a chunk on the
    quote character yields segments whose parity alternates from the
    running parity, so the last even-parity newline per chunk falls out of
    C-speed ``split``/``rfind`` — multi-GB resume files are validated in a
    single read."""
    fh.seek(0)
    parity = 0  # quote count so far, mod 2
    pos = 0     # absolute offset of the current chunk
    last = 0    # offset just past the newest even-parity newline
    while True:
        chunk = fh.read(_CHUNK)
        if not chunk:
            return last
        parts = chunk.split(b'"')
        off = 0  # offset of parts[i] within the chunk
        best = -1
        for i, part in enumerate(parts):
            if (parity + i) % 2 == 0:
                k = part.rfind(b"\n")
                if k >= 0:
                    best = off + k
            off += len(part) + 1  # +1 for the quote that ended this part
        if best >= 0:
            last = pos + best + 1
        parity = (parity + len(parts) - 1) % 2
        pos += len(chunk)


#: (ino, size, mtime_ns) of files verified clean — a restart touches the
#: same resume CSV several times in a row (anti-join read, then the
#: AppendCsv reopen moments later); re-scanning a multi-GB file that
#: nothing wrote in between is pure re-work.  Any write moves size/mtime
#: and misses the cache, so a genuinely torn tail is always re-scanned.
_clean_cache: dict[str, tuple[int, int, int]] = {}


def _stat_sig(path: str) -> tuple[int, int, int] | None:
    try:
        st = os.stat(path)
        return (st.st_ino, st.st_size, st.st_mtime_ns)
    except OSError:
        return None


def repair_torn_tail(path: str, fs=None) -> int:
    """Quarantine a torn final record: move the bytes past the last complete
    record to ``<path>.quarantine`` and truncate the file back to whole
    records.  Returns the number of torn bytes moved (0 = file was clean).

    Quarantine-then-truncate on purpose: a crash between the two steps
    leaves the torn bytes in both places and the next repair simply
    quarantines them again — duplicate quarantine entries are harmless,
    silently deleted evidence is not.
    """
    fs = fs or default_fs()
    if not fs.exists(path):
        return 0
    key = os.path.abspath(path)
    sig = _stat_sig(path)
    if sig is not None and _clean_cache.get(key) == sig:
        return 0  # verified clean at this exact (ino, size, mtime)
    with fs.open(path, "rb") as fh:
        good = _clean_end(fh)
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        if good >= size:
            if sig is not None:
                _clean_cache[key] = sig
            return 0
        fh.seek(good)
        torn = fh.read(size - good)
    with fs.open(path + ".quarantine", "ab") as q:
        q.write(torn if torn.endswith(b"\n") else torn + b"\n")
        q.flush()
        try:
            fs.fsync(q)
        except OSError:
            pass
    with fs.open(path, "r+b") as fh:
        fh.truncate(good)
        fh.flush()
        try:
            fs.fsync(fh)
        except OSError:
            pass
    repaired = _stat_sig(path)
    if repaired is not None:
        _clean_cache[os.path.abspath(path)] = repaired
    return len(torn)


class AppendCsv:
    def __init__(self, path: str, fieldnames: Sequence[str], fs=None):
        self.path = path
        self.fieldnames = list(fieldnames)
        self._fs = fs or default_fs()
        self._lock = threading.Lock()
        # append-after-torn-tail would concatenate the new row onto the
        # partial one, corrupting BOTH — repair before the append handle
        # ever opens
        repair_torn_tail(path, fs=self._fs)
        existed = self._fs.exists(path) and self._fs.size(path) > 0
        self._fh = self._fs.open(path, "a", newline="", encoding="utf-8")
        self._writer = csv.DictWriter(self._fh, fieldnames=self.fieldnames)
        if not existed:
            self._writer.writeheader()
            self._fh.flush()

    def write_row(self, data: dict) -> None:
        """Write one row (missing fields become ''), flushing immediately."""
        row = {f: data.get(f, "") for f in self.fieldnames}
        with self._lock:
            self._writer.writerow(row)
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    def __enter__(self) -> "AppendCsv":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
