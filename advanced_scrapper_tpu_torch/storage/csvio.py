"""Resumable append-only CSV stores, torn-tail safe: the writer and the
resume readers.

The port's copy of the reference's ``storage/csvio.py:_clean_end``,
``repair_torn_tail`` and ``AppendCsv`` (with ``_stat_sig`` and its clean
cache), with its quarantine counters (``astpu_quarantine_total`` and
``astpu_quarantine_bytes_total``, ``kind="csv_torn_tail"``) and trace
event, and the readers ``read_url_column``, ``scraped_url_set`` and
``count_rows`` (with ``_BoundedRaw``, ``_open_clean_text`` and
``_read_clean_region``) over the native column scanner
(``cpu/csvnative.py``).

A process killed mid-``write_row`` leaves a *torn tail*, a final partial
record.  :func:`repair_torn_tail` moves those bytes to a
``<path>.quarantine`` sidecar and truncates the file back to its last
complete record; :class:`AppendCsv` runs it before it opens the file for
appending (append mode, header if the file is empty, flush per row, a
lock around each write).  All I/O goes through the ``storage.fsio`` seam.
"""

from __future__ import annotations

import csv
import io
import os
import threading
from typing import Sequence

from advanced_scrapper_tpu_torch.obs import telemetry, trace
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
    # a torn tail is a detected crash artifact: counted and traced
    telemetry.event_counter(
        "astpu_quarantine_total", "crash artifacts quarantined, by kind",
        kind="csv_torn_tail",
    ).inc()
    telemetry.event_counter(
        "astpu_quarantine_bytes_total", "bytes moved to quarantine sidecars",
        kind="csv_torn_tail",
    ).inc(len(torn))
    trace.record(
        "event", "quarantine.csv_torn_tail", path=os.path.basename(path), bytes=len(torn),
    )
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


class _BoundedRaw(io.RawIOBase):
    """Read-only raw view of the first ``limit`` bytes of an open binary
    file — lets the degraded-substrate fallback stream a multi-GB clean
    region through the csv parser instead of buffering it whole."""

    def __init__(self, fh, limit: int):
        self._fh = fh
        self._left = limit

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._left <= 0:
            return 0
        n = self._fh.readinto(memoryview(b)[: min(len(b), self._left)])
        self._left -= n
        return n

    def close(self) -> None:
        try:
            self._fh.close()
        finally:
            super().close()


def _open_clean_text(path: str, fs):
    """Text handle over the file's whole-record region, read without
    mutating it (the fallback for substrates where the repair write is
    not permitted).  Caller closes it (closes the chain)."""
    fh = fs.open(path, "rb")
    try:
        good = _clean_end(fh)
        fh.seek(0)
    except BaseException:
        fh.close()
        raise
    return io.TextIOWrapper(
        io.BufferedReader(_BoundedRaw(fh, good)),
        encoding="utf-8",
        errors="replace",
        newline="",
    )


def _read_clean_region(path: str, column: str, fs) -> list[str]:
    out: list[str] = []
    with _open_clean_text(path, fs) as txt:
        for row in csv.DictReader(txt):
            v = row.get(column)
            if v is not None:
                out.append(str(v))
    return out


def read_url_column(
    path: str, column: str = "url", fs=None, repair: bool = False
) -> list[str]:
    """Read one column as strings.

    Served by the C++ scanner (``native/csvscan.cpp``, built at first use;
    a failed build raises) — the resume anti-join re-reads multi-GB
    article CSVs on every start, the same job the original scraper hands
    to pandas' C parser (``constant_rate_scrapper.py:316-356``) — and by
    the ``csv`` module for the files the scanner does not serve: a missing
    column, bytes that are not UTF-8, a NUL inside a value.

    ``repair=True`` quarantines a torn tail first; it is only correct for
    FRAMEWORK-OWNED append artifacts (success/failed/annotation CSVs),
    whose writer newline-terminates every record — there, an unterminated
    tail IS a torn write.  The default read is lenient and non-mutating:
    an externally-authored work list may legitimately end without a
    trailing newline, and its final row must neither be dropped nor the
    user's file rewritten.  (:func:`scraped_url_set` — the resume
    anti-join over framework-owned CSVs — repairs by default.)
    """
    fs = fs or default_fs()
    if not fs.exists(path):
        return []
    if repair:
        try:
            repair_torn_tail(path, fs=fs)
        except OSError:
            return _read_clean_region(path, column, fs)
    from advanced_scrapper_tpu_torch.cpu.csvnative import scan_column

    native = scan_column(path, column)
    if native is not None:
        return native
    out: list[str] = []
    with fs.open(path, newline="", encoding="utf-8") as fh:
        for row in csv.DictReader(fh):
            v = row.get(column)
            if v is not None:
                out.append(str(v))
    return out


def scraped_url_set(
    *paths: str, column: str = "url", fs=None, repair: bool = True
) -> set[str]:
    """Union of url columns across existing CSVs — the resume anti-join set
    (``constant_rate_scrapper.py:317-342``).  These are the framework's
    own success/failed CSVs, so torn tails are quarantined first: a torn
    row must never masquerade as a completed URL."""
    seen: set[str] = set()
    for p in paths:
        seen.update(read_url_column(p, column, fs=fs, repair=repair))
    return seen


def count_rows(path: str, fs=None, repair: bool = True) -> int:
    """Data-row count of a framework-owned CSV (repairs torn tails first,
    like :func:`scraped_url_set`; pass ``repair=False`` for files the
    framework does not write)."""
    fs = fs or default_fs()
    if not fs.exists(path):
        return 0
    if repair:
        try:
            repair_torn_tail(path, fs=fs)
        except OSError:
            with _open_clean_text(path, fs) as txt:
                n = sum(1 for _ in csv.reader(txt))
            return max(0, n - 1)
    with fs.open(path, newline="", encoding="utf-8") as fh:
        n = sum(1 for _ in csv.reader(fh))
    return max(0, n - 1)  # minus header
