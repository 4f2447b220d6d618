"""Write-ahead log of (band-key, doc-id) postings — torn-tail-safe.

The port's copy of the reference's ``index/wal.py``, unchanged below this
paragraph but for its imports: both packages write and replay the same
bytes, so either one reopens the other's log.  Module names below are the
reference's.

The WAL is the durability floor of :class:`~.store.PersistentIndex`: every
posting batch is appended here *before* it enters the in-memory memtable, so
a crash at any instant loses at most the record that was mid-write — and
that record is dropped *whole* on replay (CRC framing), never half-applied.
Re-processing the document that produced it then converges: its postings
were either fully durable (the done-probe finds them) or fully absent (they
are appended again).

Framing: each append is ONE record ::

    magic u32 | n u32 | crc32 u32 | keys u64[n] | docs u64[n]

with the CRC over the payload (keys+docs bytes).  Replay walks records from
the start and stops at the first short / CRC-failing record — by
construction that can only be the tail left by a crashed writer.  A *failed*
append inside a live process (injected EIO / short write through the
``storage.fsio`` seam) truncates the file back to the pre-append offset so
later appends never sit behind a torn record mid-file; if even the truncate
fails the log marks itself broken and refuses further appends rather than
corrupt framing silently.

All I/O goes through the fsio seam, so ``ChaosFs`` torn-write / fsync /
crash faults apply to the WAL for free (the crashsweep ``pindex`` workload
kills inside these appends).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from advanced_scrapper_tpu_torch.storage.fsio import default_fs

__all__ = ["WriteAheadLog", "replay_wal"]

_MAGIC = 0xA51DC0DE
_HEADER = struct.Struct("<III")  # magic, n, crc32(payload)


def _payload(keys: np.ndarray, docs: np.ndarray) -> bytes:
    return keys.tobytes() + docs.tobytes()


class WriteAheadLog:
    """Append-only posting log for one index directory generation."""

    def __init__(self, path: str, fs=None):
        self.path = path
        self._fs = fs or default_fs()
        self._fh = self._fs.open(path, "ab")
        self._broken = False
        self.appended = 0  # postings appended through THIS handle

    def append(self, keys: np.ndarray, docs: np.ndarray) -> None:
        """Durably frame one posting batch; all-or-nothing on replay.

        On an injected/real write error the record is rolled back
        (truncate to the pre-append offset) so the log stays well-framed
        for subsequent appends; the caller must treat the batch as NOT
        persisted (and must not add it to the memtable).
        """
        if self._broken:
            raise OSError(f"write-ahead log {self.path} is broken; reopen the index")
        keys = np.ascontiguousarray(keys, dtype=np.uint64).ravel()
        docs = np.ascontiguousarray(docs, dtype=np.uint64).ravel()
        if keys.shape != docs.shape:
            raise ValueError(f"keys/docs length mismatch: {keys.shape} vs {docs.shape}")
        if keys.size == 0:
            return
        payload = _payload(keys, docs)
        rec = _HEADER.pack(_MAGIC, keys.size, zlib.crc32(payload)) + payload
        start = self._fh.tell()
        try:
            self._fh.write(rec)
            self._fh.flush()
        except BaseException:
            # a SimulatedCrash propagates (the process is "dead" — disk
            # keeps the torn tail, exactly like SIGKILL); ordinary errors
            # roll the partial record back so framing survives
            try:
                self._fh.truncate(start)
                self._fh.seek(0, os.SEEK_END)
            except Exception:
                self._broken = True
            raise
        self.appended += keys.size

    def sync(self) -> None:
        """fsync the log (the checkpoint-cadence durability point)."""
        self._fh.flush()
        self._fs.fsync(self._fh)

    def close(self) -> None:
        try:
            self._fh.close()
        except Exception:
            pass


def replay_wal(path: str, fs=None) -> tuple[np.ndarray, np.ndarray, int]:
    """Recover every whole record: ``(keys u64[n], docs u64[n], valid_end)``.

    Stops at the first torn/corrupt record — the tail a crashed writer
    left — and returns everything before it, plus the byte offset where
    the valid prefix ends.  A writer REOPENING the log must truncate the
    file to ``valid_end`` first (``PersistentIndex`` does): appending in
    ``ab`` mode behind a torn record would leave every new record
    unreplayable forever, since replay can never walk past the garbage.
    A missing file is an empty log (the fresh-directory case).
    """
    fs = fs or default_fs()
    if not fs.exists(path):
        e = np.zeros((0,), np.uint64)
        return e, e, 0
    keys_parts: list[np.ndarray] = []
    docs_parts: list[np.ndarray] = []
    with fs.open(path, "rb") as fh:
        data = fh.read()
    off = 0
    while off + _HEADER.size <= len(data):
        magic, n, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            break
        body_len = 16 * n  # u64 keys + u64 docs
        end = off + _HEADER.size + body_len
        if end > len(data):
            break  # short tail record
        payload = data[off + _HEADER.size : end]
        if zlib.crc32(payload) != crc:
            break  # torn mid-record
        keys_parts.append(np.frombuffer(payload, np.uint64, count=n))
        docs_parts.append(np.frombuffer(payload, np.uint64, count=n, offset=8 * n))
        off = end
    if not keys_parts:
        e = np.zeros((0,), np.uint64)
        return e, e, off
    return np.concatenate(keys_parts), np.concatenate(docs_parts), off
