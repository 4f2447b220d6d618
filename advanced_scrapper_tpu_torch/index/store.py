"""The persistent corpus index: WAL → memtable → segments → compaction.

The port's copy of the reference's ``index/store.py``.  The manifest, the
WAL and segment files and the docmap are the reference's byte for byte, so
either package reopens the other's directory and goes on to the same
answers.  What differs: the reference exports its counters through
``obs.telemetry`` and traces quarantines (ROADMAP item 14); here the
counts are plain integers on the index (``probe_rows``, ``probe_hits``,
``postings_appended``, ``segment_cuts``, ``compactions``, ``tombstoned``,
``wal_torn``, ``quarantined``, ``corrupt_segments``, ``scrubs``,
``docmap_errors``), beside ``stats()`` and ``observed_fp_ratio()``.
:meth:`PersistentIndex.close` joins a running compaction thread.  Module
names below are the reference's.

:class:`PersistentIndex` is the durable cross-run successor of every
session-local dedup index in the tree.  It stores ``(band-key → doc-id)``
postings for an evolving corpus with three properties the npz-checkpoint
model could not give:

- **incremental durability** — every posting batch is framed into a
  write-ahead log (:mod:`.wal`) through the ``storage.fsio`` seam *before*
  it becomes probe-able, so no save/load of the whole index ever happens
  and a crash at any byte loses at most one in-flight batch (which the
  producer re-derives on resume);
- **bounded resident memory** — postings live in immutable sorted segment
  files (:mod:`.segment`); only their per-segment Bloom filters stay in
  RAM, so probing a billion-posting history is a Bloom check plus a rare
  memmap'd binary search (the LSHBloom contract, with attribution);
- **crash-safe reorganisation** — segment cuts and compactions commit by
  atomically swapping ``manifest.json`` (the single source of truth for
  which files are live); every file not named by the manifest is an orphan
  from a crashed writer and is swept on open.

First-seen-wins attribution is encoded in doc-id order: doc ids are
allocated monotonically (persisted via the manifest, re-derived from the
WAL on crash), a probe returns the *minimum* doc id over all postings for
a key, and compaction tombstones every posting for a key except the
minimum — later postings are superseded by definition, because no probe
can ever prefer them.

Concurrency: one writer thread (insert/cut) + N probe threads + an
optional background compaction thread.  Mutable state (memtable, segment
list, manifest) is guarded by one lock; segment files themselves are
immutable, so the heavy merge work runs outside the lock.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from advanced_scrapper_tpu_torch.index.repair import (
    interval_add,
    interval_sub,
    range_mask,
    semantic_min,
)
from advanced_scrapper_tpu_torch.index.segment import (
    Segment,
    SegmentCorruption,
    file_digest,
    write_segment,
)
from advanced_scrapper_tpu_torch.index.wal import WriteAheadLog, replay_wal
from advanced_scrapper_tpu_torch.storage.fsio import atomic_replace, default_fs

__all__ = ["PersistentIndex", "resolve_intra_batch"]

MANIFEST = "manifest.json"
DOCMAP = "docmap.log"

#: seconds an idle cached semantic state (repair/digest input) survives —
#: long enough to span one paged repair conversation, short enough that a
#: finished repair frees the arrays at the next checkpoint beat
SEMANTIC_CACHE_TTL_S = 60.0

NO_DOC = np.int64(-1)


def _wal_name(seq: int) -> str:
    return f"wal-{seq:08d}.log"


def _seg_name(seq: int) -> str:
    return f"seg-{seq:08d}.seg"


def resolve_intra_batch(
    keys: np.ndarray, doc_ids: np.ndarray, attr: np.ndarray
) -> np.ndarray:
    """First-seen-wins resolution WITHIN one batch, in place.

    ``attr`` is the cross-run attribution the index probe produced
    (``-1`` = no historical match); rows sharing a band key with an
    earlier still-fresh row of the same batch attribute to that row's doc
    id.  Kept (fresh) rows only ever become attribution targets — a dup
    row's id is never posted, so it must never be referenced.

    Shared verbatim by :meth:`PersistentIndex.check_and_add_batch` and
    the fleet client (``index/fleet.py``): the byte-equality of a sharded
    fleet against the single-node oracle rests on both running exactly
    this resolution between the probe and the insert.
    """
    B, nb = keys.shape
    # the pass only touches rows holding a key that occurs in MORE than
    # one row of the batch — any other row can neither match an earlier
    # row nor be matched by a later one, so the (ordered, kept-rows-only)
    # resolution loop runs over the shared minority
    uniq, counts = np.unique(keys, return_counts=True)
    kc = counts[np.searchsorted(uniq, keys.ravel())].reshape(B, nb)
    shared_rows = np.flatnonzero((kc > 1).any(axis=1))
    kept_keys: dict[int, int] = {}  # key → doc id of the first KEPT row
    for r in shared_rows.tolist():
        row = keys[r].tolist()
        if attr[r] < 0:
            for k in row:
                d = kept_keys.get(k)
                if d is not None:
                    attr[r] = d
                    break
        if attr[r] < 0:
            for k in row:
                kept_keys.setdefault(k, int(doc_ids[r]))
    return attr


class PersistentIndex:
    """A sharded log-structured (key → doc-id) posting index on disk."""

    def __init__(
        self,
        directory: str,
        *,
        cut_postings: int = 1 << 16,
        compact_segments: int = 8,
        compact_inline: bool = False,
        read_only: bool = False,
        fs=None,
    ):
        """Open (or create) the index at ``directory``.

        ``cut_postings`` — memtable postings that trigger a segment cut
        (the WAL/segment-cut cadence; the scraper maps its checkpoint knob
        here).  ``compact_segments`` — live-segment count that triggers
        compaction (0 disables); compaction runs on a daemon thread unless
        ``compact_inline`` (tests, and the crashsweep child, need the
        deterministic ordering).

        ``read_only`` — open for probing/inspection WITHOUT mutating the
        directory: no orphan sweep, no WAL tail repair, no append handle.
        The only safe way to open a directory a live writer may own (the
        offline ``lookup_names`` flow, the crashsweep safety checker) —
        a writable open would sweep the writer's pre-commit cut files out
        from under it.  Mutating calls raise.
        """
        self.dir = directory
        self.cut_postings = int(cut_postings)
        self.compact_segments = int(compact_segments)
        self.compact_inline = bool(compact_inline)
        self.read_only = bool(read_only)
        self._fs = fs or default_fs()
        self._lock = threading.RLock()
        self._compact_busy = threading.Lock()
        #: the daemon compaction thread last started (joined by close)
        self._compactor: threading.Thread | None = None
        # the counts the reference exports as telemetry
        self.probe_rows = self.probe_hits = self.postings_appended = 0
        self.segment_cuts = self.compactions = self.tombstoned = 0
        self.wal_torn = self.quarantined = self.corrupt_segments = 0
        self.scrubs = self.docmap_errors = 0
        if not read_only:
            os.makedirs(directory, exist_ok=True)

        t0 = time.perf_counter()
        man = self._load_manifest()
        self._seg_seq = int(man.get("seg_seq", 0))
        self._wal_seq = int(man.get("wal_seq", 0))
        #: whole-file digest per live segment (manifest-recorded identity;
        #: pre-v2 manifests lack entries — scrub backfills them)
        self._digests: dict[str, str] = dict(man.get("digests", {}))
        self._segments: list[Segment] = []
        dirty_manifest = False
        for name in man.get("segments", []):
            path = os.path.join(directory, name)
            try:
                self._segments.append(Segment(path, fs=self._fs))
            except (FileNotFoundError, ValueError, SegmentCorruption) as e:
                # the torn-artifact rule: a segment that cannot be
                # opened because its BYTES are wrong (header-CRC
                # mismatch, truncation, bad magic, bit rot in the
                # resident planes) or is simply gone is quarantined —
                # sidecar + counter — and the index continues on the
                # surviving manifest instead of crashing the whole open.
                # Transient resource errors (EMFILE/ENOMEM/EINTR…) are
                # NOT corruption and propagate: quarantining a healthy
                # segment on fd pressure would permanently withdraw its
                # postings where a plain retry loses nothing.
                self._quarantine_segment_file(path, str(e))
                self._digests.pop(name, None)
                dirty_manifest = True
        if not read_only:
            self._sweep_orphans(
                {os.path.basename(s.path) for s in self._segments}
            )
        # WAL replay rebuilds the memtable; its doc ids also re-derive the
        # allocation high-water mark a crash may have kept out of the
        # manifest (manifest next_doc_id is only persisted at cut time)
        wal_path = os.path.join(directory, _wal_name(self._wal_seq))
        mk, md, wal_end = replay_wal(wal_path, fs=self._fs)
        self._mem_keys: list[np.ndarray] = [mk] if mk.size else []
        self._mem_docs: list[np.ndarray] = [md] if md.size else []
        self._mem_count = int(mk.size)
        self._mem_map: dict[int, int] = {}
        for k, d in zip(mk.tolist(), md.tolist()):
            prev = self._mem_map.get(k)
            if prev is None or d < prev:
                self._mem_map[k] = d
        self._next_doc_id = int(man.get("next_doc_id", 0))
        if md.size:
            self._next_doc_id = max(self._next_doc_id, int(md.max()) + 1)
        #: ring ranges (mixed space, [lo, hi) Python ints) this node has
        #: legitimately handed off to a new owner: physically present
        #: postings inside them are excluded from every semantic read
        #: (probe/dump/digest) and new inserts for them are dropped —
        #: logical tombstones, so replicas retired at different instants
        #: still digest-agree and fsck sees handoff, not loss
        self._handed_off: list[tuple[int, int]] = [
            (int(a), int(b)) for a, b in man.get("handed_off", [])
        ]
        #: active reshard fence ({"token": ...}) — snapshot tooling
        #: refuses to capture a node mid-cutover
        self._reshard_mark: dict | None = man.get("reshard") or None
        #: (state key, (keys, docs), warmed-at) — see semantic_items
        self._semantic_cache = None
        if read_only:
            self._wal = None
        else:
            self._repair_wal_tail(wal_path, wal_end)
            self._wal = WriteAheadLog(wal_path, fs=self._fs)
            if dirty_manifest:
                # commit the quarantine: the manifest must stop naming the
                # sidelined segment or every reopen re-quarantines a file
                # that is no longer there
                self._write_manifest()
        self.reopen_seconds = time.perf_counter() - t0
        if not read_only and os.environ.get("ASTPU_INDEX_SCRUB", "") not in ("", "0"):
            self.scrub()

    def _repair_wal_tail(self, wal_path: str, valid_end: int) -> None:
        """Truncate a torn WAL tail before reopening the appender: records
        appended in ``ab`` mode BEHIND torn garbage would be unreplayable
        forever (replay stops at the first bad frame), so every posting of
        the recovered session until the next cut would silently vanish on
        the following open."""
        if not self._fs.exists(wal_path):
            return
        if self._fs.size(wal_path) <= valid_end:
            return
        with self._fs.open(wal_path, "r+b") as fh:
            fh.truncate(valid_end)
        self.wal_torn += 1

    def _check_writable(self) -> None:
        if self.read_only:
            raise ValueError(
                f"index at {self.dir} was opened read_only; probing and "
                "lookup_names are allowed, mutation is not"
            )

    # -- manifest / recovery -------------------------------------------------

    def _load_manifest(self) -> dict:
        path = os.path.join(self.dir, MANIFEST)
        if not self._fs.exists(path):
            return {}
        with self._fs.open(path, "rb") as fh:
            man = json.loads(fh.read().decode("utf-8"))
        if int(man.get("version", 1)) != 1:
            raise ValueError(f"unknown index manifest version in {path}")
        return man

    def _manifest_dict(self) -> dict:
        names = [os.path.basename(s.path) for s in self._segments]
        man = {
            "version": 1,
            "seg_seq": self._seg_seq,
            "wal_seq": self._wal_seq,
            "segments": names,
            "next_doc_id": self._next_doc_id,
            # whole-file digests: the corruption detector of last resort
            # (scrub/fsck recompute and compare) and the snapshot tool's
            # transfer-verification source
            "digests": {n: self._digests[n] for n in names if n in self._digests},
        }
        if self._handed_off:
            man["handed_off"] = [[a, b] for a, b in self._handed_off]
        if self._reshard_mark:
            man["reshard"] = dict(self._reshard_mark)
        return man

    def _write_manifest(self) -> None:
        """Atomic commit point for every structural change (cut, compact,
        rotation): the swapped file names exactly the live segment set,
        the live WAL generation, the doc-id high-water mark and every
        segment's whole-file digest."""
        atomic_replace(
            os.path.join(self.dir, MANIFEST),
            json.dumps(self._manifest_dict(), indent=1).encode("utf-8"),
            fs=self._fs,
        )

    def _sweep_orphans(self, live_segments: set) -> None:
        """Delete files a crashed writer left that the manifest does not
        name: cut/compaction outputs whose commit never happened, and WAL
        generations superseded by a committed rotation.  Never touches the
        live WAL or live segments, so a sweep is always safe."""
        live_wal = _wal_name(self._wal_seq)
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            stale = (
                (name.endswith(".seg") and name not in live_segments)
                or (name.startswith("wal-") and name.endswith(".log")
                    and name != live_wal)
            )
            if stale:
                try:
                    self._fs.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

    # -- integrity: quarantine & scrub ---------------------------------------

    def _quarantine_segment_file(self, path: str, reason: str) -> None:
        """Sideline one corrupt/torn segment FILE: rename to the
        ``.quarantine`` sidecar (evidence preserved for the operator,
        invisible to every reader pattern) and count it.  In read-only
        mode the file is left in place — the checker observes, never
        mutates — but the drop from the live set still counts.
        ``reason`` is what the reference's trace records."""
        if not self.read_only:
            try:
                if self._fs.exists(path):
                    self._fs.replace(path, path + ".quarantine")
            except OSError:
                pass
        self.quarantined += 1

    def _quarantine_live_segment(self, seg: Segment, reason: str) -> None:
        """Quarantine a segment that is currently serving: drop it from
        the live set, commit the shrunken manifest, THEN sideline the
        file.  Postings it held stop answering — wrong answers would be
        worse — until scrub/repair (or a replica) restores them."""
        name = os.path.basename(seg.path)
        with self._lock:
            if seg not in self._segments:
                return  # a racing probe already quarantined it
            self._segments = [s for s in self._segments if s is not seg]
            self._digests.pop(name, None)
            if not self.read_only:
                try:
                    self._write_manifest()
                except OSError:
                    pass  # reopen re-quarantines; the sidecar rename below
                    #       still stops this file from being served
        # like compaction's swap: the dropped ref keeps any racing probe
        # alive (POSIX rename semantics — the memmap outlives the name);
        # never Segment.close()d here, or a concurrent probe of the same
        # snapshot would read from released arrays
        self._quarantine_segment_file(seg.path, reason)

    def scrub(self) -> dict:
        """End-to-end corruption pass: eagerly verify every block CRC of
        every live segment plus its manifest-recorded whole-file digest.
        Corrupt segments are quarantined (never served again); segments
        predating digest records get their digest backfilled.  Returns a
        report dict; safe on a read-only open (observe, don't mutate).

        Callers: ``ASTPU_INDEX_SCRUB=1`` runs it at open, the shard
        server exposes it as the ``scrub`` RPC, ``tools/fsck_index.py``
        is the offline twin."""
        with self._lock:
            snapshot = list(self._segments)
        report: dict = {
            "dir": self.dir,
            "segments": len(snapshot),
            "corrupt": [],
            "backfilled_digests": 0,
        }
        backfilled = False
        for seg in snapshot:
            name = os.path.basename(seg.path)
            try:
                digest = seg.verify_all(fs=self._fs)
            except SegmentCorruption as e:
                report["corrupt"].append({"segment": name, "detail": e.detail})
                self.corrupt_segments += 1
                self._quarantine_live_segment(seg, e.detail)
                continue
            except OSError:
                # the file vanished under us: a racing compaction
                # superseded this snapshot entry (its postings live in
                # the merged segment, which a later scrub covers) — not
                # corruption, just a stale snapshot row
                with self._lock:
                    still_live = seg in self._segments
                if still_live:
                    raise
                continue
            with self._lock:
                want = self._digests.get(name)
                if want is None:
                    self._digests[name] = digest
                    report["backfilled_digests"] += 1
                    backfilled = True
            if want is not None and want != digest:
                detail = (
                    f"whole-file digest mismatch ({digest} != manifest "
                    f"{want})"
                )
                report["corrupt"].append({"segment": name, "detail": detail})
                self.corrupt_segments += 1
                self._quarantine_live_segment(seg, detail)
        if backfilled and not self.read_only:
            with self._lock:
                self._write_manifest()
        self.scrubs += 1
        report["ok"] = not report["corrupt"]
        return report

    def semantic_items(self) -> tuple[np.ndarray, np.ndarray]:
        """The index's SEMANTIC state: sorted unique keys + the minimum
        doc id each attributes to — the representation anti-entropy
        digests and repair transfers run over (compaction timing and
        posting multiplicity cancel out of it by construction).

        Cached on the structural state (segment set + memtable size): a
        repair conversation pages dozens of digest/fetch_range calls
        against one quiescent state, and each would otherwise re-sort
        every posting.  The cache is dropped on the next insert and aged
        out at checkpoint cadence (:data:`SEMANTIC_CACHE_TTL_S`) so a
        finished repair never pins the materialised state indefinitely.
        Callers must treat the arrays as read-only."""
        key = self._semantic_key()
        with self._lock:
            cached = self._semantic_cache
            if cached is not None and cached[0] == key:
                return cached[1]
        items = semantic_min(*self.dump_postings())
        with self._lock:
            # only cache if the state did not move under the computation
            # (else the arrays would be filed under a stale key)
            if self._semantic_key() == key:
                self._semantic_cache = (key, items, time.monotonic())
        return items

    def _semantic_key(self):
        with self._lock:
            return (
                self._seg_seq, self._wal_seq, self._mem_count,
                tuple(os.path.basename(s.path) for s in self._segments),
                tuple(self._handed_off),
            )

    def _age_semantic_cache(self) -> None:
        """Free the materialised semantic arrays once the repair
        conversation that warmed them has clearly ended."""
        with self._lock:
            cached = self._semantic_cache
            if (
                cached is not None
                and time.monotonic() - cached[2] > SEMANTIC_CACHE_TTL_S
            ):
                self._semantic_cache = None

    # -- snapshot ------------------------------------------------------------

    def snapshot_meta(self) -> dict:
        """Consistent-snapshot fence + pin: cut the memtable (after the
        cut the WAL generation is empty, so the durable state is exactly
        manifest + immutable segments), then name every live file with
        its size and digest.  The returned dict + the named files ARE the
        snapshot; ``tools/fleet_snapshot.py`` assembles them."""
        if not self.read_only:
            self.cut_segment()  # no-op on an empty memtable
        with self._lock:
            files = []
            for s in self._segments:
                name = os.path.basename(s.path)
                digest = self._digests.get(name)
                if digest is None:
                    digest = file_digest(s.path, fs=self._fs)
                    self._digests[name] = digest
                files.append(
                    {"name": name, "bytes": int(self._fs.size(s.path)),
                     "digest": digest}
                )
            docmap = os.path.join(self.dir, DOCMAP)
            if self._fs.exists(docmap):
                files.append(
                    {"name": DOCMAP, "bytes": int(self._fs.size(docmap)),
                     "digest": file_digest(docmap, fs=self._fs)}
                )
            return {"manifest": self._manifest_dict(), "files": files}

    def read_file(self, name: str, offset: int = 0, limit: int | None = None) -> bytes:
        """Paged raw read of one snapshot-named file (segment, docmap or
        the manifest itself) — the ``fetch_file`` RPC body.  ``name`` is
        a bare basename; path traversal is rejected."""
        if os.path.basename(name) != name or name.startswith("."):
            raise ValueError(f"bad snapshot file name {name!r}")
        with self._lock:
            live = {os.path.basename(s.path) for s in self._segments}
        if name not in live and name not in (MANIFEST, DOCMAP):
            raise ValueError(f"{name!r} is not a live snapshot file")
        with self._fs.open(os.path.join(self.dir, name), "rb") as fh:
            fh.seek(int(offset))
            return fh.read(-1 if limit is None else int(limit))

    # -- resharding: handed-off ranges + cutover fence -----------------------

    def retire_range(self, lo: int, hi: int) -> None:
        """Record that ring range ``[lo, hi)`` (mixed space) was handed
        off to a new owner: one atomic manifest write, idempotent, after
        which every semantic read excludes the range and inserts for it
        are dropped.  Logical — no postings are physically deleted (the
        next compaction naturally rewrites without them being special)."""
        self._check_writable()
        with self._lock:
            merged = interval_add(self._handed_off, int(lo), int(hi))
            if merged == self._handed_off:
                return
            self._handed_off = merged
            self._semantic_cache = None
            self._write_manifest()

    def unretire_range(self, lo: int, hi: int) -> None:
        """Re-acquire ``[lo, hi)`` — the N→M→N round trip hands an arc
        back to a node that once retired it; from this write on, inserts
        for the range land again.  (Postings resident from BEFORE the
        original handoff become visible again too — strictly older
        attributions the incoming migration stream re-asserts, and the
        cutover digest gate verifies the merged state byte-for-byte
        before this node answers reads for the range.)"""
        self._check_writable()
        with self._lock:
            cut = interval_sub(self._handed_off, int(lo), int(hi))
            if cut == self._handed_off:
                return
            self._handed_off = cut
            self._semantic_cache = None
            self._write_manifest()

    def handed_off_ranges(self) -> list[tuple[int, int]]:
        with self._lock:
            return list(self._handed_off)

    def set_reshard_mark(self, token: str) -> None:
        """Fence: a reshard involving this node is in flight.  Snapshot
        tooling refuses (or waits out) marked nodes — a manifest-of-
        manifests captured across a half-flipped range would restore a
        fleet that disagrees with itself."""
        self._check_writable()
        with self._lock:
            self._reshard_mark = {"token": str(token)}
            self._write_manifest()

    def clear_reshard_mark(self) -> None:
        self._check_writable()
        with self._lock:
            if self._reshard_mark is None:
                return
            self._reshard_mark = None
            self._write_manifest()

    def reshard_mark(self) -> dict | None:
        with self._lock:
            return dict(self._reshard_mark) if self._reshard_mark else None

    # -- sizing / introspection ----------------------------------------------

    def resident_bytes(self) -> int:
        """RAM the index holds: segment Blooms + memtable postings (the
        bounded-memory contract the two-session test asserts — NOT the
        on-disk posting bytes, which are memmap'd)."""
        with self._lock:
            seg = sum(s.resident_bytes for s in self._segments)
            # dict entry ≈ 2 boxed ints + slot; 64 B is a safe upper figure
            return seg + self._mem_count * 16 + len(self._mem_map) * 64

    def disk_postings_bytes(self) -> int:
        with self._lock:
            return sum(16 * s.count for s in self._segments) + 16 * self._mem_count

    def posting_count(self) -> int:
        """Live postings (segments + memtable) — the cheap gauge accessor
        (no resident/byte aggregation; one lock, one sum)."""
        with self._lock:
            return sum(s.count for s in self._segments) + self._mem_count

    def observed_fp_ratio(self) -> float:
        with self._lock:
            hits = sum(s.bloom_hits for s in self._segments)
            false = sum(s.bloom_false for s in self._segments)
        return false / hits if hits else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "segments": len(self._segments),
                "segment_postings": sum(s.count for s in self._segments),
                "segment_bytes": sum(s.file_bytes for s in self._segments),
                "wal_postings": self._mem_count,
                "resident_bytes": self.resident_bytes(),
                "next_doc_id": self._next_doc_id,
                "observed_bloom_fp": self.observed_fp_ratio(),
            }

    def dump_postings(self) -> tuple[np.ndarray, np.ndarray]:
        """Every live posting ``(keys, docs)`` — verification surface for
        the crash sweep's zero-lost / zero-duplicated assertions.  Keys in
        handed-off ranges are excluded: they belong to another node now,
        and counting them here would read as duplication fleet-wide."""
        with self._lock:
            parts = [s.arrays() for s in self._segments]
            parts += [(k, d) for k, d in zip(self._mem_keys, self._mem_docs)]
            handed = list(self._handed_off)
        if not parts:
            e = np.zeros((0,), np.uint64)
            return e, e
        keys = np.concatenate([p[0] for p in parts])
        docs = np.concatenate([p[1] for p in parts])
        if handed and keys.size:
            keep = ~range_mask(keys, handed)
            keys, docs = keys[keep], docs[keep]
        return keys, docs

    # -- doc-id allocation / attribution -------------------------------------

    def allocate_doc_ids(self, n: int) -> np.ndarray:
        """``uint64[n]`` monotonically increasing ids.  Durable high-water:
        every POSTED id raises ``next_doc_id`` (``insert_batch``), which
        re-derives from the WAL on crash and from the manifest after a
        cut; ids handed out but never posted anywhere may be reissued
        after a restart — by then nothing durable references them (a
        caller posting ids into SIBLING indexes must union the floors at
        open: :meth:`doc_id_floor` / :meth:`raise_doc_id_floor`)."""
        self._check_writable()
        with self._lock:
            start = self._next_doc_id
            self._next_doc_id += int(n)
        return np.arange(start, start + n, dtype=np.uint64)

    def doc_id_floor(self) -> int:
        """The smallest id this index would allocate next — ≥ every id it
        has durably seen (posted, or reserved via a committed manifest)."""
        with self._lock:
            return self._next_doc_id

    def raise_doc_id_floor(self, floor: int) -> None:
        """Never allocate below ``floor`` — the cross-sub-index union hook:
        a backend allocating from THIS index but posting those ids into a
        sibling index too must, at open, raise this floor to the sibling's
        (else a crash before this index saw the ids durably would reissue
        them, silently re-pointing the sibling's old attributions)."""
        with self._lock:
            self._next_doc_id = max(self._next_doc_id, int(floor))

    def log_names(self, doc_ids, names) -> None:
        """Best-effort ``doc-id → name`` sidecar (attribution for humans;
        the index itself never reads it).  Torn tails are tolerated by the
        reader, so a crash mid-append costs at most one mapping line."""
        self._check_writable()
        lines = "".join(
            f"{int(d)}\t{str(n)}\n" for d, n in zip(doc_ids, names)
        ).encode("utf-8")
        try:
            with self._fs.open(os.path.join(self.dir, DOCMAP), "ab") as fh:
                fh.write(lines)
        except OSError:
            self.docmap_errors += 1

    def lookup_names(self, doc_ids) -> dict[int, str]:
        """Resolve doc ids from the sidecar (offline/operator path: O(file))."""
        want = {int(d) for d in doc_ids}
        out: dict[int, str] = {}
        path = os.path.join(self.dir, DOCMAP)
        if not self._fs.exists(path):
            return out
        with self._fs.open(path, "rb") as fh:
            data = fh.read()
        for line in data.split(b"\n")[:-1]:  # unterminated tail = torn, skip
            did, _, name = line.partition(b"\t")
            try:
                i = int(did)
            except ValueError:
                continue
            if i in want and i not in out:  # first-seen mapping wins
                out[i] = name.decode("utf-8", "replace")
        return out

    # -- core API ------------------------------------------------------------

    def insert_batch(self, keys: np.ndarray, docs: np.ndarray) -> None:
        """Durably append postings; they become probe-able only after the
        WAL framed them (all-or-nothing per call), then cut a segment if
        the memtable crossed the cadence threshold."""
        self._check_writable()
        keys = np.ascontiguousarray(keys, dtype=np.uint64).ravel()
        docs = np.ascontiguousarray(docs, dtype=np.uint64).ravel()
        if keys.size and self._handed_off:
            # keys this node handed off are another owner's now — dropping
            # them makes a late retry/replay harmless and keeps retired
            # replicas digest-identical
            with self._lock:
                handed = list(self._handed_off)
            keep = ~range_mask(keys, handed)
            if not keep.all():
                keys, docs = keys[keep], docs[keep]
        if keys.size == 0:
            return
        with self._lock:
            self._wal.append(keys, docs)  # raises ⇒ nothing became visible
            self._mem_keys.append(keys)
            self._mem_docs.append(docs)
            self._mem_count += keys.size
            mem = self._mem_map
            for k, d in zip(keys.tolist(), docs.tolist()):
                prev = mem.get(k)
                if prev is None or d < prev:
                    mem[k] = d
            # posted ids raise the allocation floor so it survives the cut
            # (manifest persists next_doc_id) and the crash (WAL replay)
            self._next_doc_id = max(self._next_doc_id, int(docs.max()) + 1)
            self._semantic_cache = None  # state moved; free the arrays
            self.postings_appended += keys.size
            due = self._mem_count >= self.cut_postings
        if due:
            self.cut_segment()

    def probe_batch(self, keys: np.ndarray) -> np.ndarray:
        """``int64[B]`` earliest (minimum) candidate doc id per query row,
        ``-1`` where no band key of the row has ever been posted.

        ``keys`` is ``uint64[B, nb]`` (one row per document, one column per
        LSH band) or ``uint64[B]`` (single-key probes, e.g. url hashes).
        """
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.ndim == 1:
            keys = keys[:, None]
        B = keys.shape[0]
        if B == 0:
            return np.zeros((0,), np.int64)
        flat = keys.ravel()
        best = np.full(flat.shape, np.iinfo(np.int64).max, np.int64)
        with self._lock:
            segments = list(self._segments)
            mem = self._mem_map
            if mem:
                # B×nb boxed dict lookups under the lock — fine at the
                # current cut cadence (memtable ≤ cut_postings); if the
                # memtable probe ever dominates a profile, mirror the
                # segment path: sorted parallel arrays + searchsorted
                mem_docs = np.fromiter(
                    (mem.get(k, -1) for k in flat.tolist()), np.int64, flat.size
                )
                hit = mem_docs >= 0
                best[hit] = mem_docs[hit]
        for seg in segments:
            try:
                rows, docs = seg.probe(flat)
            except SegmentCorruption as e:
                # bit rot surfaced on the probe path: quarantine instead
                # of serving an answer derived from the corrupt block (a
                # replica/scrub-repair restores the postings; a silently
                # wrong attribution would be forever)
                self.corrupt_segments += 1
                self._quarantine_live_segment(seg, e.detail)
                continue
            if rows.size:
                np.minimum.at(best, rows, docs.astype(np.int64))
        with self._lock:
            handed = list(self._handed_off)
        if handed:
            # a handed-off key must probe as absent HERE even though its
            # postings are still physically resident — the new owner
            # answers for it
            best[range_mask(flat, handed)] = np.iinfo(np.int64).max
        best = best.reshape(B, -1).min(axis=1)
        out = np.where(best == np.iinfo(np.int64).max, NO_DOC, best)
        self.probe_rows += B
        self.probe_hits += int((out >= 0).sum())
        return out

    def check_and_add_batch(
        self, keys: np.ndarray, doc_ids: np.ndarray
    ) -> np.ndarray:
        """Stream step: per-row attribution (``int64[B]``, -1 = fresh),
        then insert the fresh rows' postings under their given doc ids.

        Cross-run membership via the index; intra-batch via true key
        equality against earlier KEPT rows of the batch (first-seen wins)
        — kept rows only, so every attribution references a doc id that
        is actually posted (and docmap-resolvable); a dup row's id is
        never posted and must never be an attribution target.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.ndim == 1:
            keys = keys[:, None]
        doc_ids = np.ascontiguousarray(doc_ids, dtype=np.uint64).ravel()
        B, nb = keys.shape
        if B != doc_ids.size:
            raise ValueError(f"{B} key rows vs {doc_ids.size} doc ids")
        attr = resolve_intra_batch(
            keys, doc_ids, np.asarray(self.probe_batch(keys))
        )
        fresh = attr < 0
        if fresh.any():
            self.insert_batch(
                keys[fresh].ravel(), np.repeat(doc_ids[fresh], nb)
            )
        return attr

    # -- lifecycle: cut / compact / checkpoint / close ------------------------

    def cut_segment(self) -> bool:
        """Freeze the memtable into an immutable segment and rotate the WAL.

        Commit point: the manifest swap.  A crash before it leaves the old
        manifest + old WAL (the cut simply re-happens after reopen; the
        written segment — and the pre-opened next WAL generation — are
        orphans and are swept); a crash after it leaves the new manifest
        naming the new, already-created WAL generation, whose replay is
        empty; the postings live in the committed segment.  Either way:
        zero lost, zero duplicated.
        """
        self._check_writable()
        # The whole cut (sort, Bloom build, fsync'd write) holds the index
        # lock: correct but probe-blocking for its duration.  The
        # single-writer backends probe and insert from one thread, so
        # nothing stalls today; a multi-threaded prober would want the
        # compaction treatment (freeze the memtable, build outside the
        # lock, lock only for the manifest swap).
        with self._lock:
            if self._mem_count == 0:
                return False
            keys = np.concatenate(self._mem_keys)
            docs = np.concatenate(self._mem_docs)
            self._seg_seq += 1
            name = _seg_name(self._seg_seq)
            path = os.path.join(self.dir, name)
            digest = write_segment(path, keys, docs, seed=self._seg_seq, fs=self._fs)
            old_wal = self._wal
            old_wal_path = old_wal.path
            self._wal_seq += 1
            seg = Segment(path, fs=self._fs)
            self._segments.append(seg)
            self._digests[name] = digest
            try:
                # the new WAL generation opens BEFORE the commit: if the
                # manifest swap then commits, no fallible step remains —
                # appending to the superseded generation after a committed
                # rotation would be silently swept as an orphan on reopen
                new_wal = WriteAheadLog(
                    os.path.join(self.dir, _wal_name(self._wal_seq)),
                    fs=self._fs,
                )
                try:
                    self._write_manifest()  # ← the commit point
                except BaseException:
                    new_wal.close()
                    try:
                        self._fs.remove(new_wal.path)
                    except OSError:
                        pass
                    raise
            except BaseException:
                self._segments.pop()
                self._digests.pop(name, None)
                self._seg_seq -= 1
                self._wal_seq -= 1
                raise
            self._mem_keys, self._mem_docs = [], []
            self._mem_count = 0
            self._mem_map = {}
            self._wal = new_wal
            old_wal.close()
            try:
                self._fs.remove(old_wal_path)
            except OSError:
                pass  # superseded generation; swept on next open anyway
            self.segment_cuts += 1
            n_seg = len(self._segments)
        if self.compact_segments and n_seg >= self.compact_segments:
            if self.compact_inline:
                self.compact()
            else:
                self._compactor = threading.Thread(
                    target=self.compact, daemon=True,
                    name=f"astpu-index-compact-{os.path.basename(self.dir)}",
                )
                self._compactor.start()
        return True

    def compact(self) -> bool:
        """Merge every live segment into one, tombstoning superseded
        postings (every posting for a key except its minimum doc id).

        The heavy merge runs outside the index lock against immutable
        files; the swap — manifest first, then the in-memory list — is
        atomic under the lock.  Segments cut concurrently with the merge
        are preserved (they are newer than the snapshot by construction).
        A crash during the manifest swap leaves the old manifest → old
        segment set, merged file swept as an orphan on reopen.
        """
        self._check_writable()
        if not self._compact_busy.acquire(blocking=False):
            return False  # a compaction is already running
        try:
            with self._lock:
                snapshot = list(self._segments)
                if len(snapshot) < 2:
                    return False
                self._seg_seq += 1
                name = _seg_name(self._seg_seq)
            pairs = [s.arrays() for s in snapshot]  # one materialisation each
            keys = np.concatenate([k for k, _d in pairs])
            docs = np.concatenate([d for _k, d in pairs])
            del pairs
            order = np.lexsort((docs, keys))
            keys, docs = keys[order], docs[order]
            first = np.empty(keys.size, bool)
            if keys.size:
                first[0] = True
                first[1:] = keys[1:] != keys[:-1]
            tombstoned = int(keys.size - first.sum())
            keys, docs = keys[first], docs[first]
            path = os.path.join(self.dir, name)
            digest = write_segment(path, keys, docs, seed=self._seg_seq, fs=self._fs)
            merged = Segment(path, fs=self._fs)
            old_names = {os.path.basename(s.path) for s in snapshot}
            with self._lock:
                fresh = [
                    s for s in self._segments
                    if os.path.basename(s.path) not in old_names
                ]
                self._segments = [merged] + fresh
                self._digests[name] = digest
                try:
                    self._write_manifest()  # ← the commit point
                except BaseException:
                    self._segments = snapshot + fresh
                    self._digests.pop(name, None)
                    raise
                for old in old_names:
                    self._digests.pop(old, None)
            # old segment files: dropped refs keep any racing probe alive
            # (POSIX unlink semantics); never Segment.close()d here
            for s in snapshot:
                try:
                    self._fs.remove(s.path)
                except OSError:
                    pass
            self.tombstoned += tombstoned
            self.compactions += 1
            return True
        finally:
            self._compact_busy.release()

    def checkpoint(self) -> None:
        """Durability point at the configured cadence: fsync the WAL, and
        cut a segment if the memtable crossed the cadence threshold."""
        self._check_writable()
        self._age_semantic_cache()
        with self._lock:
            self._wal.sync()
            due = self._mem_count >= self.cut_postings
        if due:
            self.cut_segment()

    def close(self) -> None:
        # a compaction on its thread finishes first: it swaps the manifest
        # and removes the files it merged, so the directory is settled
        # before anyone reopens it
        compactor = self._compactor
        if compactor is not None and compactor is not threading.current_thread():
            compactor.join()
        with self._lock:
            # terminal close (unlike compaction's swap, where racing
            # probes keep dropped segments alive): release the memmaps so
            # a close/reopen-heavy process never accumulates handles
            for s in self._segments:
                s.close()
            self._segments = []
            if self._wal is None:
                return
            try:
                self._wal.sync()
            except OSError:
                pass
            self._wal.close()

    def wipe(self) -> int:
        """Drop every posting — segments, memtable, WAL — in one committed
        step; returns the physical posting count dropped.

        The canary-space expiry primitive: a probe round's synthetic
        postings must vanish completely between rounds, but the doc-id
        high-water mark survives (``next_doc_id`` is monotone forever —
        reissuing an id would silently re-point any surviving external
        attribution, the :meth:`allocate_doc_ids` contract).

        Crash-safe the same way a cut is: the new (empty) WAL generation
        opens first, the manifest swap naming zero segments + the new
        generation is the commit point, and only then are the superseded
        files deleted — a crash before the commit reopens the old state
        intact, one after it sweeps the leftovers as orphans.  The docmap
        sidecar is dropped too (best-effort, like its writes): wiped
        postings must not leave attribution ghosts for explain queries.
        """
        self._check_writable()
        with self._lock:
            n = sum(s.count for s in self._segments) + self._mem_count
            old_segments = list(self._segments)
            old_digests = dict(self._digests)
            old_wal = self._wal
            old_wal_path = old_wal.path
            self._segments = []
            self._digests = {}
            self._wal_seq += 1
            try:
                new_wal = WriteAheadLog(
                    os.path.join(self.dir, _wal_name(self._wal_seq)),
                    fs=self._fs,
                )
                try:
                    self._write_manifest()  # ← the commit point
                except BaseException:
                    new_wal.close()
                    try:
                        self._fs.remove(new_wal.path)
                    except OSError:
                        pass
                    raise
            except BaseException:
                self._segments = old_segments
                self._digests = old_digests
                self._wal_seq -= 1
                raise
            self._mem_keys, self._mem_docs = [], []
            self._mem_count = 0
            self._mem_map = {}
            self._semantic_cache = None
            self._wal = new_wal
            old_wal.close()
            try:
                self._fs.remove(old_wal_path)
            except OSError:
                pass
            for s in old_segments:
                s.close()
                try:
                    self._fs.remove(s.path)
                except OSError:
                    pass
            docmap = os.path.join(self.dir, DOCMAP)
            try:
                if self._fs.exists(docmap):
                    self._fs.remove(docmap)
            except OSError:
                pass
            return n
