"""Immutable sorted segment files with per-segment Bloom filters.

The port's copy of the reference's ``index/segment.py``, unchanged below
this paragraph but for its imports: both packages write the same bytes
from the same postings and read each other's v1 and v2 files.  Module
names below are the reference's.

A segment is one generation of postings cut from the WAL: keys sorted
ascending (ties broken by doc id), written ONCE through
``storage.fsio.atomic_write`` — so a segment on disk is whole-or-absent by
construction, never torn — and never modified again.  Readers keep only the
per-segment Bloom filter (and a 64-byte header) resident; the sorted key and
doc arrays are ``np.memmap``'d, so probing an N-posting history costs RAM
proportional to the *Bloom* sizing (~10 bits/posting at the 1% default),
not to the postings themselves — the LSHBloom memory contract, with
attribution kept because the postings still exist on disk.

Probe path per batch: Bloom membership first (a negative — the common case
for fresh content — never touches the posting arrays), then a vectorised
``searchsorted`` equal-range scan for the surviving keys.  A Bloom positive
that finds no posting is an *observed* false positive and is counted, so
``/status`` shows the live observed-FP ratio next to the predicted one.

**Integrity (format v2).**  A memmap'd body that lives for months is
exposed to silent bit rot: the OS pages bytes straight off disk with no
checksum between the medium and the probe answer.  v2 therefore carries a
per-block CRC32 table over all three body planes (Bloom words, keys,
docs), block-aligned PER PLANE so verification never crosses a memmap
boundary:

- the Bloom plane is verified **eagerly at open** (it is fully read into
  RAM then anyway);
- key/doc blocks are verified **lazily on first probe touch** (the
  equal-range rows a probe actually reads), each block at most once per
  open — the steady-state probe cost is unchanged;
- :meth:`Segment.verify_all` verifies **every** block plus the
  whole-file digest — the scrub / fsck path.

A failed check raises :class:`SegmentCorruption`; the store quarantines
the segment (the ``.quarantine`` sidecar convention) instead of serving
poison.  v1 segments (no CRC table) remain transparently readable —
lazy/eager verification simply has nothing to check beyond structure.

Layout v2 (little-endian)::

    magic 8s | version u32 | count u64 | bloom_bits u64 | bloom_hashes u32 |
    bloom_seed u32 | block_bytes u32 | table crc32 u32 | header crc32 u32 |
    pad → 64 B
    bloom words u64[bloom_bits/64]
    keys u64[count]          (sorted)
    docs u64[count]          (parallel to keys)
    crc table u32[nb(bloom) + nb(keys) + nb(docs)]   (per-plane blocks)

v1 ends after the docs plane and carries no ``block_bytes``/table fields.
"""

from __future__ import annotations

import hashlib
import struct
import zlib

import numpy as np

from advanced_scrapper_tpu_torch.storage.fsio import atomic_write, default_fs
from advanced_scrapper_tpu_torch.utils.bloom import BloomBandIndex

__all__ = [
    "Segment",
    "SegmentCorruption",
    "write_segment",
    "bloom_for_count",
    "file_digest",
]

_MAGIC = b"ASTPUSEG"
VERSION = 2
_HEAD_V1 = struct.Struct("<8sIQQIII")    # magic, ver, count, bits, hashes, seed, crc
_HEAD_V2 = struct.Struct("<8sIQQIIIII")  # ... + block_bytes, table_crc, crc
_HEAD_PREFIX = struct.Struct("<8sI")     # magic, ver — shared by both
HEADER_LEN = 64
#: CRC block granularity: 64 KiB = 8192 postings per key/doc block — small
#: enough that a lazy probe-touch verify is microseconds, large enough
#: that the table is ~0.006% of the body
BLOCK_BYTES = 1 << 16

_DIGEST_CHUNK = 1 << 20


class SegmentCorruption(Exception):
    """A segment failed an integrity check (block CRC, header CRC, table
    CRC or whole-file digest).  The store's response is quarantine —
    never serving an answer derived from the corrupt bytes."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"segment {path}: {detail}")
        self.path = path
        self.detail = detail


def bloom_for_count(count: int, *, seed: int = 0, row_fp: float = 0.01) -> BloomBandIndex:
    """Per-segment filter sized for ``count`` keys at ~``row_fp`` — a
    single-band :class:`BloomBandIndex`, so the sizing/saturation math is
    the one already measured in ``tools/soak_bloom.py``."""
    return BloomBandIndex.for_capacity(
        max(1, count), num_bands=1, row_fp=row_fp, seed=seed
    )


def _n_blocks(nbytes: int, block: int) -> int:
    return (nbytes + block - 1) // block


def _plane_crcs(buf, block: int) -> np.ndarray:
    """``uint32[ceil(len/block)]`` CRC32 per block of one body plane."""
    mv = memoryview(buf)
    out = np.empty(_n_blocks(len(mv), block), np.uint32)
    for i in range(out.size):
        out[i] = zlib.crc32(mv[i * block : (i + 1) * block])
    return out


def file_digest(path: str, fs=None) -> str:
    """Whole-file blake2b-128 hex digest — the manifest-recorded identity
    of a segment (and of snapshot artifacts)."""
    fs = fs or default_fs()
    h = hashlib.blake2b(digest_size=16)
    with fs.open(path, "rb") as fh:
        while True:
            chunk = fh.read(_DIGEST_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _header_bytes_v2(
    count: int, bloom: BloomBandIndex, block: int, table_crc: int
) -> bytes:
    body = _HEAD_V2.pack(
        _MAGIC, VERSION, count, bloom.bits, bloom.num_hashes, bloom.seed,
        block, table_crc, 0,
    )
    crc = zlib.crc32(body)
    packed = _HEAD_V2.pack(
        _MAGIC, VERSION, count, bloom.bits, bloom.num_hashes, bloom.seed,
        block, table_crc, crc,
    )
    return packed + b"\0" * (HEADER_LEN - len(packed))


def _header_bytes_v1(count: int, bloom: BloomBandIndex) -> bytes:
    body = _HEAD_V1.pack(
        _MAGIC, 1, count, bloom.bits, bloom.num_hashes, bloom.seed, 0
    )
    crc = zlib.crc32(body)
    packed = _HEAD_V1.pack(
        _MAGIC, 1, count, bloom.bits, bloom.num_hashes, bloom.seed, crc
    )
    return packed + b"\0" * (HEADER_LEN - len(packed))


def write_segment(
    path: str,
    keys: np.ndarray,
    docs: np.ndarray,
    *,
    seed: int = 0,
    fs=None,
    version: int = VERSION,
    block_bytes: int = BLOCK_BYTES,
) -> str:
    """Sort + deduplicate the posting batch and atomically persist it;
    returns the whole-file digest (hex) for the caller's manifest.

    Duplicate ``(key, doc)`` pairs collapse to one; multiple docs per key
    survive (compaction tombstones all but the first-seen later).  The
    rename inside :func:`atomic_write` is the commit point — a crash at any
    earlier byte leaves no segment at ``path``.

    ``version=1`` writes the legacy CRC-less format — kept ONLY so the
    transparent-read compatibility tests can fabricate pre-v2 segments;
    production writers always emit v2.
    """
    if version not in (1, VERSION):
        raise ValueError(f"unknown segment version {version}")
    keys = np.ascontiguousarray(keys, dtype=np.uint64).ravel()
    docs = np.ascontiguousarray(docs, dtype=np.uint64).ravel()
    if keys.shape != docs.shape:
        raise ValueError(f"keys/docs length mismatch: {keys.shape} vs {docs.shape}")
    order = np.lexsort((docs, keys))
    keys, docs = keys[order], docs[order]
    if keys.size:
        fresh = np.empty(keys.size, bool)
        fresh[0] = True
        fresh[1:] = (keys[1:] != keys[:-1]) | (docs[1:] != docs[:-1])
        keys, docs = keys[fresh], docs[fresh]
    bloom = bloom_for_count(int(keys.size), seed=seed)
    if keys.size:
        bloom.add_batch(keys[:, None])

    bloom_b = bloom._words.tobytes()
    keys_b = keys.tobytes()
    docs_b = docs.tobytes()
    if version == 1:
        parts = [_header_bytes_v1(int(keys.size), bloom), bloom_b, keys_b, docs_b]
    else:
        table = np.concatenate(
            [
                _plane_crcs(bloom_b, block_bytes),
                _plane_crcs(keys_b, block_bytes),
                _plane_crcs(docs_b, block_bytes),
            ]
        )
        table_b = table.tobytes()
        parts = [
            _header_bytes_v2(
                int(keys.size), bloom, block_bytes, zlib.crc32(table_b)
            ),
            bloom_b, keys_b, docs_b, table_b,
        ]
    digest = hashlib.blake2b(digest_size=16)
    for p in parts:
        digest.update(p)

    def writer(fh):
        for p in parts:
            fh.write(p)

    atomic_write(path, writer, fs=fs)
    return digest.hexdigest()


class Segment:
    """Reader over one immutable segment file.

    Resident memory: header + Bloom words + (v2) the CRC table and two
    verified-block bitmasks.  ``keys``/``docs`` are memmaps — the OS pages
    postings in only for the (rare) Bloom-positive probes, and each
    touched block is CRC-verified once before its bytes influence an
    answer.
    """

    def __init__(self, path: str, fs=None):
        self.path = path
        fs = fs or default_fs()
        with fs.open(path, "rb") as fh:
            head = fh.read(HEADER_LEN)
            if len(head) < HEADER_LEN:
                raise ValueError(f"segment {path}: truncated header")
            magic, ver = _HEAD_PREFIX.unpack_from(head)
            if magic != _MAGIC or ver not in (1, VERSION):
                raise ValueError(f"segment {path}: bad magic/version")
            self.version = int(ver)
            if ver == 1:
                _m, _v, count, bits, hashes, seed, crc = _HEAD_V1.unpack_from(head)
                expect = zlib.crc32(
                    _HEAD_V1.pack(_MAGIC, 1, count, bits, hashes, seed, 0)
                )
                block, table_crc = 0, 0
            else:
                (_m, _v, count, bits, hashes, seed, block, table_crc,
                 crc) = _HEAD_V2.unpack_from(head)
                expect = zlib.crc32(
                    _HEAD_V2.pack(
                        _MAGIC, VERSION, count, bits, hashes, seed, block,
                        table_crc, 0,
                    )
                )
            if crc != expect:
                raise SegmentCorruption(path, "header checksum mismatch")
            bloom_bytes = fh.read(bits // 8)
            if len(bloom_bytes) != bits // 8:
                raise ValueError(f"segment {path}: truncated bloom plane")
            words = np.frombuffer(bloom_bytes, dtype=np.uint64)
            self.count = int(count)
            self.block_bytes = int(block)
            nb_bloom = _n_blocks(bits // 8, block) if block else 0
            nb_keys = _n_blocks(8 * self.count, block) if block else 0
            nb_docs = nb_keys
            expected = HEADER_LEN + bits // 8 + 16 * self.count
            if ver == VERSION:
                expected += 4 * (nb_bloom + nb_keys + nb_docs)
            actual = fs.size(path)
            if actual != expected:
                raise ValueError(
                    f"segment {path}: size {actual} != expected {expected}"
                )
            if ver == VERSION:
                fh.seek(HEADER_LEN + bits // 8 + 16 * self.count)
                table_b = fh.read(4 * (nb_bloom + nb_keys + nb_docs))
                if zlib.crc32(table_b) != table_crc:
                    raise SegmentCorruption(path, "CRC table checksum mismatch")
                table = np.frombuffer(table_b, np.uint32)
                self._crc_bloom = table[:nb_bloom]
                self._crc_keys = table[nb_bloom : nb_bloom + nb_keys]
                self._crc_docs = table[nb_bloom + nb_keys :]
                # the bloom plane is fully resident from here on: verify it
                # now, while we still hold the exact bytes that were read
                got = _plane_crcs(bloom_bytes, block)
                bad = np.flatnonzero(got != self._crc_bloom)
                if bad.size:
                    raise SegmentCorruption(
                        path, f"bloom plane CRC mismatch in block {int(bad[0])}"
                    )
            else:
                self._crc_keys = self._crc_docs = None
        self.bloom = BloomBandIndex(1, bits=int(bits), num_hashes=int(hashes), seed=int(seed))
        self.bloom.restore(words.reshape(1, -1).copy(), self.count, 64)
        keys_off = HEADER_LEN + bits // 8
        if self.count:
            self.keys = np.memmap(path, dtype=np.uint64, mode="r",
                                  offset=keys_off, shape=(self.count,))
            self.docs = np.memmap(path, dtype=np.uint64, mode="r",
                                  offset=keys_off + 8 * self.count,
                                  shape=(self.count,))
        else:
            self.keys = np.zeros((0,), np.uint64)
            self.docs = np.zeros((0,), np.uint64)
        # lazy verification state: block i verified ⇔ _ok_*[i].  Races are
        # benign (two probes re-verify the same immutable bytes), so no
        # lock — verification is idempotent and monotone.
        if self.version == VERSION and self.count:
            self._ok_keys = np.zeros(len(self._crc_keys), bool)
            self._ok_docs = np.zeros(len(self._crc_docs), bool)
        else:
            self._ok_keys = self._ok_docs = None
        # observed-FP accounting (scraped as a ratio by the store's gauges)
        self.bloom_hits = 0
        self.bloom_false = 0

    @property
    def resident_bytes(self) -> int:
        table = 0
        if self.version == VERSION and self._crc_keys is not None:
            table = 4 * (
                len(self._crc_bloom) + len(self._crc_keys) + len(self._crc_docs)
            )
        return self.bloom.memory_bytes + HEADER_LEN + table

    @property
    def file_bytes(self) -> int:
        base = HEADER_LEN + self.bloom.memory_bytes + 16 * self.count
        if self.version == VERSION:
            nb = _n_blocks(8 * self.count, self.block_bytes) if self.count else 0
            base += 4 * (
                _n_blocks(self.bloom.memory_bytes, self.block_bytes) + 2 * nb
            )
        return base

    # -- integrity ---------------------------------------------------------

    def _verify_blocks(self, plane: np.ndarray, crcs, ok, b0: int, b1: int):
        """Verify blocks ``[b0, b1)`` of one posting plane against the CRC
        table (skipping already-verified ones); raises on mismatch."""
        rows_per = self.block_bytes // 8
        for b in range(b0, b1):
            if ok[b]:
                continue
            lo = b * rows_per
            hi = min(self.count, lo + rows_per)
            got = zlib.crc32(np.ascontiguousarray(plane[lo:hi]).tobytes())
            if got != int(crcs[b]):
                raise SegmentCorruption(
                    self.path,
                    f"block CRC mismatch ({'keys' if crcs is self._crc_keys else 'docs'} "
                    f"block {b}, rows {lo}..{hi})",
                )
            ok[b] = True

    def _verify_rows(self, lo: int, hi: int) -> None:
        """Lazy probe-path check: CRC-verify the key and doc blocks holding
        rows ``[lo, hi)``, each block at most once per open."""
        if self._ok_keys is None or hi <= lo:
            return
        rows_per = self.block_bytes // 8
        b0, b1 = lo // rows_per, (max(lo, hi - 1) // rows_per) + 1
        self._verify_blocks(self.keys, self._crc_keys, self._ok_keys, b0, b1)
        self._verify_blocks(self.docs, self._crc_docs, self._ok_docs, b0, b1)

    def verify_all(self, fs=None) -> str:
        """Eagerly verify EVERY block of every plane (scrub / fsck path)
        and return the whole-file digest; raises :class:`SegmentCorruption`
        on the first mismatch.

        The bloom plane is re-read from DISK here (the resident copy was
        verified at open; scrub's job is the bytes as they are now)."""
        fs = fs or default_fs()
        if self.version == VERSION:
            with fs.open(self.path, "rb") as fh:
                fh.seek(HEADER_LEN)
                bloom_bytes = fh.read(self.bloom.memory_bytes)
            got = _plane_crcs(bloom_bytes, self.block_bytes)
            bad = np.flatnonzero(got != self._crc_bloom)
            if bad.size:
                raise SegmentCorruption(
                    self.path, f"bloom plane CRC mismatch in block {int(bad[0])}"
                )
            if self.count:
                # full sweep: force re-verification of every block (bit rot
                # can land AFTER a block was lazily verified)
                self._ok_keys[:] = False
                self._ok_docs[:] = False
                self._verify_blocks(
                    self.keys, self._crc_keys, self._ok_keys,
                    0, len(self._crc_keys),
                )
                self._verify_blocks(
                    self.docs, self._crc_docs, self._ok_docs,
                    0, len(self._crc_docs),
                )
        return file_digest(self.path, fs=fs)

    def probe(self, flat_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(query_rows, doc_ids)`` posting matches for ``uint64[n]`` keys.

        Bloom-negative keys never touch the posting memmaps; a key may
        match several postings (several doc ids), all are returned.  Every
        posting row consulted for an answer sits in a CRC-verified block
        (v2) — corruption raises :class:`SegmentCorruption` instead of
        flowing into an attribution.
        """
        flat_keys = np.asarray(flat_keys, dtype=np.uint64).ravel()
        if self.count == 0 or flat_keys.size == 0:
            e = np.zeros((0,), np.int64)
            return e, e.astype(np.uint64)
        maybe = self.bloom.contains_batch(flat_keys[:, None])
        rows = np.flatnonzero(maybe)
        if rows.size == 0:
            e = np.zeros((0,), np.int64)
            return e, e.astype(np.uint64)
        q = flat_keys[rows]
        lo = np.searchsorted(self.keys, q, side="left")
        hi = np.searchsorted(self.keys, q, side="right")
        n_match = hi - lo
        hit = n_match > 0
        self.bloom_hits += int(rows.size)
        self.bloom_false += int(rows.size - hit.sum())
        if self._ok_keys is not None:
            # a bloom-positive MISS is either an honest Bloom false
            # positive (~1%) or a key whose stored bytes rotted out of its
            # sort position — verify the blocks AROUND the landing point
            # so a flipped key raises here instead of silently reading as
            # "never posted".  Rows [lo-1, lo] suffice for a SINGLE
            # rotted row: binary search over a sorted array with one
            # out-of-place element converges adjacent to it (an inflated
            # row sends the search left until it closes AT the rot; a
            # deflated row sends it right until it closes just past it),
            # so the corrupt row is always in a verified block.  Multi-row
            # rot within one file is the scrub/digest pass's job.
            for l in lo[~hit].tolist():
                r0 = max(l - 1, 0)
                r1 = min(max(l, 0) + 1, self.count)
                self._verify_rows(r0, r1)
        if not hit.any():
            e = np.zeros((0,), np.int64)
            return e, e.astype(np.uint64)
        rows, lo, n_match = rows[hit], lo[hit], n_match[hit]
        for l, n in zip(lo.tolist(), n_match.tolist()):
            self._verify_rows(l, l + n)
        out_rows = np.repeat(rows, n_match)
        flat_ix = np.concatenate(
            [np.arange(l, l + n) for l, n in zip(lo.tolist(), n_match.tolist())]
        )
        return out_rows.astype(np.int64), np.asarray(self.docs[flat_ix])

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Materialised ``(keys, docs)`` copies — compaction/verification
        input, not a probe path."""
        return np.asarray(self.keys).copy(), np.asarray(self.docs).copy()

    def close(self) -> None:
        # memmaps release on GC; drop references eagerly so Windows-style
        # holders (and ChaosFs tests) can delete files after compaction
        self.keys = self.docs = None
