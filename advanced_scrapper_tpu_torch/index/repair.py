"""Anti-entropy primitives: key-space digests over the index's semantic state.

Replicas of one shard can silently diverge three ways: a node missed writes
while dark (gap ledger dropped past its cap), a scrub quarantined a
bit-rotted segment (postings deliberately withdrawn rather than served
corrupt), or an operator restored one node from an older snapshot.  The
repair plane needs to find the divergence WITHOUT streaming whole indexes
around — that is this module: a Merkle-style two-level digest over the
uint64 key space.

The digested representation is the **semantic state** — sorted unique keys
with the minimum doc id each attributes to (``PersistentIndex
.semantic_items``) — because that is the only thing probes can observe:
posting multiplicity and compaction timing differ between healthy replicas
by construction and must cancel out of the comparison.

Shape: the key space splits into ``2**bits`` buckets by the key's top bits
(keys are already hashes, so buckets are uniform); each bucket folds to a
64-bit XOR of a mixed ``(key, min-doc)`` hash plus a key count.  Two
replicas agree ⇔ every bucket's ``(digest, count)`` pair agrees; a
divergent bucket names a key RANGE small enough to stream (the
``fetch_range`` RPC, paged under the frame cap).  XOR-folding makes the
digest order-independent and incrementally recomputable, and a single
changed pair flips the bucket with probability 1 − 2⁻⁶⁴.

The port's copy of the reference's ``index/repair.py``, whole.  The store
calls ``semantic_min``, ``mix64``, ``range_mask``, ``interval_add`` and
``interval_sub`` (its semantic state and handed-off ring ranges); the
fleet's anti-entropy plane adds the bucket digests.  Pure numpy —
importable by both halves of the fleet (client ``index/fleet.py``, server
``index/remote.py``) and by offline tools.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "DEFAULT_BITS",
    "KEY_SPACE_END",
    "bucket_digests",
    "bucket_range",
    "interval_add",
    "interval_sub",
    "mix64",
    "range_mask",
    "semantic_min",
]

#: default digest resolution: 256 buckets ≈ 1/256th of a shard per
#: divergent-range transfer — coarse enough that a digest frame is tiny
#: (4 KiB), fine enough that healing one rotted segment never re-streams
#: the whole shard
DEFAULT_BITS = 8

#: exclusive end of the uint64 key space (2**64 — kept a Python int:
#: range arithmetic would overflow uint64)
KEY_SPACE_END = 1 << 64


def semantic_min(keys: np.ndarray, docs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Collapse raw postings to the semantic state: sorted unique keys +
    min doc id per key (what a probe answers with)."""
    keys = np.ascontiguousarray(keys, np.uint64).ravel()
    docs = np.ascontiguousarray(docs, np.uint64).ravel()
    if keys.size == 0:
        return keys, docs
    order = np.lexsort((docs, keys))
    keys, docs = keys[order], docs[order]
    first = np.empty(keys.size, bool)
    first[0] = True
    first[1:] = keys[1:] != keys[:-1]
    return keys[first], docs[first]


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — maps raw keys to their RING POSITION.  The
    consistent-hash ring (``fleet.ring_assign``) and the reshard migration
    ranges both live in this mixed space, so every module that slices the
    space per-owner (fleet, reshard, the server's mixed digest/fetch modes)
    must share the one definition."""
    x = np.ascontiguousarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x.copy()
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def range_mask(keys: np.ndarray, ranges) -> np.ndarray:
    """Boolean mask of ``keys`` whose RING POSITION (``mix64``) falls in
    any ``[lo, hi)`` of ``ranges`` (Python-int bounds; ``hi`` ≥
    ``KEY_SPACE_END`` means "to the end of the space")."""
    keys = np.ascontiguousarray(keys, np.uint64).ravel()
    mask = np.zeros(keys.size, bool)
    if not keys.size:
        return mask
    pos = mix64(keys)
    for lo, hi in ranges:
        m = pos >= np.uint64(lo)
        if int(hi) < KEY_SPACE_END:
            m &= pos < np.uint64(hi)
        mask |= m
    return mask


def _mix_pair(keys: np.ndarray, docs: np.ndarray) -> np.ndarray:
    """64-bit hash per (key, doc) pair — splitmix64 finalizer over an
    odd-multiplier combine, so equal multisets XOR to equal digests and a
    single differing pair flips the fold."""
    with np.errstate(over="ignore"):
        x = keys ^ (docs * np.uint64(0x9E3779B97F4A7C15))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def bucket_digests(
    keys: np.ndarray,
    docs: np.ndarray,
    bits: int = DEFAULT_BITS,
    positions: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """``(digests u64[2**bits], counts u64[2**bits])`` over a SEMANTIC
    ``(key → min doc)`` state (callers pass :func:`semantic_min` output —
    raw postings would make healthy replicas look divergent).

    ``positions`` buckets each pair by an alternate coordinate (same
    length as ``keys``) instead of the raw key — the reshard plane passes
    ``mix64(keys)`` so digests compare per RING RANGE; the fold itself
    still mixes the raw ``(key, doc)`` pair, so the two bucketings answer
    over the identical underlying state."""
    nb = 1 << int(bits)
    dig = np.zeros(nb, np.uint64)
    cnt = np.zeros(nb, np.uint64)
    keys = np.ascontiguousarray(keys, np.uint64).ravel()
    docs = np.ascontiguousarray(docs, np.uint64).ravel()
    if keys.size:
        coord = keys if positions is None else np.ascontiguousarray(
            positions, np.uint64
        ).ravel()
        b = (coord >> np.uint64(64 - int(bits))).astype(np.int64)
        np.bitwise_xor.at(dig, b, _mix_pair(keys, docs))
        np.add.at(cnt, b, np.uint64(1))
    return dig, cnt


def interval_add(ranges, lo: int, hi: int) -> list[tuple[int, int]]:
    """Add ``[lo, hi)`` to a list of disjoint sorted intervals, merging
    overlaps/adjacency; Python-int bounds (``hi`` may be 2**64).  The
    store's handed-off ledger rides this: retiring a range twice, or
    retiring two arcs that touch, must collapse to one interval so
    manifests stay canonical."""
    lo, hi = int(lo), int(hi)
    ivs = sorted([(int(a), int(b)) for a, b in ranges] + ([(lo, hi)] if hi > lo else []))
    out: list[tuple[int, int]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def interval_sub(ranges, lo: int, hi: int) -> list[tuple[int, int]]:
    """Subtract ``[lo, hi)`` from a list of disjoint intervals — how a
    node un-retires a range it is RE-acquiring (an N→M→N round trip hands
    an arc back to its original owner, whose handed-off ledger must stop
    dropping inserts for it)."""
    lo, hi = int(lo), int(hi)
    out: list[tuple[int, int]] = []
    for a, b in sorted((int(a), int(b)) for a, b in ranges):
        if b <= lo or a >= hi:
            out.append((a, b))
            continue
        if a < lo:
            out.append((a, lo))
        if b > hi:
            out.append((hi, b))
    return out


def bucket_range(bucket: int, bits: int = DEFAULT_BITS) -> tuple[int, int]:
    """``[lo, hi)`` uint64 key range owned by ``bucket`` (``hi`` may be
    ``KEY_SPACE_END`` — Python ints, since 2**64 overflows uint64)."""
    width = 1 << (64 - int(bits))
    lo = int(bucket) * width
    return lo, lo + width
