"""The key-space helpers the persistent index calls.

The port's copies of the reference's ``index/repair.py:semantic_min``,
``mix64``, ``range_mask``, ``interval_add`` and ``interval_sub``, as they
are: the store collapses raw postings to its semantic state (sorted unique
keys, each with its minimum doc id), drops the ring ranges it has handed
off (``mix64`` positions in ``[lo, hi)`` intervals, kept canonical by
``interval_add``/``interval_sub``), and either package reopens a manifest
that names such ranges.  The bucket digests of the anti-entropy plane
(``bucket_digests``, ``bucket_range``) serve the index fleet and come with
it (ROADMAP item 9c).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "KEY_SPACE_END",
    "interval_add",
    "interval_sub",
    "mix64",
    "range_mask",
    "semantic_min",
]

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
