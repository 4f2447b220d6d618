"""Exact shingle-set Jaccard: the port's copy of the reference oracle's
``shingle_set`` and ``jaccard`` (``cpu/oracle.py``), the definition the
rerank tier's margin re-settle and the one-shot exact-verify stage hold
borderline pairs to.  Utf-8 with ``errors="replace"``, texts shorter than
k have no shingle, and two empty sets have Jaccard 1.
"""

from __future__ import annotations


def shingle_set(text: str | bytes, k: int) -> set[bytes]:
    raw = text.encode("utf-8", errors="replace") if isinstance(text, str) else text
    if len(raw) < k:
        return set()
    return {raw[i : i + k] for i in range(len(raw) - k + 1)}


def jaccard(a: set, b: set) -> float:
    if not a and not b:
        return 1.0
    if not a or not b:
        return 0.0
    return len(a & b) / len(a | b)
