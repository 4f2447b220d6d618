"""Reference implementation of rapidfuzz's ``fuzz.ratio`` / ``fuzz.partial_ratio``.

A copy of the JAX package's ``cpu/fuzz.py`` (the port imports nothing of
it); ``tests/test_torch_matcher.py`` holds the two equal.

``match_keywords.py:175-176`` gates the fuzzy entity-match path on
``rapidfuzz.fuzz.partial_ratio(text, name) > 95``.  This module implements
the same semantics dependency-free (the production deployment cannot assume
rapidfuzz), and is CI-fuzzed for exact score parity against the *installed*
rapidfuzz 3.x (``tests/test_rapidfuzz_parity.py``):

- ``ratio(s1, s2)``: normalised indel similarity,
  ``100 * (1 - dist / (len1 + len2))`` where ``dist`` is the
  insertion/deletion-only edit distance ``len1 + len2 - 2*LCS``.
- ``partial_ratio(s1, s2)``: max ``ratio`` of the shorter string against
  the sliding windows of its length across the longer, including the
  partial windows overhanging either end.  Two rapidfuzz-3.x rules beyond
  the naive slide (both verified against rapidfuzz 3.14.5 and its shipped
  ``fuzz_py.py``):
  * an empty needle scores **0.0** against non-empty text (only
    empty-vs-empty is 100.0) — ``fuzz_py.partial_ratio_alignment:314``;
  * **equal-length** inputs are scanned in BOTH directions (substrings of
    each side against the other) and the max taken —
    ``fuzz_py.partial_ratio_alignment:327-332``.  This is where naive
    sliding diverges by 1-7 points.

This pure-Python version is the oracle for tests and small inputs; the C++
twin (bit-parallel Hyyrö LCS, ``native/fastmatch.cpp``) is the production
verifier behind the device q-gram screen.
"""

from __future__ import annotations


def _lcs_len(a: str, b: str) -> int:
    """Classic O(|a|·|b|) LCS-length DP (row-rolling)."""
    if not a or not b:
        return 0
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for ca in a:
        cur = [0] * (len(b) + 1)
        for j, cb in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if ca == cb else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def indel_distance(s1: str, s2: str) -> int:
    return len(s1) + len(s2) - 2 * _lcs_len(s1, s2)


def ratio(s1: str, s2: str) -> float:
    total = len(s1) + len(s2)
    if total == 0:
        return 100.0
    return 100.0 * (1.0 - indel_distance(s1, s2) / total)


def _scan_windows(needle: str, haystack: str) -> float:
    """Max ratio of ``needle`` vs the length-|needle| sliding windows of
    ``haystack`` (clipped at both edges)."""
    m, n = len(needle), len(haystack)
    best = 0.0
    for start in range(-(m - 1), n):
        lo, hi = max(0, start), min(n, start + m)
        if hi <= lo:
            continue
        sc = ratio(needle, haystack[lo:hi])
        if sc > best:
            best = sc
            if best >= 100.0:
                break
    return best


def partial_ratio(s1: str, s2: str) -> float:
    if not s1 and not s2:
        return 100.0
    shorter, longer = (s1, s2) if len(s1) <= len(s2) else (s2, s1)
    m, n = len(shorter), len(longer)
    if m == 0:
        return 0.0  # empty needle vs non-empty text (rapidfuzz 3.x)
    best = _scan_windows(shorter, longer)
    if best < 100.0 and m == n:
        # equal lengths: rapidfuzz scans both orientations and takes the max
        best = max(best, _scan_windows(longer, shorter))
    return best

