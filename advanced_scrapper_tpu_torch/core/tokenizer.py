"""Byte tokenizer: ragged UTF-8 text → fixed-shape ``uint8[rows, width]``.

A copy of the reference's ``core/tokenizer.py`` (pure-Python branch):
power-of-two width buckets keep the set of tile shapes small, and texts
longer than a block split into blocks overlapping by ``k-1`` bytes, so
the shingle set over a text's blocks equals the text's own.  Padding is
0x00 and never counts: validity comes from the lengths.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

MIN_BUCKET = 64


def bucket_len(n: int, min_bucket: int = MIN_BUCKET, max_bucket: int | None = None) -> int:
    """Round ``n`` up to a power-of-two bucket (≥ min_bucket)."""
    b = min_bucket
    while b < n:
        b <<= 1
    if max_bucket is not None:
        b = min(b, max_bucket)
    return b


def bucket_widths(
    lens: np.ndarray, min_bucket: int = MIN_BUCKET, max_bucket: int | None = None
) -> np.ndarray:
    """Vectorised :func:`bucket_len` over an int array.  ``frexp`` is exact
    for every integer below 2⁵³, so powers of two land in their own bucket."""
    v = np.maximum(np.asarray(lens, dtype=np.int64), 1)
    m, e = np.frexp(v.astype(np.float64))
    # v = m·2^e with m ∈ [0.5, 1): exact power of two ⇔ m == 0.5
    b = np.ldexp(1.0, e - (m == 0.5)).astype(np.int64)
    b = np.maximum(b, min_bucket)
    if max_bucket is not None:
        b = np.minimum(b, max_bucket)
    return b


def tile_rows_options(bs: int, min_rows: int) -> list[int]:
    """Every row count the greedy power-of-two tile chunker can emit for a
    full-tile size ``bs``: the full tile plus the descending power-of-two
    tail chunks (≥ ``min_rows``; the last one zero-pads)."""
    rows_set = {bs}
    rows = min_rows
    while rows < bs:
        rows_set.add(rows)
        rows *= 2
    return sorted(rows_set)


def to_bytes(text: str | bytes) -> bytes:
    if isinstance(text, bytes):
        return text
    return text.encode("utf-8", errors="replace")


def encode_batch(
    texts: Sequence[str | bytes],
    block_len: int | None = None,
    *,
    min_bucket: int = MIN_BUCKET,
) -> tuple[np.ndarray, np.ndarray]:
    """``(tokens uint8[B, L], lengths int32[B])`` of a batch of texts.
    ``block_len`` None: ``L`` is the bucket of the longest text, so nothing
    is cut; a text longer than a given ``block_len`` is cut to it."""
    raw = [to_bytes(t) for t in texts]
    longest = max((len(r) for r in raw), default=1)
    L = block_len if block_len is not None else bucket_len(max(longest, 1), min_bucket)
    tokens = np.zeros((len(raw), L), dtype=np.uint8)
    lengths = np.zeros((len(raw),), dtype=np.int32)
    for i, r in enumerate(raw):
        n = min(len(r), L)
        tokens[i, :n] = np.frombuffer(r[:n], dtype=np.uint8)
        lengths[i] = n
    return tokens, lengths


def encode_blocks(
    texts: Sequence[str | bytes],
    block_len: int,
    *,
    overlap: int = 4,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode texts into overlapping fixed-size blocks.

    Returns ``(tokens uint8[N, block_len], lengths int32[N], owner int32[N])``
    where ``owner[j]`` indexes ``texts``.  Blocks overlap by ``overlap``
    bytes (``k-1`` for k-shingles).  An empty text takes one block holding
    a single zero byte (length 1), as in the reference.  This is the
    per-text loop kept as the behavioural reference;
    ``cpu.hostbatch.encode_blocks_ranges`` is the vectorised encoder the
    engine runs.
    """
    if block_len <= overlap:
        raise ValueError(f"block_len {block_len} must exceed overlap {overlap}")
    stride = block_len - overlap
    tok_rows: list[np.ndarray] = []
    lens: list[int] = []
    owners: list[int] = []
    for i, r in enumerate(to_bytes(t) for t in texts):
        if not r:
            r = b"\x00"
        pos = 0
        while True:
            chunk = r[pos : pos + block_len]
            row = np.zeros((block_len,), dtype=np.uint8)
            row[: len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
            tok_rows.append(row)
            lens.append(len(chunk))
            owners.append(i)
            if pos + block_len >= len(r):
                break
            pos += stride
    if not tok_rows:
        return (
            np.zeros((0, block_len), np.uint8),
            np.zeros((0,), np.int32),
            np.zeros((0,), np.int32),
        )
    return (
        np.stack(tok_rows),
        np.asarray(lens, dtype=np.int32),
        np.asarray(owners, dtype=np.int32),
    )
