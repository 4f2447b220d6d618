"""Vectorised blockwise encoding of byte ranges (numpy only).

The reference cuts ranges with a C++ routine (``hb_encode_ranges`` in
``advanced_scrapper_tpu/native/hostbatch.cpp``); this is the same
function in numpy, with no Python loop over rows: every block's start is
computed at once and the bytes are gathered through a sliding-window view
of the blob.  A native loader for the port is a later slice.
"""

from __future__ import annotations

import numpy as np


def block_counts(lens: np.ndarray, block_len: int, overlap: int) -> np.ndarray:
    """Vectorised blocks-per-doc for the blockwise split (smallest m with
    ``(m-1)*stride + block_len >= len``; empty docs still take one block)."""
    stride = block_len - overlap
    return np.where(
        lens > block_len, (lens - block_len + stride - 1) // stride + 1, 1
    )


def encode_blocks_ranges(
    blob: bytes,
    starts: np.ndarray,
    lens: np.ndarray,
    counts: np.ndarray,
    block_len: int,
    overlap: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode the ``(start, len)`` byte ranges of ``blob`` blockwise.

    ``counts`` is :func:`block_counts` over ``lens``.  Returns ``(tokens
    uint8[total, block_len], lengths int32[total], owners int32[total])``
    with owners indexing the range arrays — byte-for-byte what
    ``core.tokenizer.encode_blocks`` gives for the ranges' bytes (an empty
    range takes one block of length 1).

    The gather reads ``block_len`` bytes from every block start; a caller
    that pads ``blob`` with ``block_len`` zero bytes spares this function
    a copy of the blob to make the last window fit.
    """
    if block_len <= overlap:
        raise ValueError(f"block_len {block_len} must exceed overlap {overlap}")
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if (lens < 0).any() or (starts < 0).any():
        raise ValueError("range starts and lengths must be non-negative")
    stride = block_len - overlap
    total = int(counts.sum())
    owners = np.repeat(np.arange(len(starts), dtype=np.int32), counts)
    first = np.cumsum(counts) - counts  # index of each range's first block
    i = np.arange(total, dtype=np.int64) - np.repeat(first, counts)
    blk_start = starts[owners] + i * stride
    blk_len = np.clip(lens[owners] - i * stride, 0, block_len)
    if total and int((starts + lens).max()) > len(blob):
        raise ValueError("a range runs past the end of the blob")
    data = np.frombuffer(blob, dtype=np.uint8)
    if total and int(blk_start.max()) + block_len > data.size:
        data = np.concatenate([data, np.zeros((block_len,), np.uint8)])
    windows = np.lib.stride_tricks.sliding_window_view(data, block_len)
    tokens = windows[blk_start] if total else np.zeros((0, block_len), np.uint8)
    # a window runs on into the next range's bytes: zero the short rows' tails
    short = np.flatnonzero(blk_len < block_len)
    if short.size:
        keep = np.arange(block_len)[None, :] < blk_len[short, None]
        tokens[short] *= keep.astype(np.uint8)
    out_lens = np.where(lens[owners] == 0, 1, blk_len).astype(np.int32)
    return tokens, out_lens, owners
