"""Host-side cutting of texts, vectorised in numpy (no loop over rows).

- :func:`segment_ranges` and :func:`chunk_ranges` describe the engine's
  main path: articles are runs of a flat text, cut into segments of at
  most ``S`` shingles that the kernel reads where they lie, and grouped
  into chunks of whole articles up to a byte budget.
- :func:`encode_blocks_ranges` is the reference's padded blockwise encoder
  (``hb_encode_ranges`` in ``advanced_scrapper_tpu/native/hostbatch.cpp``)
  in numpy: every block's start is computed at once and the bytes are
  gathered through a sliding-window view of the blob.  It feeds the tile
  path (``NearDupEngine._host_tiles``).
- :func:`exact_keep_first_native` is ``ExactDedup``'s blob tier: the
  items joined into one blob with an offset table, first-seen membership
  decided by ``hb_exact_keep_first`` (``native/hostbatch.cpp``, built by
  ``cpu/native.py``).
"""

from __future__ import annotations

import ctypes
import threading

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


def segment_ranges(
    doc_off: np.ndarray, doc_len: np.ndarray, owner: np.ndarray, k: int, S: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cut articles (byte runs ``[doc_off, doc_off + doc_len)`` of a text)
    into segments of at most ``S`` k-shingles: ``(seg_start int64,
    seg_shingles int32, seg_owner int32)``.

    An article with ``n = max(len - k + 1, 0)`` shingles gets ``ceil(n /
    S)`` segments; segment ``j`` starts at byte ``j * S`` of the article
    and reads its shingles' ``k - 1`` trailing bytes too, so consecutive
    segments overlap by ``k - 1`` bytes and every shingle lies in exactly
    one of them.  An article with no shingle gets no segment.
    """
    if S < 1 or k < 1:
        raise ValueError(f"segment size {S} and shingle width {k} must be >= 1")
    doc_off = np.asarray(doc_off, np.int64)
    n_valid = np.maximum(np.asarray(doc_len, np.int64) - (k - 1), 0)
    counts = -(-n_valid // S)
    doc = np.repeat(np.arange(len(n_valid)), counts)
    first = np.cumsum(counts) - counts
    j = np.arange(len(doc), dtype=np.int64) - first[doc]
    seg_start = doc_off[doc] + j * S
    seg_shingles = np.minimum(n_valid[doc] - j * S, S).astype(np.int32)
    seg_owner = np.asarray(owner)[doc].astype(np.int32)
    return seg_start, seg_shingles, seg_owner


def chunk_ranges(doc_len: np.ndarray, budget: int) -> list[tuple[int, int]]:
    """Cut articles, in order, into chunks ``[lo, hi)`` of whole articles
    holding at most ``budget`` bytes; an article longer than the budget is
    a chunk of its own.  Loops over chunks, not articles."""
    if budget < 1:
        raise ValueError(f"chunk budget {budget} must be >= 1")
    ends = np.cumsum(np.asarray(doc_len, np.int64))
    n = len(ends)
    chunks = []
    lo = 0
    while lo < n:
        before = int(ends[lo - 1]) if lo else 0
        hi = max(int(np.searchsorted(ends, before + budget, side="right")), lo + 1)
        chunks.append((lo, hi))
        lo = hi
    return chunks


_exact_lock = threading.Lock()
_exact_lib: ctypes.CDLL | None = None


def _exact_load() -> ctypes.CDLL:
    global _exact_lib
    if _exact_lib is not None:
        return _exact_lib
    from advanced_scrapper_tpu_torch.cpu import native

    with _exact_lock:
        if _exact_lib is None:
            lib = ctypes.CDLL(str(native.build(native.PACKAGE_DIR / "native" / "hostbatch.cpp")))
            lib.hb_exact_keep_first.restype = ctypes.c_long
            lib.hb_exact_keep_first.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ]
            _exact_lib = lib
    return _exact_lib


def exact_keep_first_native(items) -> np.ndarray | None:
    """``uint8[n]`` first-seen keep mask over ``items`` by the native hash
    table (every hash-equal probe confirmed by ``memcmp``), or ``None``
    for mixed str/bytes items, which have no lossless single join.

    Strings are joined once and encoded with ``surrogatepass``, injective
    on every str, so byte equality is string equality; byte lengths come
    from the character lengths when the blob is ASCII, else from one
    encode per item."""
    lib = _exact_load()
    n = len(items)
    if n == 0:
        return np.zeros((0,), np.uint8)
    try:
        blob_s = "".join(items)
    except TypeError:
        try:
            blob = b"".join(items)
        except TypeError:
            return None  # mixed str/bytes
        lens = np.fromiter(map(len, items), np.int64, count=n)
    else:
        if blob_s.isascii():
            blob = blob_s.encode("utf-8")
            lens = np.fromiter(map(len, items), np.int64, count=n)
        else:
            raw = [s.encode("utf-8", "surrogatepass") for s in items]
            blob = b"".join(raw)
            lens = np.fromiter(map(len, raw), np.int64, count=n)
    offsets = np.zeros((n + 1,), dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    keep = np.zeros((n,), dtype=np.uint8)
    rc = lib.hb_exact_keep_first(blob, offsets.ctypes.data, n, keep.ctypes.data)
    if rc < 0:
        return None  # allocation failure: the caller's next tier serves it
    return keep
