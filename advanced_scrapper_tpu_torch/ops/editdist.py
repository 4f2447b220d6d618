"""Myers bit-parallel semi-global edit distance: the matcher's alignment
bound, plain PyTorch versions and the dispatcher.

Counterpart of the reference's ``ops/editdist.py``.  For a pattern of
``m ≤ 32`` bytes, ``d`` is the least Levenshtein distance between the
pattern and any substring of a text tile; ``100·(1 − d/(2m))`` bounds
rapidfuzz's ``partial_ratio`` from above, so a pair with ``100·d ≥
2m·(100 − t)`` (float32, as the reference compares) can skip the host
scorer's text side.

The scan is blocked exactly as the reference's: tiles start at multiples
of ``block`` and read ``block + 31`` bytes, live for ``clip(len − start,
0, block + 31)`` steps; each tile starts from ``pv = ~0, mv = 0, score =
best = max(m, 1)``; the result is the min over tiles.  Dead tiles give
``m``, so the result does not depend on how wide the rows are padded.

PyTorch on the CPU has no ``uint32`` add, shift or min, so the plain
version carries the 32-bit lanes in ``int64`` masked to 32 bits.
Two forms, each with a CUDA kernel in ``csrc/editdist.cu`` (wrappers in
``ops/editdist_cuda.py``) for tensors on the card and a plain version for
tensors on the CPU:

- :func:`myers_bound` (the fused screen's bound, every refine pattern
  against every row, the reference's ``semiglobal_dist_shared``; kernel
  ``myers_bound``, plain :func:`myers_bound_plain`);
- :func:`semiglobal_dist` (one pattern per pair, the reference's
  ``semiglobal_dist``, launched by the legacy screen's refine and by
  :func:`prune_mask_tables`; kernel ``myers_pairs``, plain
  :func:`semiglobal_dist_plain`).  Its prune compare is the reference's
  float64 ``partial_ratio_bound(d, m) <= threshold``, on the host: it
  differs from the fused step's float32 compare at a few points (``m =
  10, d = 9, t = 55``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from advanced_scrapper_tpu_torch.ops.match import FLAG_REFINE_OK, check_rows
from advanced_scrapper_tpu_torch.ops.shingle import U32_MASK, u32_values

MAX_PATTERN = 32  # one 32-bit lane per pair
BLOCK = 512       # the fused screen step's tile (the reference's refine_block)

#: rows the plain bound holds in one batch of its [K, rows, tiles] state
PLAIN_ROWS = 64
#: pairs the plain per-pair distance holds in one batch of its [pairs, tiles] state
PLAIN_PAIRS = 4096


def build_pattern_masks(patterns: list[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pattern Myers match masks: ``(masks uint32[N, 256], lens
    int32[N], ok bool[N])``; ``ok`` is False for empty or >32-byte
    patterns (callers pass those through unpruned)."""
    n = len(patterns)
    masks = np.zeros((n, 256), dtype=np.uint32)
    lens = np.zeros((n,), dtype=np.int32)
    ok = np.zeros((n,), dtype=bool)
    for i, p in enumerate(patterns):
        m = len(p)
        if m == 0 or m > MAX_PATTERN:
            continue
        lens[i] = m
        ok[i] = True
        for j, byte in enumerate(p):
            masks[i, byte] |= np.uint32(1) << np.uint32(j)
    return masks, lens, ok


def partial_ratio_bound(dist: np.ndarray, plens: np.ndarray) -> np.ndarray:
    """``100·(1 − d/(2m))`` — the sound upper bound on partial_ratio."""
    m = np.maximum(np.asarray(plens, dtype=np.float64), 1.0)
    return 100.0 * (1.0 - np.asarray(dist, dtype=np.float64) / (2.0 * m))


def semiglobal_dist_shared_plain(
    masks: torch.Tensor,   # uint32/int32/int64[K, 256] pattern masks
    plens: torch.Tensor,   # int32[K] pattern lengths (1..32)
    text: torch.Tensor,    # uint8[B, L] text rows
    tlens: torch.Tensor,   # int32[B] text lengths
    *,
    block: int = BLOCK,
) -> torch.Tensor:
    """``int32[B, K]``: the reference's ``semiglobal_dist_shared``, every
    pattern against every row, in plain PyTorch (state ``[K, B, tiles]``;
    the steps stop after the longest live tile)."""
    B, L = text.shape
    K = masks.shape[0]
    dev = text.device
    O = MAX_PATTERN - 1
    nb = max(1, -(-L // block))
    if masks.dtype in (torch.uint32, torch.int32):
        masks = u32_values(masks)
    masks = masks.to(torch.int64)
    padded = F.pad(text, (0, nb * block + O - L))
    ext = torch.stack(
        [padded[:, s : s + block + O] for s in range(0, nb * block, block)], dim=1
    ).to(torch.int64)                                               # [B, nb, block+O]
    starts = torch.arange(nb, device=dev, dtype=torch.int64) * block
    eff = torch.clamp(tlens.to(torch.int64)[:, None] - starts[None, :], 0, block + O)
    p = torch.clamp_min(plens.to(torch.int64), 1)
    high = (torch.ones_like(p) << (p - 1))[:, None, None]          # [K, 1, 1]
    score = p[:, None, None].expand(K, B, nb).clone()
    best = score.clone()
    pv = torch.full((K, B, nb), U32_MASK, dtype=torch.int64, device=dev)
    mv = torch.zeros((K, B, nb), dtype=torch.int64, device=dev)
    steps = int(eff.max()) if eff.numel() else 0
    for j in range(steps):
        eq = masks[:, ext[:, :, j]]                                 # [K, B, nb]
        xv = eq | mv
        xh = ((((eq & pv) + pv) & U32_MASK) ^ pv) | eq
        ph = mv | (~(xh | pv) & U32_MASK)
        mh = pv & xh
        score2 = score + ((ph & high) != 0).to(torch.int64) - ((mh & high) != 0).to(torch.int64)
        # search variant: row 0 is free, so shift without OR-ing in bit 0
        ph = (ph << 1) & U32_MASK
        mh = (mh << 1) & U32_MASK
        pv2 = mh | (~(xv | ph) & U32_MASK)
        mv2 = ph & xv
        live = (j < eff)[None, :, :]
        pv = torch.where(live, pv2, pv)
        mv = torch.where(live, mv2, mv)
        score = torch.where(live, score2, score)
        best = torch.where(live, torch.minimum(best, score), best)
    return best.amin(dim=2).T.to(torch.int32)


def bound_pruned(d: torch.Tensor, plens: torch.Tensor, threshold: float) -> torch.Tensor:
    """``100·d ≥ (2·m)·(100 − t)`` in float32 (``d int32[R, K]``)."""
    dev = d.device
    t = torch.tensor(float(np.float32(threshold)), dtype=torch.float32, device=dev)
    return (d.to(torch.float32) * 100.0
            >= 2.0 * plens[None, :].to(torch.float32) * (100.0 - t))


def check_patterns(masks, plens, ok, cols, n_names: int) -> None:
    """Raise unless ``masks`` is ``uint32/int32[K, 256]``, ``plens int32[K]``
    in ``[0, 32]``, ``ok bool[K]`` and ``cols int64[K]`` distinct columns
    of a mask with ``n_names`` columns, all on one device."""
    K = masks.shape[0]
    if masks.dtype not in (torch.uint32, torch.int32) or masks.shape != (K, 256):
        raise TypeError(f"masks must be uint32[K, 256], got {masks.dtype} {tuple(masks.shape)}")
    for t, name, dt in ((plens, "plens", torch.int32), (ok, "ok", torch.bool),
                        (cols, "cols", torch.int64)):
        if t.dtype != dt or t.shape != (K,):
            raise TypeError(f"{name} must be {dt}[{K}], got {t.dtype} {tuple(t.shape)}")
        if t.device != masks.device:
            raise ValueError(f"{name} is on {t.device}, the masks on {masks.device}")
    if K:
        lo, hi = int(plens.min()), int(plens.max())
        if lo < 0 or hi > MAX_PATTERN:
            raise ValueError(f"pattern lengths must lie in [0, {MAX_PATTERN}], got {lo}..{hi}")
        c = cols.cpu()
        if int(c.min()) < 0 or int(c.max()) >= n_names or c.unique().numel() != K:
            raise ValueError(f"cols must be distinct columns in [0, {n_names})")


def myers_bound_plain(
    text: torch.Tensor,
    row_off: torch.Tensor,
    row_len: torch.Tensor,
    text_len: torch.Tensor,
    flags: torch.Tensor,
    masks: torch.Tensor,
    plens: torch.Tensor,
    ok: torch.Tensor,
    cols: torch.Tensor,
    threshold: float,
    mask: torch.Tensor,
    *,
    dist: torch.Tensor | None = None,
    rows_per_batch: int = PLAIN_ROWS,
) -> torch.Tensor:
    """The fused step's bound (reference ``make_screen_step``, ``:258-285``)
    over ragged rows, in plain PyTorch: the Myers distance of every
    pattern against each combined row (``row_len`` bytes at ``row_off``),
    then bit 1 OR-ed into ``mask uint8[R, N]`` at the pattern's column
    ``cols`` where ``ok``, ``text_len > m``, the row's
    :data:`FLAG_REFINE_OK` and the float32 compare all hold.  ``dist``,
    where given, receives ``int32[R, K]``.  Rows go ``rows_per_batch``
    at a time (the state is ``[K, rows, tiles]``).  Returns ``mask``."""
    check_rows(text, row_off, row_len, text_len, flags)
    check_patterns(masks, plens, ok, cols, mask.shape[1])
    R, K = row_off.numel(), masks.shape[0]
    if R == 0 or K == 0:
        return mask
    for r0 in range(0, R, rows_per_batch):
        sl = slice(r0, min(R, r0 + rows_per_batch))
        off, ln = row_off[sl], row_len[sl].to(torch.int64)
        width = max(1, int(ln.max()))
        idx = off[:, None] + torch.arange(width, device=text.device)[None, :]
        inside = torch.arange(width, device=text.device)[None, :] < ln[:, None]
        rows = torch.where(inside, text[idx.clamp(max=max(text.numel() - 1, 0))], 0)
        d = semiglobal_dist_shared_plain(masks, plens, rows.to(torch.uint8), row_len[sl])
        if dist is not None:
            dist[sl] = d
        prunable = (
            ok[None, :]
            & (text_len[sl][:, None] > plens[None, :])
            & ((flags[sl] & FLAG_REFINE_OK) != 0)[:, None]
            & bound_pruned(d, plens, threshold)
        )
        sub = mask[sl]  # a view: the indexed OR writes into mask
        sub[:, cols] |= prunable.to(torch.uint8) << 1
    return mask


def myers_bound(
    text: torch.Tensor,
    row_off: torch.Tensor,
    row_len: torch.Tensor,
    text_len: torch.Tensor,
    flags: torch.Tensor,
    masks: torch.Tensor,
    plens: torch.Tensor,
    ok: torch.Tensor,
    cols: torch.Tensor,
    threshold: float,
    mask: torch.Tensor,
) -> torch.Tensor:
    """OR the bound's bit 1 into ``mask`` in place: the CUDA kernel
    ``myers_bound`` for tensors on the card, :func:`myers_bound_plain` for
    tensors on the CPU.  Returns ``mask``."""
    if text.device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.editdist_cuda import myers_bound as kernel

        return kernel(text, row_off, row_len, text_len, flags, masks, plens, ok, cols,
                      threshold, mask)
    return myers_bound_plain(text, row_off, row_len, text_len, flags, masks, plens, ok,
                             cols, threshold, mask)


# -- one pattern per pair: the reference's semiglobal_dist ---------------------


def check_pairs(masks, plens, text, row_off, tlens, pair_text, pair_pat) -> None:
    """Raise unless ``masks`` is ``uint32/int32[K, 256]``, ``plens
    int32[K]``, ``text`` 1-D ``uint8``, ``row_off int64[T]``, ``tlens
    int32[T]`` and ``pair_text``/``pair_pat`` ``int32[P]``, all on one
    device.  Values are not read: a pair whose indices, text bounds or
    pattern length lie out of range gets the distance -1."""
    K = masks.shape[0] if masks.ndim == 2 else -1
    if masks.dtype not in (torch.uint32, torch.int32) or masks.shape != (K, 256):
        raise TypeError(f"masks must be uint32[K, 256], got {masks.dtype} {tuple(masks.shape)}")
    if text.dtype != torch.uint8 or text.ndim != 1:
        raise TypeError(f"text must be 1-D torch.uint8, got {text.dtype} {tuple(text.shape)}")
    T, P = row_off.numel(), pair_text.numel()
    for t, name, dt, n in ((plens, "plens", torch.int32, K), (row_off, "row_off", torch.int64, T),
                           (tlens, "tlens", torch.int32, T),
                           (pair_text, "pair_text", torch.int32, P),
                           (pair_pat, "pair_pat", torch.int32, P)):
        if t.dtype != dt or t.shape != (n,):
            raise TypeError(f"{name} must be {dt}[{n}], got {t.dtype} {tuple(t.shape)}")
        if t.device != text.device:
            raise ValueError(f"{name} is on {t.device}, the text on {text.device}")
    if masks.device != text.device:
        raise ValueError(f"masks are on {masks.device}, the text on {text.device}")


def semiglobal_dist_plain(
    masks: torch.Tensor,      # uint32/int32[K, 256] pattern masks
    plens: torch.Tensor,      # int32[K] pattern lengths (0..32)
    text: torch.Tensor,       # uint8[N] the texts, joined
    row_off: torch.Tensor,    # int64[T] each text's first byte in ``text``
    tlens: torch.Tensor,      # int32[T] text lengths
    pair_text: torch.Tensor,  # int32[P] each pair's text
    pair_pat: torch.Tensor,   # int32[P] each pair's pattern
    *,
    block: int = BLOCK,
    pairs_per_batch: int = PLAIN_PAIRS,
) -> torch.Tensor:
    """``int32[P]``: the reference's ``semiglobal_dist`` of each pair, in
    plain PyTorch: pattern ``pair_pat[p]`` against text ``pair_text[p]``,
    tiles at multiples of ``block`` reading ``block + 31`` bytes, the state
    reset per tile, the min over tiles; an empty text gives ``max(m, 1)``.
    A pair whose indices, text bounds or pattern length lie out of range
    gives -1, as the kernel does."""
    check_pairs(masks, plens, text, row_off, tlens, pair_text, pair_pat)
    P, dev = pair_text.numel(), text.device
    out = torch.full((P,), -1, dtype=torch.int32, device=dev)
    K, T, N = masks.shape[0], row_off.numel(), text.numel()
    W = block + MAX_PATTERN - 1
    masks64 = u32_values(masks).to(torch.int64)
    for p0 in range(0, P, pairs_per_batch):
        pt = pair_text[p0:p0 + pairs_per_batch].to(torch.int64)
        pp = pair_pat[p0:p0 + pairs_per_batch].to(torch.int64)
        good = (pt >= 0) & (pt < T) & (pp >= 0) & (pp < K)
        pt, pp = torch.where(good, pt, 0), torch.where(good, pp, 0)
        if T:
            off, ln = row_off[pt], tlens[pt].to(torch.int64)
            good &= (off >= 0) & (ln >= 0) & (off + ln <= N)
        if K:
            m = plens[pp].to(torch.int64)
            good &= (m >= 0) & (m <= MAX_PATTERN)
        sel = torch.nonzero(good).flatten()
        if sel.numel() == 0:
            continue
        off, ln, pat = row_off[pt[sel]], tlens[pt[sel]].to(torch.int64), pp[sel]
        nb = max(1, -(-int(ln.max()) // block))
        starts = torch.arange(nb, device=dev, dtype=torch.int64) * block
        eff = torch.clamp(ln[:, None] - starts[None, :], 0, W)          # [n, nb]
        p = torch.clamp_min(plens[pat].to(torch.int64), 1)
        high = (torch.ones_like(p) << (p - 1))[:, None]                 # [n, 1]
        pm = masks64[pat]                                               # [n, 256]
        score = p[:, None].expand(-1, nb).clone()
        best = score.clone()
        pv = torch.full_like(score, U32_MASK)
        mv = torch.zeros_like(score)
        base = off[:, None] + starts[None, :]
        for j in range(int(eff.max())):
            live = j < eff
            pos = torch.where(live, base + j, 0)
            eq = torch.gather(pm, 1, text[pos].to(torch.int64))
            xv = eq | mv
            xh = ((((eq & pv) + pv) & U32_MASK) ^ pv) | eq
            ph = mv | (~(xh | pv) & U32_MASK)
            mh = pv & xh
            score2 = score + ((ph & high) != 0).to(torch.int64) - ((mh & high) != 0).to(torch.int64)
            # search variant: row 0 is free, so shift without OR-ing in bit 0
            ph = (ph << 1) & U32_MASK
            mh = (mh << 1) & U32_MASK
            pv = torch.where(live, mh | (~(xv | ph) & U32_MASK), pv)
            mv = torch.where(live, ph & xv, mv)
            score = torch.where(live, score2, score)
            best = torch.where(live, torch.minimum(best, score), best)
        out[p0 + sel] = best.amin(dim=1).to(torch.int32)
    return out


def semiglobal_dist(masks, plens, text, row_off, tlens, pair_text, pair_pat) -> torch.Tensor:
    """``int32[P]`` per-pair distances (see :func:`semiglobal_dist_plain`):
    the CUDA kernel ``myers_pairs`` for tensors on the card, the plain
    version for tensors on the CPU."""
    if text.device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.editdist_cuda import myers_pairs

        return myers_pairs(masks, plens, text, row_off, tlens, pair_text, pair_pat)
    return semiglobal_dist_plain(masks, plens, text, row_off, tlens, pair_text, pair_pat)


def bound_at_most(dist: np.ndarray, plens: np.ndarray, threshold: float) -> np.ndarray:
    """``partial_ratio_bound(d, m) <= threshold`` in float64, the
    reference's per-pair prune compare."""
    return partial_ratio_bound(dist, plens) <= threshold


def prune_mask_tables(
    tables: tuple[np.ndarray, np.ndarray, np.ndarray],  # (masks, lens, ok)
    texts_tok: np.ndarray,   # uint8[P, L] text per pair
    text_lens: np.ndarray,   # int32[P], each at most L
    pattern_ix: np.ndarray,  # int32[P] index into the patterns per pair
    threshold: float,
    *,
    device=None,
) -> np.ndarray:
    """``bool[P]``: True where the pair can be pruned (bound ≤
    ``threshold``).  Pairs whose pattern is empty or overlong, or whose
    text is not strictly longer than the pattern, are never pruned, as in
    the reference (rapidfuzz scores equal lengths both ways, which the
    one-way bound does not cover); the others go to :func:`semiglobal_dist`
    on ``device`` (None: the card) in one launch."""
    from advanced_scrapper_tpu_torch import resolve_device

    masks, lens, ok = tables
    pattern_ix = np.asarray(pattern_ix, dtype=np.int32)
    text_lens = np.asarray(text_lens, dtype=np.int32)
    applicable = ok[pattern_ix] & (text_lens > lens[pattern_ix])
    out = np.zeros(len(pattern_ix), dtype=bool)
    if not applicable.any():
        return out
    P, L = texts_tok.shape
    if int(text_lens.max()) > L:
        raise ValueError(f"a text length exceeds the row width {L}")
    dev = resolve_device(device)
    sel = np.flatnonzero(applicable)
    n = sel.size
    text = torch.from_numpy(np.ascontiguousarray(texts_tok[sel], dtype=np.uint8).reshape(-1))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    d = semiglobal_dist(
        t(masks.view(np.int32)).view(torch.uint32), t(lens.astype(np.int32)), text.to(dev),
        t(np.arange(n, dtype=np.int64) * L), t(text_lens[sel]),
        t(np.arange(n, dtype=np.int32)), t(pattern_ix[sel]))
    out[sel] = bound_at_most(d.cpu().numpy(), lens[pattern_ix[sel]], threshold)
    return out


def prune_mask(
    patterns: list[bytes],
    texts_tok: np.ndarray,
    text_lens: np.ndarray,
    pattern_ix: np.ndarray,
    threshold: float,
    *,
    device=None,
) -> np.ndarray:
    """:func:`prune_mask_tables` with the mask tables built on every call
    (use the tables form in loops)."""
    return prune_mask_tables(build_pattern_masks(patterns), texts_tok, text_lens, pattern_ix,
                             threshold, device=device)
