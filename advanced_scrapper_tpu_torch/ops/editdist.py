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
:func:`myers_bound` launches the CUDA kernel (``csrc/editdist.cu``,
``ops/editdist_cuda.py``) for tensors on the card and
:func:`myers_bound_plain` for tensors on the CPU.
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
