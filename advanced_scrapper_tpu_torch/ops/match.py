"""The matcher's q-gram screen: name tables, the plain PyTorch screen and
its dispatcher.

Counterpart of the reference's ``ops/match.py``.  Each article row
(``title\\ntext``, utf-8) has its q=3 gram hashes (FNV-1a + fmix32, as
``ops/shingle.py``) taken ``% 2¹⁵`` into a bitmap; an (article, name) pair
survives when enough of the name's kept grams are present.  The soundness
bounds are the reference's, float32 where it is:

- fuzzy names, part ``D ≥ m``: ``kept − q·⌊m·frac⌋``; part ``D < m``:
  ``(D − q + 1) − q·⌊min(D, m)·frac⌋``, 0 for truncated names; the pair
  survives when ``min`` over text and title ``≤ 0`` or ``count ≥
  max(req, 1)``;
- exact (ALL-CAPS) names: every kept gram present and ``max(text_len,
  title_len) ≥ m``.

``frac = 2·(1 − t/100)`` is computed once on the host as the JAX package
computes it on the CPU (:func:`screen_frac`).

The rows arrive ragged, as the port's matcher holds them: one flat
``uint8`` text with ``int64`` row offsets and ``int32`` lengths, no padding.
The names arrive as a CSR table of their kept grams (:func:`names_csr`,
:func:`screen_tensors`), and for the kernel also sorted by gram count and
interleaved a warp's names at a time (:func:`screen_layout`).  :func:`screen_plain` is the math of the
reference's ``_screen_core``; :func:`match_screen` launches the CUDA kernel
(``csrc/match.cu``, ``ops/match_cuda.py``) for tensors on the card and the
plain version for tensors on the CPU.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from advanced_scrapper_tpu_torch.core.hashing import gram_hashes_np
from advanced_scrapper_tpu_torch.ops.shingle import shingle_hash

NBITS = 1 << 15
DEFAULT_Q = 3
MAX_GRAMS = 96

#: flags bit: the row's text side is refine-eligible (non-empty, pure
#: ASCII) — the byte-level Myers bound is only sound against the
#: char-level scorer on ASCII text.
FLAG_REFINE_OK = 1

#: mask bits: bit 0 = the (article, name) pair survives the q-gram screen;
#: bit 1 = the name's text-side fuzzy score is device-proven ≤ threshold
#: (the Myers bound; only ever set on refine-candidate columns).
MASK_SCREEN_KEEP = 1
MASK_TEXT_PRUNED = 2

#: rows the plain screen holds in one bitmap batch (4 KiB of bits each)
PLAIN_ROWS = 512

#: columns of one tile of the kernel's layout (:func:`screen_layout`): the
#: kernel sorts names by gram count within a tile and stages a tile's keep
#: masks in shared memory (4 B a column)
SCREEN_TILE_COLS = 8192
#: names a group of the layout holds: a warp's lanes
GROUP = 32
#: the gram of a padding slot: the kernel's bitmap never sets that entry
PAD_GRAM = NBITS
#: the kernel counts a name's grams in bytes and compares them in SWAR
#: below the byte's top bit
MAX_KERNEL_GRAMS = 127


def prepare_names(
    names: list[bytes],
    q: int = DEFAULT_Q,
    *,
    fuzzy: np.ndarray | None = None,
    nbits: int = NBITS,
    max_grams: int = MAX_GRAMS,
) -> dict:
    """Host-side name tables (the reference's ``prepare_names``): ``grams
    int32[N, max_grams]`` (bit indices, -1 padded), ``kept/total
    int32[N]`` gram counts, ``name_len int32[N]``, ``fuzzy bool[N]``."""
    n = len(names)
    fuzzy = np.zeros(n, bool) if fuzzy is None else np.asarray(fuzzy, bool)
    grams = np.full((n, max_grams), -1, dtype=np.int32)
    kept = np.zeros(n, dtype=np.int32)
    total = np.zeros(n, dtype=np.int32)
    name_len = np.zeros(n, dtype=np.int32)
    for i, raw in enumerate(names):
        h = gram_hashes_np(raw, q)
        g = (h % nbits).astype(np.int32)[:max_grams]
        grams[i, : len(g)] = g
        kept[i] = len(g)
        total[i] = len(h)
        name_len[i] = len(raw)
    return {
        "grams": grams,
        "kept": kept,
        "total": total,
        "name_len": name_len,
        "fuzzy": fuzzy.copy(),
    }


def names_csr(tables: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(gram_off int32[N+1], grams int16[Σ kept])``: each name's kept
    gram indices, in order and with repeats (the screen counts a repeated
    gram once per occurrence, as the reference's gather does).  Indices
    are below ``2¹⁵``, so ``int16`` holds them without sign."""
    g = np.asarray(tables["grams"])
    kept = np.asarray(tables["kept"]).astype(np.int64)
    off = np.zeros(len(kept) + 1, dtype=np.int64)
    np.cumsum(kept, out=off[1:])
    if off[-1] >= 1 << 31:
        raise ValueError(f"{off[-1]} grams overflow the int32 CSR offsets")
    flat = g[np.arange(g.shape[1])[None, :] < kept[:, None]]
    if flat.size and (flat.min() < 0 or flat.max() >= 1 << 15):
        raise ValueError("gram indices must lie in [0, 2^15)")
    return off.astype(np.int32), flat.astype(np.int16)


def screen_layout(off: np.ndarray, grams: np.ndarray,
                  tile_cols: int = SCREEN_TILE_COLS) -> dict[str, np.ndarray]:
    """The names' grams as the CUDA screen reads them (``csrc/match.cu``),
    from the CSR of :func:`names_csr`.  Within each tile of ``tile_cols``
    columns the names are sorted by kept-gram count, most first (stably),
    and dealt to groups of :data:`GROUP` (a warp's lanes), the tile's last
    group padded with slots of column -1:

    - ``slot_col int32[G*32]``: each slot's column;
    - ``group_off int32[G+1]``: each group's first gram step;
    - ``grams_il int16[group_off[G]*32]``: gram ``j`` of the group's names
      side by side at ``(group_off[g] + j) * 32 + lane``, as ``uint16``
      bits; a slot past its name's grams holds :data:`PAD_GRAM`;
    - ``tile_groups int32[T+1]``: the groups of each tile."""
    kept = np.diff(np.asarray(off, np.int64))
    if kept.size and kept.max() > MAX_KERNEL_GRAMS:
        raise ValueError(f"a name keeps {kept.max()} grams; the kernel counts up to "
                         f"{MAX_KERNEL_GRAMS}")
    cols, tile_groups = [], [0]
    for c0 in range(0, kept.size, tile_cols):
        order = c0 + np.argsort(-kept[c0:c0 + tile_cols], kind="stable")
        cols += [order, np.full(-order.size % GROUP, -1)]
        tile_groups.append(tile_groups[-1] + -(-order.size // GROUP))
    slot_col = np.concatenate(cols).astype(np.int64) if cols else np.zeros(0, np.int64)
    by_group = slot_col.reshape(-1, GROUP)
    slot_kept = np.where(by_group >= 0, kept[np.maximum(by_group, 0)] if kept.size else 0, 0)
    lens = slot_kept.max(axis=1) if by_group.size else np.zeros(0, np.int64)
    group_off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=group_off[1:])
    step_group = np.repeat(np.arange(len(lens)), lens)
    j = np.arange(step_group.size) - group_off[step_group]
    step_cols = by_group[step_group]                                   # [steps, 32]
    live = j[:, None] < slot_kept[step_group]
    src = np.where(live, np.asarray(off, np.int64)[np.maximum(step_cols, 0)] + j[:, None], 0)
    grams_u16 = np.where(live, np.asarray(grams).view(np.uint16)[src] if grams.size else 0,
                         PAD_GRAM).astype(np.uint16)
    return {
        "slot_col": slot_col.astype(np.int32),
        "group_off": group_off.astype(np.int32),
        "grams_il": grams_u16.reshape(-1).view(np.int16),
        "tile_groups": np.asarray(tile_groups, np.int32),
    }


def screen_tensors(tables: dict, device: torch.device | str) -> dict:
    """The name tables as tensors on ``device``, in the form the screen
    takes: the CSR of :func:`names_csr` (the plain version's),
    ``kept/total/name_len int32[N]``, ``fuzzy uint8[N]``, and the kernel's
    layout of :func:`screen_layout`."""
    off, grams = names_csr(tables)
    out = {
        "gram_off": torch.from_numpy(off),
        "grams": torch.from_numpy(grams),
        **{k: torch.from_numpy(v) for k, v in screen_layout(off, grams).items()},
        "kept": torch.from_numpy(np.asarray(tables["kept"], np.int32)),
        "total": torch.from_numpy(np.asarray(tables["total"], np.int32)),
        "name_len": torch.from_numpy(np.asarray(tables["name_len"], np.int32)),
        "fuzzy": torch.from_numpy(np.asarray(tables["fuzzy"], bool).astype(np.uint8)),
    }
    return {k: v.to(device) for k, v in out.items()}


def _round_f32(x: Fraction) -> np.float32:
    """``x`` rounded once to float32, to nearest, ties to even."""
    guess = np.float32(float(x))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.uint32)) & 1))


def screen_frac(threshold: float) -> np.float32:
    """``frac = 2·(1 − t/100)`` in float32, as the JAX package computes it
    on the CPU: XLA turns ``t / 100`` into ``t · 0.01f`` and LLVM fuses
    ``1 − t·0.01f`` into one multiply-add, so the product is not rounded
    before the subtraction (at t = 95 that is 0.10000004 where IEEE
    division order gives 0.10000002).  The tests sweep thresholds against
    the JAX screen."""
    t = np.float32(threshold)
    exact = Fraction(1) - Fraction(float(t)) * Fraction(float(np.float32(0.01)))
    return np.float32(2.0) * _round_f32(exact)


def check_rows(text, row_off, row_len, *rest) -> None:
    """Raise unless ``text`` is a 1-D ``uint8`` tensor, ``row_off`` a 1-D
    ``int64`` tensor and ``row_len`` and ``rest`` 1-D ``int32`` tensors of
    its length, all on one device."""
    if text.dtype != torch.uint8 or text.ndim != 1:
        raise TypeError(f"text must be 1-D torch.uint8, got {text.dtype} {tuple(text.shape)}")
    if row_off.dtype != torch.int64 or row_off.ndim != 1:
        raise TypeError(f"row_off must be 1-D torch.int64, got {row_off.dtype}")
    for i, t in enumerate((row_len, *rest)):
        if t.dtype != torch.int32 or t.shape != row_off.shape:
            raise TypeError(
                f"row array {i} must be torch.int32 of shape {tuple(row_off.shape)}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    for t in (row_off, row_len, *rest):
        if t.device != text.device:
            raise ValueError(f"a row array is on {t.device}, the text on {text.device}")


def row_gram_bitmaps(
    text: torch.Tensor, row_off: torch.Tensor, row_len: torch.Tensor,
    q: int = DEFAULT_Q, nbits: int = NBITS,
) -> torch.Tensor:
    """``bool[R, nbits]``: bit ``h % nbits`` set for the hash ``h`` of every
    q-byte window inside each row (none for rows shorter than q)."""
    R = row_off.numel()
    bitmap = torch.zeros((R, nbits), dtype=torch.bool, device=text.device)
    n_grams = (row_len.to(torch.int64) - (q - 1)).clamp_min(0)
    if text.numel() < q or int(n_grams.sum()) == 0:
        return bitmap
    flat = torch.full((1,), text.numel(), dtype=torch.int32, device=text.device)
    h, _valid = shingle_hash(text[None, :], flat, q)            # [1, T-q+1]
    rows = torch.repeat_interleave(torch.arange(R, device=text.device), n_grams)
    first = torch.cumsum(n_grams, 0) - n_grams                  # each row's first gram
    pos = torch.arange(rows.numel(), device=text.device) - first[rows] + row_off[rows]
    bitmap[rows, h[0, pos] % nbits] = True
    return bitmap


def screen_plain(
    text: torch.Tensor,
    row_off: torch.Tensor,
    row_len: torch.Tensor,
    text_len: torch.Tensor,
    title_len: torch.Tensor,
    tables: dict,
    threshold: float,
    q: int = DEFAULT_Q,
    nbits: int = NBITS,
) -> torch.Tensor:
    """``bool[R, N]``: the reference's ``_screen_core`` over ragged rows
    (``row_len`` is the combined ``title\\ntext`` length, ``text_len`` and
    ``title_len`` the parts'), in plain PyTorch on any device; ``tables``
    from :func:`screen_tensors`."""
    check_rows(text, row_off, row_len, text_len, title_len)
    R, N = row_off.numel(), tables["kept"].numel()
    dev = text.device
    kept = tables["kept"][None, :]
    m = tables["name_len"][None, :]
    truncated = (tables["kept"] < tables["total"])[None, :]
    fuzzy = tables["fuzzy"].bool()[None, :]
    gram_name = torch.repeat_interleave(
        torch.arange(N, device=dev), tables["kept"].to(torch.int64))
    grams = tables["grams"].to(torch.int64)
    frac = torch.tensor(float(screen_frac(threshold)), dtype=torch.float32, device=dev)
    out = torch.zeros((R, N), dtype=torch.bool, device=dev)
    for r0 in range(0, R, PLAIN_ROWS):
        sl = slice(r0, min(R, r0 + PLAIN_ROWS))
        bitmap = row_gram_bitmaps(text, row_off[sl], row_len[sl], q, nbits)
        count = torch.zeros((bitmap.shape[0], N), dtype=torch.int32, device=dev)
        count.index_add_(1, gram_name, bitmap[:, grams].to(torch.int32))

        def fuzzy_bound(D):
            D = D[:, None]
            e = torch.minimum(D, m)
            dmax = torch.floor(e.to(torch.float32) * frac).to(torch.int32)
            dmax_m = torch.floor(m.to(torch.float32) * frac).to(torch.int32)
            b_long = kept - q * dmax_m
            b_short = (D - q + 1) - q * dmax
            b_short = torch.where(truncated, 0, b_short)
            return torch.where(D >= m, b_long, b_short)

        req = torch.minimum(fuzzy_bound(text_len[sl]), fuzzy_bound(title_len[sl]))
        fuzzy_keep = (req <= 0) | (count >= torch.clamp_min(req, 1))
        part_max = torch.maximum(text_len[sl], title_len[sl])[:, None]
        exact_keep = (count >= kept) & (part_max >= m)
        out[sl] = torch.where(fuzzy, fuzzy_keep, exact_keep)
    return out


def match_screen(
    text: torch.Tensor,
    row_off: torch.Tensor,
    row_len: torch.Tensor,
    text_len: torch.Tensor,
    title_len: torch.Tensor,
    tables: dict,
    *,
    threshold: float = 95.0,
) -> torch.Tensor:
    """``uint8[R, N]`` screen mask, bit 0 = the pair survives: the CUDA
    kernel ``match_screen`` for tensors on the card, :func:`screen_plain`
    for tensors on the CPU."""
    if text.device.type == "cuda":
        from advanced_scrapper_tpu_torch.ops.match_cuda import match_screen as kernel

        return kernel(text, row_off, row_len, text_len, title_len, tables,
                      screen_frac(threshold))
    return screen_plain(text, row_off, row_len, text_len, title_len, tables,
                        threshold).to(torch.uint8)
