"""LSH banding, candidate generation and union-find resolution in PyTorch.

Counterpart of the reference's ``ops/lsh.py``, bit-equal to it.  The
reference leaves these stages to XLA outside any Pallas kernel; here they
are plain PyTorch on the accumulator's device.

- band keys: an FNV-1a fold of each band's signature rows, XOR a salt,
  then ``fmix32`` — ``int64`` values in ``[0, 2³²)`` (``ops.shingle``);
  the wide keys add a second lane of other constants (the stream
  backend's bloom mode packs the two into 64 bits);
- candidates: each band's rows sorted by (key, row) — a stable sort over
  rows in ascending order — give every row its run head, predecessor and
  predecessor² as candidate representatives;
- resolution: a candidate edge holds when the two signatures agree on at
  least ``threshold`` of their permutations (``count/P`` in float32
  against a float32 threshold, as the reference compares), then labels
  are propagated to the connected-component minimum.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops.shingle import (
    FNV_OFFSET,
    FNV_PRIME,
    U32_MASK,
    U32_MAX,
    fmix32,
    u32_values,
)


def _salt_tensor(salt, device: torch.device) -> torch.Tensor:
    if isinstance(salt, torch.Tensor):
        return salt.to(device=device, dtype=torch.int64) & U32_MASK
    return torch.from_numpy(np.asarray(salt, np.uint32).astype(np.int64)).to(device)


def _fold_bands(sig64: torch.Tensor, nb: int, offset: int, prime: int) -> torch.Tensor:
    """FNV-1a fold of each band's signature rows → ``int64[B, nb]`` (unsalted)."""
    B, P = sig64.shape
    rows = sig64.reshape(B, nb, P // nb)
    k = torch.full((B, nb), offset, dtype=torch.int64, device=sig64.device)
    for j in range(P // nb):
        k = ((k ^ rows[:, :, j]) * prime) & U32_MASK
    return k


def band_keys(sig: torch.Tensor, band_salt) -> torch.Tensor:
    """Salted bucket key per band: ``uint32[B, P]`` signatures →
    ``int64[B, num_bands]`` keys in ``[0, 2³²)``."""
    salt = _salt_tensor(band_salt, sig.device)
    k = _fold_bands(u32_values(sig), salt.shape[0], FNV_OFFSET, FNV_PRIME)
    return fmix32(k ^ salt[None, :])


#: second-lane constants of the wide keys: an FNV-style offset/prime pair
#: distinct from lane 0's, so the two lanes are independent hashes
WIDE_OFFSET = 0xCBF29CE4
WIDE_PRIME = 0x01000197

#: the queue item that ports the OPH backend and its densify
SLICE_OPH = "the slice of ROADMAP item 12 (the OPH backend)"


def band_keys_wide(sig: torch.Tensor, band_salt) -> torch.Tensor:
    """Two independent keys per band: ``uint32[B, P]`` signatures →
    ``int64[B, num_bands, 2]`` in ``[0, 2³²)``.  Lane 0 is
    :func:`band_keys`; lane 1 folds the same rows with
    ``WIDE_OFFSET``/``WIDE_PRIME`` and the salt rotated left by 13 bits.
    ``utils.bloom.pack_keys64`` packs lane 1 as the high word."""
    salt = _salt_tensor(band_salt, sig.device)
    nb = salt.shape[0]
    sig64 = u32_values(sig)
    lo = _fold_bands(sig64, nb, FNV_OFFSET, FNV_PRIME)
    hi = _fold_bands(sig64, nb, WIDE_OFFSET, WIDE_PRIME)
    rot = ((salt << 13) & U32_MASK) | (salt >> 19)
    return torch.stack([fmix32(lo ^ salt[None, :]), fmix32(hi ^ rot[None, :])], dim=-1)


def subband_salt(num: int, seed: int = 0x5B5C9A02) -> np.ndarray:
    """Deterministic ``uint32[num]`` salts for the fine sub-band keys."""
    x = (np.arange(num, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + np.uint64(seed)) & np.uint64(0xFFFFFFFF)
    return x.astype(np.uint32)


def _coarse_fine_keys(sig: torch.Tensor, band_salt, fine_salt) -> torch.Tensor:
    """Coarse keys, then fine keys when ``fine_salt`` is not empty:
    ``int64[B, nb + len(fine_salt)]``."""
    keys = band_keys(sig, band_salt)
    if len(fine_salt):
        keys = torch.cat([keys, band_keys(sig, fine_salt)], dim=1)
    return keys


def candidate_keys(sig: torch.Tensor, band_salt, cand_subbands: int) -> torch.Tensor:
    """Coarse + fine candidate band keys ``int64[B, nb + cand_subbands]``
    (in ``[0, 2³²)``); ``cand_subbands=0`` gives the coarse keys alone."""
    if not cand_subbands:
        return band_keys(sig, band_salt)
    num_perm = sig.shape[-1]
    if num_perm % cand_subbands:
        raise ValueError(
            f"cand_subbands {cand_subbands} must divide num_perm {num_perm} "
            "(each sub-band folds num_perm/cand_subbands signature rows)"
        )
    return _coarse_fine_keys(sig, band_salt, subband_salt(cand_subbands))


def _run_head_per_band(kt: torch.Tensor):
    """For each band (axis 0) sort rows by (key, row): ``(si, head, pred,
    pred2)`` in sorted order — each row's run head (first-seen row of its
    equal-key run), run predecessor, and the row two places back in the run
    (self where there is none)."""
    nb, B = kt.shape
    dev = kt.device
    _, si = torch.sort(kt, dim=1, stable=True)  # ties keep ascending rows
    sk = kt.gather(1, si)
    seg_start = torch.cat(
        [torch.ones((nb, 1), dtype=torch.bool, device=dev), sk[:, 1:] != sk[:, :-1]],
        dim=1,
    )
    seg_id = torch.cumsum(seg_start, dim=1) - 1
    pos = torch.arange(B, device=dev).expand(nb, B)
    # rows ascend within a run, so its head is its first sorted position
    run_start = torch.where(seg_start, pos, 0).cummax(dim=1).values
    head = si.gather(1, run_start)
    pred = torch.where(seg_start, si, torch.cat([si[:, :1], si[:, :-1]], dim=1))
    two = min(2, B)
    shift2 = torch.cat([si[:, :two], si[:, :-2]], dim=1)
    same_run2 = torch.cat(
        [torch.zeros((nb, two), dtype=torch.bool, device=dev),
         seg_id[:, 2:] == seg_id[:, :-2]],
        dim=1,
    )
    pred2 = torch.where(same_run2, shift2, si)
    return si, head, pred, pred2


def duplicate_rep_bands(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-band candidate representatives ``int32[B, 3·nb]``: run heads for
    every band, then run predecessors, then predecessors².  Invalid rows
    take key ``U32_MAX`` and map to themselves."""
    B, nb = keys.shape
    idx = torch.arange(B, device=keys.device)
    kt = torch.where(valid[:, None], keys, U32_MAX).T.contiguous()
    idxb = idx.expand(nb, B)
    si, *cands_sorted = _run_head_per_band(kt)
    cands = []
    for cand_sorted in cands_sorted:
        cand = torch.empty_like(si).scatter_(1, si, cand_sorted)
        cands.append(torch.where(valid[None, :], cand, idxb).T)
    return torch.cat(cands, dim=1).to(torch.int32)


def _fine_only_chunks(rep_bands: torch.Tensor, keys: torch.Tensor, num_coarse: int):
    """Yield ``(c0, cand, fine_only)`` in 8-column chunks: ``fine_only[b, c]``
    when column c's candidate shares no coarse band with row b."""
    B, ncols = rep_bands.shape
    nbands = keys.shape[1]
    if ncols % nbands:
        raise ValueError(f"{ncols} candidate columns for {nbands} bands")
    coarse = keys[:, :num_coarse]
    is_fine = np.tile(np.arange(nbands) >= num_coarse, ncols // nbands)
    for c0 in range(0, ncols, 8):
        cand = rep_bands[:, c0 : c0 + 8].to(torch.int64)
        fine_cols = is_fine[c0 : c0 + 8]
        if not fine_cols.any():
            yield c0, cand, torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
            continue
        shared = (coarse[:, None, :] == coarse[cand]).any(dim=2)
        yield c0, cand, ~shared & torch.from_numpy(fine_cols).to(cand.device)[None, :]


def fine_edge_thresholds(
    rep_bands: torch.Tensor,
    keys: torch.Tensor,
    base: float,
    fine_margin: float,
    *,
    num_coarse: int,
) -> torch.Tensor:
    """Per-edge bars ``float32[B, nc]``: ``base`` for edges whose endpoints
    share a coarse band, ``base + fine_margin`` (summed in float32) for
    fine-only edges."""
    dev = rep_bands.device
    base_t = torch.tensor(base, dtype=torch.float32, device=dev)
    strict = base_t + torch.tensor(fine_margin, dtype=torch.float32, device=dev)
    return torch.cat(
        [
            torch.where(fine_only, strict, base_t)
            for _c0, _cand, fine_only in _fine_only_chunks(rep_bands, keys, num_coarse)
        ],
        dim=1,
    )


def _label_components(rep_bands, ok, valid, jump_rounds: int) -> torch.Tensor:
    """Connected-component minimum labels over the ``ok`` edges: pull the
    min along edges, push it back with a scatter-min, pointer-double."""
    B, nc = rep_bands.shape
    idx = torch.arange(B, device=rep_bands.device)
    cand = torch.where(ok, rep_bands.to(torch.int64), idx[:, None]).reshape(-1)
    lab = idx
    for _ in range(jump_rounds):
        pulled = lab[cand].reshape(B, nc).amin(dim=1)
        lab = torch.minimum(lab, pulled)
        lab = lab.scatter_reduce(
            0, cand, lab[:, None].expand(B, nc).reshape(-1), "amin", include_self=True
        )
        lab = lab[lab]
    return torch.where(valid, lab, idx).to(torch.int32)


def resolve_rep_bands(
    rep_bands: torch.Tensor,
    sig: torch.Tensor,
    valid: torch.Tensor,
    threshold,
    *,
    jump_rounds: int,
) -> torch.Tensor:
    """Verify every candidate by signature agreement and label connected
    components: ``int32[B]`` representatives (the component minimum).
    ``threshold`` is a scalar, a per-column ``float32[nc]`` or a per-edge
    ``float32[B, nc]``.  An edge needs both endpoints valid."""
    B, nc = rep_bands.shape
    P = sig.shape[1]
    dev = sig.device
    s32 = sig.view(torch.int32)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=dev)
    thr = thr.expand((nc,) if thr.ndim < 2 else (B, nc))
    rb = rep_bands.to(torch.int64)
    ok_parts = []
    # 8-column chunks keep the gathered transient at [B, 8, P]
    for c0 in range(0, nc, 8):
        cand_sig = s32[rb[:, c0 : c0 + 8]]
        agree = (s32[:, None, :] == cand_sig).sum(dim=2).to(torch.float32) / P
        thr_c = thr[..., c0 : c0 + 8]
        ok_parts.append(agree >= (thr_c if thr_c.ndim == 2 else thr_c[None, :]))
    ok = torch.cat(ok_parts, dim=1) & valid[:, None] & valid[rb]
    return _label_components(rep_bands, ok, valid, jump_rounds)


def resolve_rep_bands_from_ok(
    rep_bands: torch.Tensor, ok: torch.Tensor, valid: torch.Tensor, *, jump_rounds: int
) -> torch.Tensor:
    """:func:`resolve_rep_bands` with the verified-edge matrix ``ok
    bool[B, nc]`` supplied (edited on the host by exact verify, or the
    rerank tier's rewritten cells): ``int32[B]`` component labels."""
    return _label_components(rep_bands, ok, valid, jump_rounds)


def borderline_edge_mask(
    rep_bands: torch.Tensor,
    sig: torch.Tensor,
    keys: torch.Tensor,
    valid: torch.Tensor,
    base: float,
    band: float,
    *,
    num_coarse: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(need bool[B, nc], ok bool[B, nc])``: ``ok`` is every candidate
    edge whose agreement clears ``base`` (both endpoints valid); ``need``
    the real edges among them (not self) that exact Jaccard must confirm:
    fine-only ones (no coarse band shared) at any agreement, and the rest
    below ``band``.  Agreement, ``base`` and ``band`` compare in float32,
    as the reference does."""
    B = rep_bands.shape[0]
    P = sig.shape[1]
    dev = sig.device
    s32 = sig.view(torch.int32)
    idx = torch.arange(B, device=dev)
    base_t = torch.tensor(base, dtype=torch.float32, device=dev)
    band_t = torch.tensor(band, dtype=torch.float32, device=dev)
    need_parts, ok_parts = [], []
    for _c0, cand, fine_only in _fine_only_chunks(rep_bands, keys, num_coarse):
        agree = (s32[:, None, :] == s32[cand]).sum(dim=2).to(torch.float32) / P
        ok = (agree >= base_t) & valid[:, None] & valid[cand]
        need_parts.append(ok & (cand != idx[:, None]) & (fine_only | (agree < band_t)))
        ok_parts.append(ok)
    return torch.cat(need_parts, dim=1), torch.cat(ok_parts, dim=1)


def fused_candidate_epilogue(
    sig_acc: torch.Tensor, valid: torch.Tensor, band_salt, fine_salt
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sigs, keys, rep_bands)`` from the signature accumulator: the
    front half of :func:`fused_resolve_epilogue`, for callers that edit
    the candidates between candidacy and resolution (the rerank tier,
    exact verify).  ``sigs`` is the accumulator itself."""
    keys = _coarse_fine_keys(sig_acc, band_salt, fine_salt)
    return sig_acc, keys, duplicate_rep_bands(keys, valid)


def fused_resolve_epilogue(
    sig_acc: torch.Tensor,
    valid: torch.Tensor,
    band_salt,
    fine_salt,
    base: float,
    fine_margin: float,
    *,
    num_coarse: int,
    jump_rounds: int,
    use_fine_margin: bool,
) -> torch.Tensor:
    """The whole estimator-only resolution from the signature accumulator:
    coarse+fine keys → per-band candidates → (optional) per-edge fine bars
    → verification and component labels.  Returns ``int32[B]``."""
    _sig, keys, rep_bands = fused_candidate_epilogue(sig_acc, valid, band_salt, fine_salt)
    thr = (
        fine_edge_thresholds(rep_bands, keys, base, fine_margin, num_coarse=num_coarse)
        if use_fine_margin
        else base
    )
    return resolve_rep_bands(rep_bands, sig_acc, valid, thr, jump_rounds=jump_rounds)


def fused_keys_epilogue(
    sig_acc: torch.Tensor, band_salt, fine_salt, *, densify_oph: bool, wide: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sigs, keys)`` from the signature accumulator, for callers that
    join on the host (the stream backend): ``wide=False`` gives the
    :func:`candidate_keys` coarse + fine keys (``fine_salt`` may be
    empty), ``wide=True`` the :func:`band_keys_wide` lanes (``fine_salt``
    unused).  ``sigs`` is the accumulator itself."""
    if densify_oph:
        raise NotImplementedError(
            f"the OPH densify is not ported yet; it comes in {SLICE_OPH}"
        )
    if wide:
        return sig_acc, band_keys_wide(sig_acc, band_salt)
    return sig_acc, _coarse_fine_keys(sig_acc, band_salt, fine_salt)


def keep_mask(rep: torch.Tensor) -> torch.Tensor:
    """True for rows that are their own representative (first seen)."""
    return rep == torch.arange(rep.shape[0], dtype=rep.dtype, device=rep.device)
