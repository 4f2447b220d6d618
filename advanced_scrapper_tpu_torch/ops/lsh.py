"""LSH banding, candidate generation and union-find resolution in PyTorch.

Counterpart of the reference's ``ops/lsh.py``, bit-equal to it.  The
reference leaves these stages to XLA outside any Pallas kernel.  For a
tensor on the card each public function here launches the hand-written
kernels of ``csrc/lsh.cu`` (``ops.lsh_cuda``: ``lsh_keys``, ``lsh_sort``,
``lsh_run_heads``, ``lsh_verify``, ``lsh_label``; no library call); for a
CPU tensor it runs the plain PyTorch version below, which the kernels
mirror.

- band keys: an FNV-1a fold of each band's signature rows, XOR a salt,
  then ``fmix32`` — ``int64`` values in ``[0, 2³²)`` (``ops.shingle``);
  the wide keys add a second lane of other constants (the stream
  backend's bloom mode packs the two into 64 bits);
- candidates: each band's rows sorted by (key, row) — one ``int64`` sort
  key ``(key << row_bits) | row``, invalid rows at key ``U32_MAX``; on the
  card a stable radix sort of the 32 key bits, the rows entering in
  ascending order — give every row its run head (the row at its run's
  start, a segmented max-scan of run starts), predecessor and
  predecessor² as candidate representatives;
- resolution: a candidate edge holds when the two signatures agree on at
  least ``threshold`` of their permutations (``count/P`` in float32
  against a float32 threshold, as the reference compares), then labels
  are propagated to the connected-component minimum in double-buffered
  rounds (a round that changed nothing ends them: every later one would
  change nothing either);
- the reference's single-candidate path (``duplicate_reps``: the
  smallest run head over all bands; ``resolve_reps``: verify it, then
  pointer jumping) and the ``psum``-able key histogram
  (``bucket_histogram``) of the mesh's batch step.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops import lsh_cuda
from advanced_scrapper_tpu_torch.ops.shingle import (
    FNV_OFFSET,
    FNV_PRIME,
    U32_MASK,
    U32_MAX,
    fmix32,
    u32_values,
)


def _on_card(t: torch.Tensor) -> bool:
    """A tensor on the card goes to the kernels, a CPU one to the plain
    versions; nothing falls back."""
    return t.device.type == "cuda"


def _i32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the contiguous ``int32`` the kernels take."""
    return t if t.dtype == torch.int32 and t.is_contiguous() else t.to(torch.int32).contiguous()


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


#: second-lane constants of the wide keys: an FNV-style offset/prime pair
#: distinct from lane 0's, so the two lanes are independent hashes
WIDE_OFFSET = 0xCBF29CE4
WIDE_PRIME = 0x01000197


def keys_plain(sig: torch.Tensor, band_salt, fine_salt=(), *, wide: bool = False) -> torch.Tensor:
    """Plain version of the ``lsh_keys`` kernel: the coarse keys of
    ``band_salt`` then the fine keys of ``fine_salt``, ``int64[B, nb + nf]``
    in ``[0, 2³²)``; with ``wide`` the two lanes ``int64[B, nb, 2]``
    (``fine_salt`` unused)."""
    salt = _salt_tensor(band_salt, sig.device)
    nb = salt.shape[0]
    sig64 = u32_values(sig)
    lo = fmix32(_fold_bands(sig64, nb, FNV_OFFSET, FNV_PRIME) ^ salt[None, :])
    if wide:
        hi = _fold_bands(sig64, nb, WIDE_OFFSET, WIDE_PRIME)
        rot = ((salt << 13) & U32_MASK) | (salt >> 19)
        return torch.stack([lo, fmix32(hi ^ rot[None, :])], dim=-1)
    if not len(fine_salt):
        return lo
    fine = _salt_tensor(fine_salt, sig.device)
    k = _fold_bands(sig64, fine.shape[0], FNV_OFFSET, FNV_PRIME)
    return torch.cat([lo, fmix32(k ^ fine[None, :])], dim=1)


def _keys(sig: torch.Tensor, band_salt, fine_salt=(), *, wide: bool = False) -> torch.Tensor:
    if _on_card(sig):
        return lsh_cuda.lsh_keys(sig.contiguous(), band_salt, fine_salt, wide=wide)[0]
    return keys_plain(sig, band_salt, fine_salt, wide=wide)


def band_keys(sig: torch.Tensor, band_salt) -> torch.Tensor:
    """Salted bucket key per band: ``uint32[B, P]`` signatures →
    ``int64[B, num_bands]`` keys in ``[0, 2³²)``."""
    return _keys(sig, band_salt)


def band_keys_wide(sig: torch.Tensor, band_salt) -> torch.Tensor:
    """Two independent keys per band: ``uint32[B, P]`` signatures →
    ``int64[B, num_bands, 2]`` in ``[0, 2³²)``.  Lane 0 is
    :func:`band_keys`; lane 1 folds the same rows with
    ``WIDE_OFFSET``/``WIDE_PRIME`` and the salt rotated left by 13 bits.
    ``utils.bloom.pack_keys64`` packs lane 1 as the high word."""
    return _keys(sig, band_salt, wide=True)


def subband_salt(num: int, seed: int = 0x5B5C9A02) -> np.ndarray:
    """Deterministic ``uint32[num]`` salts for the fine sub-band keys."""
    x = (np.arange(num, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + np.uint64(seed)) & np.uint64(0xFFFFFFFF)
    return x.astype(np.uint32)


def _coarse_fine_keys(sig: torch.Tensor, band_salt, fine_salt) -> torch.Tensor:
    """Coarse keys, then fine keys when ``fine_salt`` is not empty:
    ``int64[B, nb + len(fine_salt)]`` (one ``lsh_keys`` launch on the
    card)."""
    return _keys(sig, band_salt, fine_salt)


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


def row_bits(B: int) -> int:
    """Bits of the row index in a packed sort key ``(key << row_bits) |
    row``, which must fit a non-negative ``int64``: raises past 31."""
    bits = max(B - 1, 1).bit_length()
    if bits > 31:
        raise ValueError(f"{B} rows need {bits} row bits; the packed sort key takes at most 31")
    return bits


def pack_keys_plain(keys: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of the packed sort keys ``int64[nk, B]``: ``((valid ?
    key : U32_MAX) << bits) | row`` (``lsh_keys`` writes them beside the
    keys, ``lsh_cuda.pack_keys`` from keys already made)."""
    B = keys.shape[0]
    idx = torch.arange(B, device=keys.device)
    k = torch.where(valid[:, None], keys.to(torch.int64), U32_MAX)
    return ((k << bits) | idx[:, None]).T.contiguous()


def run_heads_plain(sorted_keys: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of the ``lsh_run_heads`` kernel: ``int32[B, 3·nbt]``
    run heads, predecessors and predecessors² of every row in every band
    from ``sorted_keys int64[nbt, B]``, each band's packed keys ascending.
    The run head is the row at its run's start (a max-scan of run starts:
    rows ascend within a run); the predecessors are the rows one and two
    sorted places back when their key is the same, else self.  Invalid
    rows map to themselves."""
    nbt, B = sorted_keys.shape
    dev = sorted_keys.device
    key = sorted_keys >> bits
    row = sorted_keys & ((1 << bits) - 1)
    same1 = key[:, 1:] == key[:, :-1]
    seg_start = torch.cat([torch.ones((nbt, 1), dtype=torch.bool, device=dev), ~same1], dim=1)
    pos = torch.arange(B, device=dev).expand(nbt, B)
    run_start = torch.where(seg_start, pos, 0).cummax(dim=1).values
    head = row.gather(1, run_start)
    pred = torch.where(seg_start, row, torch.cat([row[:, :1], row[:, :-1]], dim=1))
    two = min(2, B)
    same2 = torch.cat([torch.zeros((nbt, two), dtype=torch.bool, device=dev),
                       key[:, 2:] == key[:, :-2]], dim=1)
    pred2 = torch.where(same2, torch.cat([row[:, :two], row[:, :-2]], dim=1), row)
    idxb = torch.arange(B, device=dev).expand(nbt, B)
    cands = []
    for cand_sorted in (head, pred, pred2):
        cand = torch.empty_like(row).scatter_(1, row, cand_sorted)
        cands.append(torch.where(valid[None, :], cand, idxb).T)
    return torch.cat(cands, dim=1).to(torch.int32)


def sort_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``lsh_sort`` kernel: each band of the packed
    sort keys ``int64[nbt, B]`` ascending.  The keys are unique, so the
    order is the reference's stable ``(key, row)`` sort."""
    return torch.sort(packed, dim=1).values


def _rep_bands_from_packed(packed: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
    """Each band's packed keys sorted, then the run heads.  On the card
    ``lsh_sort`` (a stable LSD radix sort of the 32 key bits: the rows
    enter ascending, so ties end ordered by row, the packed keys' order)
    and ``lsh_run_heads``; on the CPU their plain versions."""
    if _on_card(packed):
        return lsh_cuda.lsh_run_heads(lsh_cuda.lsh_sort(packed, bits), valid, bits)
    return run_heads_plain(sort_plain(packed), valid, bits)


def duplicate_rep_bands(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-band candidate representatives ``int32[B, 3·nb]``: run heads for
    every band, then run predecessors, then predecessors².  Invalid rows
    take key ``U32_MAX`` and map to themselves."""
    bits = row_bits(keys.shape[0])
    valid = valid.contiguous()
    if _on_card(keys):
        packed = lsh_cuda.pack_keys(keys.to(torch.int64).contiguous(), valid, bits)
    else:
        packed = pack_keys_plain(keys, valid, bits)
    return _rep_bands_from_packed(packed, valid, bits)


def duplicate_reps(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Candidate representative per row ``int32[B]``: the smallest earlier
    row sharing any band (``rep[i] <= i``; self when none): the smallest
    run head over the bands.  Invalid rows map to themselves.  Candidates
    still need verification (:func:`resolve_reps`)."""
    return duplicate_rep_bands(keys, valid)[:, : keys.shape[1]].amin(dim=1)


def resolve_reps(
    rep: torch.Tensor,
    sig: torch.Tensor,
    valid: torch.Tensor,
    threshold: float,
    *,
    jump_rounds: int,
) -> torch.Tensor:
    """Verify each row's one candidate by signature agreement (``count/P``
    in float32 against a float32 ``threshold``; below it, or an invalid
    row, reverts to self), then ``jump_rounds`` rounds of pointer jumping:
    ``int32[B]``."""
    B, P = sig.shape
    dev = sig.device
    idx = torch.arange(B, device=dev)
    r = rep.to(torch.int64)
    s32 = sig.view(torch.int32)
    agree = (s32 == s32[r]).sum(dim=1).to(torch.float32) / P
    ok = (agree >= torch.tensor(threshold, dtype=torch.float32, device=dev)) & valid
    r = torch.where(ok, r, idx)
    for _ in range(jump_rounds):
        r = r[r]
    return r.to(torch.int32)


def bucket_histogram(keys: torch.Tensor, valid: torch.Tensor, *, nbins: int = 1 << 16) -> torch.Tensor:
    """``int32[nbins]`` histogram of the valid rows' band keys modulo
    ``nbins``: the dense summary the sharded step merges with ``psum``."""
    flat = (keys.to(torch.int64) % nbins).reshape(-1)
    w = valid[:, None].expand(keys.shape).reshape(-1).to(torch.int32)
    return torch.zeros((nbins,), dtype=torch.int32, device=keys.device).index_add_(0, flat, w)


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


def strict_bar(base: float, fine_margin: float) -> float:
    """``base + fine_margin`` summed in float32, as the reference sums it."""
    return float(np.float32(base) + np.float32(fine_margin))


def verify_plain(
    rep_bands: torch.Tensor,
    valid: torch.Tensor | None,
    sig: torch.Tensor | None = None,
    *,
    thr: torch.Tensor | None = None,
    base: float = 0.0,
    strict: float | None = None,
    band: float | None = None,
    keys: torch.Tensor | None = None,
    num_coarse: int = 0,
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """Plain version of the ``lsh_verify`` kernel, with its arguments and
    its ``(ok, need, bars)`` (``ops.lsh_cuda.lsh_verify``): the agreement
    ``count/P`` of each (row, candidate) in float32 against a float32 bar,
    in 8-column chunks so the gathered transient stays ``[B, 8, P]``."""
    B, nc = rep_bands.shape
    dev = rep_bands.device

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=dev)

    base_t = f32(base)
    strict_t = None if strict is None else f32(strict)
    if keys is not None:
        chunks = _fine_only_chunks(rep_bands, keys, num_coarse)
    else:
        chunks = ((c0, rep_bands[:, c0 : c0 + 8].to(torch.int64), None)
                  for c0 in range(0, nc, 8))
    if sig is not None:
        s32 = sig.view(torch.int32)
        p_t = f32(float(sig.shape[1]))
    idx = torch.arange(B, device=dev)
    ok_parts, need_parts, bar_parts = [], [], []
    for c0, cand, fine_only in chunks:
        fine_bar = None if strict_t is None else torch.where(fine_only, strict_t, base_t)
        if sig is None:
            bar_parts.append(fine_bar)
            continue
        agree = (s32[:, None, :] == s32[cand]).sum(dim=2).to(torch.float32) / p_t
        if thr is not None:
            bar = thr[..., c0 : c0 + 8]
            bar = bar if bar.ndim == 2 else bar[None, :]
        else:
            bar = base_t if fine_bar is None else fine_bar
        ok = (agree >= bar) & valid[:, None] & valid[cand]
        ok_parts.append(ok)
        if band is not None:
            need_parts.append(ok & (cand != idx[:, None]) & (fine_only | (agree < f32(band))))
    return (
        torch.cat(ok_parts, dim=1) if sig is not None else None,
        torch.cat(need_parts, dim=1) if band is not None else None,
        torch.cat(bar_parts, dim=1) if sig is None else None,
    )


def label_plain(rep_bands, ok, valid, jump_rounds: int) -> torch.Tensor:
    """Plain version of the ``lsh_label`` kernel: connected-component
    minimum labels over the ``ok`` edges, ``int32[B]``.  A round pulls the
    min along the edges from ``x``, scatter-mins it into ``z`` (which starts
    as ``x``: every value written is at most ``x``), and pointer-doubles
    ``z`` into the next ``x`` — no buffer is read while it is written.  A
    round that changes nothing ends the rounds."""
    B, nc = rep_bands.shape
    idx = torch.arange(B, device=rep_bands.device)
    cand = torch.where(ok, rep_bands.to(torch.int64), idx[:, None])
    x = idx
    for _ in range(jump_rounds):
        pulled = torch.minimum(x, x[cand].amin(dim=1)) if nc else x
        # z starts as x and takes every row's pulled min, at itself and at
        # each of its candidates
        z = torch.minimum(x, pulled).scatter_reduce(
            0, cand.reshape(-1), pulled[:, None].expand(B, nc).reshape(-1), "amin",
            include_self=True,
        )
        nxt = z[z]
        if torch.equal(nxt, x):
            break
        x = nxt
    return torch.where(valid, x, idx).to(torch.int32)


def _stages(t: torch.Tensor):
    """``(verify, label)``: the kernels for a tensor on the card, their
    plain versions for a CPU one."""
    if _on_card(t):
        return lsh_cuda.lsh_verify, lsh_cuda.lsh_label
    return verify_plain, label_plain


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
    verify, _ = _stages(rep_bands)
    return verify(_i32(rep_bands), None, base=base, strict=strict_bar(base, fine_margin),
                  keys=keys.contiguous(), num_coarse=num_coarse)[2]


def _bar_kwargs(threshold, B: int, nc: int, dev: torch.device) -> dict:
    """The verify stage's bar from a scalar, ``float32[nc]`` or ``[B, nc]``
    threshold (a 0-d tensor becomes one bar a column)."""
    if isinstance(threshold, torch.Tensor) or np.ndim(threshold):
        thr = torch.as_tensor(threshold, dtype=torch.float32, device=dev)
        thr = thr.expand((nc,) if thr.ndim < 2 else (B, nc))
        return {"thr": thr.contiguous()}
    return {"base": float(threshold)}


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
    verify, label = _stages(sig)
    rb, valid = _i32(rep_bands), valid.contiguous()
    ok = verify(rb, valid, sig.contiguous(), **_bar_kwargs(threshold, B, nc, sig.device))[0]
    return label(rb, ok, valid, jump_rounds)


def resolve_rep_bands_from_ok(
    rep_bands: torch.Tensor, ok: torch.Tensor, valid: torch.Tensor, *, jump_rounds: int
) -> torch.Tensor:
    """:func:`resolve_rep_bands` with the verified-edge matrix ``ok
    bool[B, nc]`` supplied (edited on the host by exact verify, or the
    rerank tier's rewritten cells): ``int32[B]`` component labels."""
    _, label = _stages(rep_bands)
    return label(_i32(rep_bands), ok.contiguous(), valid.contiguous(), jump_rounds)


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
    verify, _ = _stages(sig)
    ok, need, _ = verify(_i32(rep_bands), valid.contiguous(), sig.contiguous(),
                         base=float(base), band=float(band), keys=keys.contiguous(),
                         num_coarse=num_coarse)
    return need, ok


def _maybe_densify(sig: torch.Tensor, densify_oph: bool) -> torch.Tensor:
    """OPH accumulators arrive raw (empty bins ``U32_MAX``), so the
    min-fold stays exact; the epilogues densify once, after it
    (``ops.oph.densify``: the ``oph_densify`` kernel on the card)."""
    if not densify_oph:
        return sig
    from advanced_scrapper_tpu_torch.ops.oph import densify

    return densify(sig)


def _keys_and_candidates(sig: torch.Tensor, valid: torch.Tensor, band_salt, fine_salt):
    """``(keys, rep_bands)``: on the card one ``lsh_keys`` launch writes the
    keys and the packed sort keys, then ``lsh_sort`` and
    ``lsh_run_heads``."""
    bits = row_bits(sig.shape[0])
    valid = valid.contiguous()
    if _on_card(sig):
        keys, packed = lsh_cuda.lsh_keys(sig.contiguous(), band_salt, fine_salt,
                                         valid=valid, bits=bits)
    else:
        keys = keys_plain(sig, band_salt, fine_salt)
        packed = pack_keys_plain(keys, valid, bits)
    return keys, _rep_bands_from_packed(packed, valid, bits)


def fused_candidate_epilogue(
    sig_acc: torch.Tensor, valid: torch.Tensor, band_salt, fine_salt,
    *, densify_oph: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sigs, keys, rep_bands)`` from the signature accumulator: the
    front half of :func:`fused_resolve_epilogue`, for callers that edit
    the candidates between candidacy and resolution (the rerank tier,
    exact verify).  ``sigs`` is the accumulator itself, densified first
    with ``densify_oph``."""
    sig = _maybe_densify(sig_acc, densify_oph)
    keys, rep_bands = _keys_and_candidates(sig, valid, band_salt, fine_salt)
    return sig, keys, rep_bands


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
    densify_oph: bool = False,
) -> torch.Tensor:
    """The whole estimator-only resolution from the signature accumulator:
    (OPH densify) → coarse+fine keys → per-band candidates → (optional)
    per-edge fine bars → verification and component labels.  Returns
    ``int32[B]``.  On the card: ``lsh_keys``, ``lsh_sort``,
    ``lsh_run_heads``, ``lsh_verify`` (the fine bars inline) and
    ``lsh_label``, no library call."""
    sig, keys, rep_bands = fused_candidate_epilogue(
        sig_acc, valid, band_salt, fine_salt, densify_oph=densify_oph
    )
    verify, label = _stages(sig)
    fine = {"strict": strict_bar(base, fine_margin), "keys": keys,
            "num_coarse": num_coarse} if use_fine_margin else {}
    valid = valid.contiguous()
    ok = verify(rep_bands, valid, sig.contiguous(), base=float(base), **fine)[0]
    return label(rep_bands, ok, valid, jump_rounds)


def fused_keys_epilogue(
    sig_acc: torch.Tensor, band_salt, fine_salt, *, densify_oph: bool, wide: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sigs, keys)`` from the signature accumulator, for callers that
    join on the host (the stream backend): ``wide=False`` gives the
    :func:`candidate_keys` coarse + fine keys (``fine_salt`` may be
    empty), ``wide=True`` the :func:`band_keys_wide` lanes (``fine_salt``
    unused).  ``sigs`` is the accumulator itself, densified first with
    ``densify_oph``.  One ``lsh_keys`` launch on the card."""
    sig = _maybe_densify(sig_acc, densify_oph)
    if wide:
        return sig, band_keys_wide(sig, band_salt)
    return sig, _coarse_fine_keys(sig, band_salt, fine_salt)


def keep_mask(rep: torch.Tensor) -> torch.Tensor:
    """True for rows that are their own representative (first seen)."""
    return rep == torch.arange(rep.shape[0], dtype=rep.dtype, device=rep.device)
