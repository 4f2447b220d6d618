"""Pair settlement for the rerank (precision) tier.

Counterpart of the reference's ``ops/rerank.py``, in two halves:

- the **host half**, numpy, copied from the reference with its iteration
  and float summation orders, because they decide which pairs are
  proposed and which cluster member is evicted: bottom-S shingle sketches
  (:func:`bottom_sketch`), the host sketch estimator, coarse band-bucket
  candidacy (:func:`coarse_pairs`), union-find, the recall weight
  (:func:`op_weight`), the precision-targeted eviction walk
  (:func:`evict_for_precision`), the candidate-matrix rewrite and
  :func:`band_keys_wide_host`, the wide band keys of the tier's index
  re-probe;
- the **settle**, ``jq int32[m]``: the quantized bottom-sketch Jaccard of
  each pair ``(sk[ia], sk[ib])``, bit-equal to the reference's ``_pair_jq``
  under ``vmap`` (:func:`pair_jq_plain`), and its verdict against the
  margin band (:func:`rerank_finalize`, the reference's
  ``make_rerank_finalize``).  The CUDA kernel ``rerank_settle``
  (``csrc/rerank.cu``, ``ops/rerank_cuda.py``) computes both in one launch
  on the card; :func:`settle_plain` is its plain PyTorch version.  The
  reference packs and copies both sketches of every pair; here each
  participating document's sketch is one row of ``sk``, and pairs address
  rows by index.

Jaccard crosses as ``round(J · SCALE)`` in integers (round half up, and
empty ∪ empty ⇒ ``SCALE``), so every verdict is exact.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops.rerank_cuda import check_band, check_pairs
from advanced_scrapper_tpu_torch.core.hashing import fmix32_np
from advanced_scrapper_tpu_torch.ops.lsh import WIDE_OFFSET, WIDE_PRIME
from advanced_scrapper_tpu_torch.ops.shingle import FNV_OFFSET, FNV_PRIME, U32_MASK

#: sketch padding sentinel: sorts after every real 32-bit hash, and real
#: hashes equal to it are dropped at build time so it is unambiguous
PAD = np.uint32(0xFFFFFFFF)

#: Jaccard quantization grid: verdicts are ``round(J * SCALE)``
SCALE = 10_000

#: pairs per batch of the plain settle: the batch's sorted ``int64[·, 2S]``
#: concatenation is its largest intermediate (32 MiB at S = 1,024)
PLAIN_PAIRS = 2048

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def quantize(j: float) -> int:
    """Host twin of the device quantization: ``round(j * SCALE)``."""
    return int(round(float(j) * SCALE))


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finaliser over uint64: shingle ids → uniform hashes."""
    x = np.asarray(x, np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return x ^ (x >> np.uint64(31))


# -- bottom-S sketches ------------------------------------------------------


def bottom_sketch(text: str | bytes, k: int, size: int) -> np.ndarray:
    """``uint32[size]`` bottom-``size`` sketch of the k-byte shingle set,
    ascending, its live hashes unique and then ``PAD``.

    Shingles as ``cpu.oracle.shingle_set`` (utf-8 ``errors="replace"``,
    ``len < k`` → empty set → all-PAD sketch).  Ids are exact for
    ``k ≤ 8`` (bytes packed into uint64); longer shingles fold the tail
    bytes FNV-style."""
    raw = (
        text.encode("utf-8", errors="replace")
        if isinstance(text, str)
        else bytes(text)
    )
    out = np.full((size,), PAD, np.uint32)
    if len(raw) < k:
        return out
    b = np.frombuffer(raw, np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(b, k)
    ids = np.zeros(win.shape[0], np.uint64)
    for j in range(min(k, 8)):
        ids |= win[:, j].astype(np.uint64) << np.uint64(8 * j)
    for j in range(8, k):
        ids = ((ids * np.uint64(0x100000001B3)) & _M64) ^ win[:, j].astype(
            np.uint64
        )
    h = (_mix64(np.unique(ids)) >> np.uint64(32)).astype(np.uint32)
    h = np.unique(h)
    h = h[h != PAD]
    m = min(size, h.size)
    out[:m] = h[:m]
    return out


def bottom_sketches(texts, k: int, size: int, *, skip=None, out=None) -> np.ndarray:
    """``uint32[n, size]`` stacked :func:`bottom_sketch` per document.
    ``skip`` (bool[n]) rows stay all-PAD without touching the text; ``out``
    (``uint32[n, size]``, e.g. a view of pinned memory) receives the rows
    in place."""
    n = len(texts)
    if out is None:
        out = np.empty((n, size), np.uint32)
    out[:] = PAD
    for i in range(n):
        if skip is not None and skip[i]:
            continue
        out[i] = bottom_sketch(texts[i], k, size)
    return out


def sketch_jaccard(ska: np.ndarray, skb: np.ndarray) -> float:
    """Host estimator, the settle's float twin: ``quantize`` of it is the
    settle's verdict."""
    size = int(ska.shape[0])
    a = ska[ska != PAD]
    b = skb[skb != PAD]
    if a.size == 0 and b.size == 0:
        return 1.0
    uni = np.union1d(a, b)
    kk = min(size, uni.size)
    if kk == 0:
        return 1.0
    inter = np.intersect1d(a, b)
    matches = int(np.isin(uni[:kk], inter, assume_unique=True).sum())
    return matches / kk


# -- the settle --------------------------------------------------------------


def pair_jq_plain(sk: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
    """Plain version of the settle kernel: ``int32[m]`` quantized
    bottom-sketch Jaccard of the pairs ``(sk[ia], sk[ib])`` of
    ``sk uint32[n_sk, S]`` rows.

    The reference's sorted-concatenation form: a value seen twice is in
    both sketches, and the union's bottom ``kk = min(n_uni, S)`` are the
    first ``kk`` distinct values.  Values are ``int64`` (``PAD`` still
    sorts last; the CPU has no ``uint32`` sort), ``PLAIN_PAIRS`` pairs at
    a time."""
    check_pairs(sk, ia, ib)
    size = sk.shape[1]
    dev = sk.device
    s32 = sk.view(torch.int32)
    ia, ib = ia.to(dev, torch.int64), ib.to(dev, torch.int64)
    pad = int(PAD)
    out = torch.empty((ia.numel(),), dtype=torch.int32, device=dev)
    for lo in range(0, ia.numel(), PLAIN_PAIRS):
        a, b = (s32[x[lo : lo + PLAIN_PAIRS]].to(torch.int64) & U32_MASK for x in (ia, ib))
        c = torch.cat([a, b], dim=1).sort(dim=1).values
        live = c != pad
        nxt = torch.cat([c[:, 1:], torch.full_like(c[:, :1], pad)], dim=1)
        dup = (c == nxt) & live
        first = torch.cat([live[:, :1], (c[:, 1:] != c[:, :-1]) & live[:, 1:]], dim=1)
        rank = torch.cumsum(first, dim=1) - 1
        kk = torch.clamp(first.sum(dim=1), max=size)
        matches = (dup & (rank < kk[:, None])).sum(dim=1)
        jq = torch.where(
            kk > 0, (SCALE * matches + kk // 2) // torch.clamp(kk, min=1), SCALE
        )
        out[lo : lo + PLAIN_PAIRS] = jq.to(torch.int32)
    return out


def rerank_finalize(jq: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``int8`` verdict per pair: 1 keep (``jq ≥ hi``), 0 kill
    (``jq < lo``), -1 borderline, re-settled on the host."""
    border = (jq >= lo) & (jq < hi)
    return torch.where(border, -1, (jq >= hi).to(torch.int8))


def settle_plain(
    sk: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor, lo: int, hi: int
) -> torch.Tensor:
    """Plain version of the settle kernel ``rerank_settle``: ``int32[2, m]``,
    :func:`pair_jq_plain` of the pairs over their :func:`rerank_finalize`
    verdicts against the margin band ``[lo, hi)``."""
    check_band(lo, hi)
    jq = pair_jq_plain(sk, ia, ib)
    return torch.stack([jq, rerank_finalize(jq, lo, hi).to(torch.int32)])


# -- host candidacy / clustering / eviction policy -------------------------


def coarse_pairs(
    sigs: np.ndarray,
    valid: np.ndarray,
    num_bands: int,
    *,
    bucket_allpairs: int = 64,
) -> tuple[set, int]:
    """Datasketch-class candidate pairs from coarse LSH band buckets.

    Groups the ``num_bands`` band slices of ``sigs[:n]`` (host array,
    any integer dtype) by a mixed bucket key; every bucket of valid rows
    yields all ``(i < j)`` pairs up to ``bucket_allpairs`` members, and
    a star+chain (first-seen hub plus adjacent links, 2(m−1) pairs)
    above it, which keeps connectivity under union-find.  Returns
    ``(pairs, n_capped_buckets)``; mixing can only merge buckets, so
    candidacy is a superset of the oracle's."""
    n = sigs.shape[0]
    r = sigs.shape[1] // num_bands
    pairs: set = set()
    capped = 0
    vidx = np.flatnonzero(np.asarray(valid[:n], bool))
    if vidx.size < 2:
        return pairs, capped
    sig = np.ascontiguousarray(sigs[vidx], np.uint64)
    for b in range(num_bands):
        key = np.full(vidx.size, np.uint64(b), np.uint64)
        for c in range(b * r, (b + 1) * r):
            key = _mix64(key ^ sig[:, c])
        order = np.argsort(key, kind="stable")
        sk = key[order]
        starts = np.flatnonzero(
            np.concatenate([[True], sk[1:] != sk[:-1]])
        )
        ends = np.concatenate([starts[1:], [sk.size]])
        multi = ends - starts >= 2  # a singleton bucket yields no pair
        for s, e in zip(starts[multi].tolist(), ends[multi].tolist()):
            members = np.sort(vidx[order[s:e]]).tolist()
            m = len(members)
            if m <= bucket_allpairs:
                for x in range(m):
                    for y in range(x + 1, m):
                        pairs.add((members[x], members[y]))
            else:
                capped += 1
                hub = members[0]
                for x in range(1, m):
                    pairs.add((hub, members[x]))
                    if x + 1 < m:
                        pairs.add((members[x], members[x + 1]))
    return pairs, capped


def signature_agreement(sigs: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """``float64[m]`` lane-agreement estimator per ``(i, j)`` pair row."""
    if pairs.shape[0] == 0:
        return np.zeros((0,), np.float64)
    return (sigs[pairs[:, 0]] == sigs[pairs[:, 1]]).mean(axis=1)


def union_find(n: int, edges) -> np.ndarray:
    """``int32[n]`` min-root component labels over undirected ``edges``."""
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, j in edges:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            if ri > rj:
                ri, rj = rj, ri
            parent[rj] = ri
    return np.array([find(i) for i in range(n)], np.int32)


def op_weight(jhat: float, lanes: int, threshold: float = 0.7) -> float:
    """Recall weight of a pair: the probability that a fresh ``lanes``-lane
    MinHash agreement draw at true Jaccard ≈ ``jhat`` lands at or above
    ``threshold``, by the normal approximation
    ``Φ((jhat − threshold) / sqrt(jhat(1−jhat)/lanes))``."""
    j = min(max(jhat, 0.02), 0.98)
    sigma = math.sqrt(j * (1.0 - j) / max(lanes, 1))
    return 0.5 * (1.0 + math.erf((jhat - threshold) / (sigma * math.sqrt(2.0))))


def evict_for_precision(
    clusters: dict,
    pairinfo: dict,
    target: float,
    *,
    recall_floor: float = 0.0,
    total_op_mass: float = 0.0,
) -> tuple[set, float]:
    """Greedy precision-targeted member eviction over settled clusters.

    ``clusters`` maps root → member list (size > 1); ``pairinfo`` maps
    each within-cluster ``(a < b)`` pair to ``(bad, w)``: ``bad`` the
    settled verdict (a false merge), ``w`` its recall weight
    (:func:`op_weight`).  Members go one at a time, highest
    ``bad/(1+op_mass)`` first (ties: most recall-free bad pairs, then most
    bad pairs; then the first found in dict order), only from clusters
    with ≥3 live members, until the predicted merged-pair precision
    reaches ``target``.  ``recall_floor`` with ``total_op_mass`` stops the
    walk before live recall mass over the total would cross below the
    floor.  Returns ``(evicted member set, predicted precision)``."""
    memb: dict = {}
    good = bad = 0
    op_live = 0.0
    for (a, b), (is_bad, w) in pairinfo.items():
        good += not is_bad
        bad += is_bad
        op_live += w
        for d in (a, b):
            s = memb.setdefault(d, [0, 0.0, 0])  # bad, op_mass, badfree
            s[0] += is_bad
            s[1] += w
            s[2] += is_bad and w < 0.25
    evicted: set = set()

    def prec() -> float:
        return good / max(good + bad, 1)

    while bad and prec() < target:
        best = None
        for r, m in clusters.items():
            live = [d for d in m if d not in evicted]
            if len(live) < 3:
                continue
            for d in live:
                b_, o_, bf_ = memb.get(d, (0, 0.0, 0))
                if b_ == 0:
                    continue
                score = (b_ / (1.0 + o_), bf_, b_)
                if best is None or score > best[0]:
                    best = (score, d, r)
        if best is None:
            break
        _, d, r = best
        if total_op_mass and recall_floor:
            lost = memb.get(d, (0, 0.0, 0))[1]
            if (op_live - lost) / max(total_op_mass, 1e-9) < recall_floor:
                break
        evicted.add(d)
        for x in clusters[r]:
            if x in evicted or x == d:
                continue
            key = (d, x) if d < x else (x, d)
            is_bad, w = pairinfo[key]
            good -= not is_bad
            bad -= is_bad
            op_live -= w
            s = memb[x]
            s[0] -= is_bad
            s[1] -= w
            s[2] -= is_bad and w < 0.25
        memb[d] = [0, 0.0, 0]
    return evicted, prec()


def rewrite_rep_bands(n_bucket: int, nc: int, edges) -> tuple[np.ndarray, int]:
    """``int32[n_bucket, nc]`` candidate matrix holding exactly ``edges``:
    all-self baseline, each edge ``(i, j)`` on its later row (``max``'s
    row gets the ``min``).  Rows overflowing ``nc`` drop their largest-j
    edges, counted in the second element."""
    rb = np.tile(np.arange(n_bucket, dtype=np.int32)[:, None], (1, nc))
    fill = np.zeros(n_bucket, np.int32)
    dropped = 0
    for a, b in sorted(
        (max(int(a), int(b)), min(int(a), int(b))) for a, b in edges
    ):
        c = fill[a]
        if c >= nc:
            dropped += 1
            continue
        rb[a, c] = b
        fill[a] = c + 1
    return rb, dropped


# -- host twin of the wide band keys (the index re-probe key space) --------


def band_keys_wide_host(sigs: np.ndarray, band_salt: np.ndarray) -> np.ndarray:
    """``uint32[B, nb, 2]``: the numpy twin of ``ops.lsh.band_keys_wide``
    (the same FNV-1a fold, wide-lane constants and rotated salt), so the
    tier's borderline re-probe addresses the persistent index's posting
    keys without a device step."""
    sig = np.asarray(sigs, np.uint32)
    salt = np.asarray(band_salt, np.uint32)
    nb = salt.shape[0]
    B, P = sig.shape
    r = P // nb
    rows = sig.reshape(B, nb, r)
    lo = np.full((B, nb), FNV_OFFSET, np.uint32)
    hi = np.full((B, nb), WIDE_OFFSET, np.uint32)
    with np.errstate(over="ignore"):
        for j in range(r):
            lo = (lo ^ rows[:, :, j]) * np.uint32(FNV_PRIME)
            hi = (hi ^ rows[:, :, j]) * np.uint32(WIDE_PRIME)
    rot = (salt << np.uint32(13)) | (salt >> np.uint32(19))
    return np.stack(
        [fmix32_np(lo ^ salt[None, :]), fmix32_np(hi ^ rot[None, :])], axis=-1
    )
