"""The CPU MinHash/LSH oracle: the port's copy of the reference's
``cpu/oracle.py``, numpy only.

It re-implements ``datasketch``'s algorithm, which defines the ground
truth of the recall metric (BASELINE.json: recall >= 0.95):

- base hash: the first 4 bytes of SHA1, little-endian (:func:`sha1_hash32`);
- permutations: ``h_i(x) = ((a_i·x + b_i) mod (2^61 - 1)) & 0xFFFFFFFF``
  with ``a61``/``b61`` drawn as datasketch draws them
  (``core.hashing.make_params``);
- signature: the elementwise minimum over the shingle set, 2^32 - 1 when
  there is none;
- LSH: buckets keyed by band tuples (16 bands of 8 rows).

Exact shingle-set Jaccard (:func:`shingle_set`, :func:`jaccard`) is also
the definition the rerank tier's margin re-settle and the one-shot exact
verify hold borderline pairs to: utf-8 with ``errors="replace"``, texts
shorter than k have no shingle, and two empty sets have Jaccard 1.

The certification half: :func:`build_certification_corpus` plants
near-duplicates across the Jaccard knee (:func:`mutate_to_jaccard`),
:func:`oracle_near_dup_pairs` gives the oracle's pair set,
:func:`oracle_reps` its clustering, and :func:`measured_recall` /
:func:`measured_precision` score an engine's representatives against
them.  The same seed gives the reference's corpus byte for byte.
"""

from __future__ import annotations

import hashlib
import struct
from collections import defaultdict
from typing import Sequence

import numpy as np

from advanced_scrapper_tpu_torch.core.hashing import MAX_HASH, MERSENNE_PRIME, MinHashParams


def sha1_hash32(data: bytes) -> int:
    """datasketch's default hash: low 4 bytes of SHA1, little-endian."""
    return struct.unpack("<I", hashlib.sha1(data).digest()[:4])[0]


def shingle_set(text: str | bytes, k: int) -> set[bytes]:
    raw = text.encode("utf-8", errors="replace") if isinstance(text, str) else text
    if len(raw) < k:
        return set()
    return {raw[i : i + k] for i in range(len(raw) - k + 1)}


def jaccard(a: set, b: set) -> float:
    if not a and not b:
        return 1.0
    if not a or not b:
        return 0.0
    return len(a & b) / len(a | b)


def oracle_signature(text: str | bytes, params: MinHashParams) -> np.ndarray:
    """uint64[num_perm] signature, exactly as datasketch.MinHash.update()."""
    hv = np.full(params.num_perm, int(MAX_HASH), dtype=np.uint64)
    for sh in shingle_set(text, params.shingle_k):
        x = np.uint64(sha1_hash32(sh))
        phv = ((params.a61 * x + params.b61) % MERSENNE_PRIME) & MAX_HASH
        hv = np.minimum(hv, phv)
    return hv


def oracle_signatures(texts: Sequence[str | bytes], params: MinHashParams) -> np.ndarray:
    return np.stack([oracle_signature(t, params) for t in texts])


def oracle_signatures_fast(
    texts: Sequence[str | bytes],
    params: MinHashParams,
    *,
    chunk: int = 8192,
    _sha_cache: dict | None = None,
) -> np.ndarray:
    """Vectorised, bit-identical twin of :func:`oracle_signatures`: the
    per-shingle loop becomes numpy over ``[chunk, num_perm]`` tiles, and
    sha1 values are memoised across documents (planted near-dup corpora
    share most shingles with their base documents)."""
    cache: dict[bytes, int] = {} if _sha_cache is None else _sha_cache
    out = np.empty((len(texts), params.num_perm), dtype=np.uint64)
    a = params.a61[None, :]
    b = params.b61[None, :]
    for t_i, text in enumerate(texts):
        shingles = shingle_set(text, params.shingle_k)
        hv = np.full(params.num_perm, int(MAX_HASH), dtype=np.uint64)
        if shingles:
            xs = np.fromiter(
                (
                    cache[sh] if sh in cache else cache.setdefault(sh, sha1_hash32(sh))
                    for sh in shingles
                ),
                dtype=np.uint64,
                count=len(shingles),
            )
            for start in range(0, len(xs), chunk):
                x = xs[start : start + chunk, None]
                phv = ((a * x + b) % MERSENNE_PRIME) & MAX_HASH
                hv = np.minimum(hv, phv.min(axis=0))
        out[t_i] = hv
    return out


def band_tuples(sig: np.ndarray, params: MinHashParams) -> list[tuple]:
    r = params.rows_per_band
    return [tuple(sig[b * r : (b + 1) * r].tolist()) for b in range(params.num_bands)]


def oracle_candidate_pairs(sigs: np.ndarray, params: MinHashParams) -> set[tuple[int, int]]:
    """All (i < j) pairs sharing at least one LSH band bucket."""
    pairs: set[tuple[int, int]] = set()
    r = params.rows_per_band
    for b in range(params.num_bands):
        buckets: dict[tuple, list[int]] = defaultdict(list)
        for i in range(sigs.shape[0]):
            buckets[tuple(sigs[i, b * r : (b + 1) * r].tolist())].append(i)
        for members in buckets.values():
            if len(members) > 1:
                members.sort()
                for x in range(len(members)):
                    for y in range(x + 1, len(members)):
                        pairs.add((members[x], members[y]))
    return pairs


def estimated_jaccard(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
    return float(np.mean(sig_a == sig_b))


def _union_find_min(n: int, pairs) -> np.ndarray:
    """First-seen-wins union-find over ``pairs``: every cluster's root is
    its smallest index."""
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = int(parent[x])
        return x

    for i, j in pairs:
        ri, rj = find(i), find(j)
        if ri != rj:
            lo, hi = (ri, rj) if ri < rj else (rj, ri)
            parent[hi] = lo
    return np.array([find(i) for i in range(n)])


def oracle_dedup_reps(
    texts: Sequence[str | bytes], params: MinHashParams, threshold: float
) -> np.ndarray:
    """First-seen-wins union-find dedup over the candidate pairs whose
    estimated Jaccard clears ``threshold``, in sorted pair order."""
    sigs = oracle_signatures(texts, params)
    edges = (
        (i, j)
        for i, j in sorted(oracle_candidate_pairs(sigs, params))
        if estimated_jaccard(sigs[i], sigs[j]) >= threshold
    )
    return _union_find_min(len(texts), edges).astype(np.int32)


def oracle_near_dup_pairs(
    texts: Sequence[str | bytes],
    params: MinHashParams,
    threshold: float,
    *,
    fast: bool = False,
) -> set[tuple[int, int]]:
    """Candidate pairs whose estimated Jaccard clears ``threshold``: the
    pair set the recall metric is computed against."""
    sigs = (oracle_signatures_fast if fast else oracle_signatures)(texts, params)
    return {
        (i, j)
        for i, j in oracle_candidate_pairs(sigs, params)
        if estimated_jaccard(sigs[i], sigs[j]) >= threshold
    }


def mutate_to_jaccard(rng: np.random.RandomState, text: bytes, target_j: float) -> bytes:
    """A mutant whose k-shingle Jaccard with ``text`` lands near
    ``target_j``: a contiguous span of fraction ``f = (1-j)/(1+j)`` is
    replaced with random bytes, so J ≈ (1-f)/(1+f)."""
    f = (1.0 - target_j) / (1.0 + target_j)
    span = max(1, int(len(text) * f))
    pos = rng.randint(0, max(1, len(text) - span))
    b = bytearray(text)
    b[pos : pos + span] = rng.randint(32, 127, size=span, dtype=np.uint8).tobytes()
    return bytes(b)


def build_certification_corpus(
    rng: np.random.RandomState,
    n_bases: int,
    *,
    min_len: int = 100,
    max_len: int = 20000,
    n_long: int = 12,
    long_len: int = 100_000,
    knee_frac: float = 0.4,
) -> list[bytes]:
    """The recall-certification corpus: ragged lengths (log-uniform
    ``min_len..max_len``, plus ``n_long`` documents of ``long_len``), each
    base with two mutants, a ``knee_frac`` share targeted across the
    Jaccard knee (0.62..0.80) and the rest at 0.85..0.97, shuffled with as
    many unrelated documents."""
    lens = np.exp(rng.uniform(np.log(min_len), np.log(max_len), size=n_bases)).astype(np.int64)
    lens[:n_long] = long_len
    texts: list[bytes] = []
    for i in range(n_bases):
        base = rng.randint(32, 127, size=int(lens[i]), dtype=np.uint8).tobytes()
        texts.append(base)
        for _ in range(2):
            if rng.rand() < knee_frac:
                tj = rng.uniform(0.62, 0.80)
            else:
                tj = rng.uniform(0.85, 0.97)
            texts.append(mutate_to_jaccard(rng, base, tj))
        texts.append(
            rng.randint(32, 127, size=int(lens[rng.randint(n_bases)]), dtype=np.uint8).tobytes()
        )
    order = rng.permutation(len(texts))
    return [texts[i] for i in order]


def oracle_reps(
    texts: Sequence[str | bytes],
    params: MinHashParams,
    threshold: float,
    *,
    fast: bool = False,
    pairs: set[tuple[int, int]] | None = None,
) -> np.ndarray:
    """Cluster representatives from the oracle's own pair set (what
    datasketch plus union-find would keep; every cluster's representative
    is its smallest index): the comparator for an engine's precision.
    ``pairs`` may carry a precomputed :func:`oracle_near_dup_pairs`."""
    if pairs is None:
        pairs = oracle_near_dup_pairs(texts, params, threshold, fast=fast)
    return _union_find_min(len(texts), pairs)


def measured_recall(
    texts: Sequence[str | bytes],
    reps: np.ndarray,
    params: MinHashParams,
    threshold: float,
    *,
    pairs: set[tuple[int, int]] | None = None,
) -> tuple[float, int]:
    """``(recall, n_oracle_pairs)``: the share of the oracle's near-dup
    pairs that ``reps`` puts in one cluster.  ``pairs`` reuses a
    precomputed oracle pair set."""
    if pairs is None:
        pairs = oracle_near_dup_pairs(texts, params, threshold, fast=True)
    if not pairs:
        return 1.0, 0
    hit = sum(1 for i, j in pairs if reps[i] == reps[j])
    return hit / len(pairs), len(pairs)


def measured_precision(
    texts: Sequence[str | bytes],
    reps: np.ndarray,
    shingle_k: int,
    threshold: float,
    *,
    edge_slack: float = 0.10,
) -> tuple[float, int, int]:
    """``(precision, n_engine_pairs, n_unchained)`` over the pairs that
    ``reps`` merged, judged by true shingle-set Jaccard.

    ``precision`` counts merged pairs with true J >= ``threshold``.
    ``n_unchained`` counts cluster members outside the cluster's largest
    component of edges with true J >= ``threshold - edge_slack``: members
    reachable only through weaker edges, false merges (the bar is 0)."""
    clusters: dict[int, list[int]] = defaultdict(list)
    for i, r in enumerate(reps):
        clusters[int(r)].append(i)

    edge_bar = threshold - edge_slack
    n_pairs = good = unchained = 0
    for members in clusters.values():
        m = len(members)
        if m < 2:
            continue
        sets = [shingle_set(texts[i], shingle_k) for i in members]
        jmat = np.ones((m, m))
        for a in range(m):
            for b in range(a + 1, m):
                jmat[a, b] = jmat[b, a] = jaccard(sets[a], sets[b])
        n_pairs += m * (m - 1) // 2
        good += int(np.count_nonzero(np.triu(jmat >= threshold, k=1)))
        strong = jmat >= edge_bar
        unvisited = np.ones(m, bool)
        biggest = 0
        while unvisited.any():
            seed = int(np.flatnonzero(unvisited)[0])
            seen = np.zeros(m, bool)
            seen[seed] = True
            frontier = [seed]
            while frontier:
                nxt = np.flatnonzero(strong[frontier].any(axis=0) & ~seen)
                seen[nxt] = True
                frontier = nxt.tolist()
            biggest = max(biggest, int(seen.sum()))
            unvisited &= ~seen
        unchained += m - biggest
    return (good / n_pairs if n_pairs else 1.0), n_pairs, unchained
