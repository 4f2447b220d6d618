"""Hash-family parameters for the MinHash kernel (numpy only).

A copy of the reference's ``core/hashing.py``: the device family
``a32/b32`` (32-bit multiply-add permutations ``a·x + b mod 2³²``, odd
``a``), the LSH ``band_salt`` and the datasketch oracle family
``a61/b61`` are drawn from the same ``RandomState`` streams, so a seed
gives the port exactly the reference's arrays (pinned by
``tests/test_torch_hashing.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MERSENNE_PRIME = np.uint64((1 << 61) - 1)
MAX_HASH = np.uint64((1 << 32) - 1)


@dataclass(frozen=True)
class MinHashParams:
    num_perm: int
    num_bands: int
    shingle_k: int
    seed: int
    a32: np.ndarray  # uint32[num_perm], odd
    b32: np.ndarray  # uint32[num_perm]
    band_salt: np.ndarray  # uint32[num_bands]
    a61: np.ndarray  # uint64[num_perm] in [1, p)
    b61: np.ndarray  # uint64[num_perm] in [0, p)

    @property
    def rows_per_band(self) -> int:
        return self.num_perm // self.num_bands


def make_params(
    num_perm: int = 128,
    num_bands: int = 16,
    shingle_k: int = 5,
    seed: int = 1,
) -> MinHashParams:
    if num_perm % num_bands:
        raise ValueError(f"num_perm {num_perm} not divisible by bands {num_bands}")
    # Oracle family: datasketch's generator — interleaved (a_i, b_i) draws.
    gen = np.random.RandomState(seed)
    pairs = [
        (
            gen.randint(1, int(MERSENNE_PRIME), dtype=np.uint64),
            gen.randint(0, int(MERSENNE_PRIME), dtype=np.uint64),
        )
        for _ in range(num_perm)
    ]
    a61 = np.array([p[0] for p in pairs], dtype=np.uint64)
    b61 = np.array([p[1] for p in pairs], dtype=np.uint64)
    # Device family: an independent stream, uncorrelated with the oracle's.
    gen32 = np.random.RandomState((seed + 0x5F3759DF) % (1 << 31))
    a32 = (gen32.randint(0, 1 << 32, size=num_perm, dtype=np.uint64) | 1).astype(
        np.uint32
    )
    b32 = gen32.randint(0, 1 << 32, size=num_perm, dtype=np.uint64).astype(np.uint32)
    band_salt = gen32.randint(1, 1 << 32, size=num_bands, dtype=np.uint64).astype(
        np.uint32
    )
    return MinHashParams(
        num_perm=num_perm,
        num_bands=num_bands,
        shingle_k=shingle_k,
        seed=seed,
        a32=a32,
        b32=b32,
        band_salt=band_salt,
        a61=a61,
        b61=b61,
    )


def gram_hashes_np(raw: bytes, q: int) -> np.ndarray:
    """numpy mirror of ``ops.shingle.shingle_hash``: uint32[len(raw)-q+1]
    (empty when the text is shorter than q)."""
    if len(raw) < q:
        return np.zeros((0,), np.uint32)
    b = np.frombuffer(raw, dtype=np.uint8).astype(np.uint32)
    n = len(raw) - q + 1
    h = np.full(n, 0x811C9DC5, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for j in range(q):
            h = (h ^ b[j : j + n]) * np.uint32(0x01000193)
    return fmix32_np(h)


def fmix32_np(h: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finaliser (numpy mirror of ``ops.shingle.fmix32``)."""
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)) & MAX_HASH.astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)) & MAX_HASH.astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h
