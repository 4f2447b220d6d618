"""Bounded-memory streaming LSH index: per-band Bloom filters.

The port's copy of the reference's ``utils/bloom.py``, host numpy, unchanged
below this paragraph: the stream backend in ``extractors/tpu_batch.py``
uses it in bloom mode, and a checkpoint's bit-planes cross between the two
packages as they are.  Module names below are the reference's.

The default streaming index (``extractors/tpu_batch.py``) stores every kept
document's signature and 16 band keys on the host — ~1 KB per kept document,
unbounded over an unbounded stream (the reference's live pollers,
``experiental/04..10``, run forever).  The LSHBloom construction (Khan et
al., arXiv:2411.04257) replaces the key→doc dict with one Bloom filter per
LSH band: membership of a band key marks a near-duplicate, memory is fixed
at ``num_bands × bits/8`` bytes forever, and the false-positive rate is set
by the filter sizing instead of growing with the corpus.

Trade-offs vs the exact index (both are first-class; pick per workload):

- **no attribution** — a Bloom hit says "a previously seen document shared
  this band", not *which* one, and no stored signature exists to verify
  agreement against.  The false-drop rate has TWO terms: the filter term
  — per band ``ε_band = (1 - e^(-k·n/m))^k``, per ROW (any of ``nb``
  bands hitting) ``ε_row = 1 - (1 - ε_band)^nb ≈ nb·ε_band`` — **and the
  band-key collision rate** ``ε_key ≈ n·num_bands/2^bits(key)`` —
  unverifiable here precisely because nothing is stored.  With 32-bit
  keys ε_key dominates (~4% of unique docs silently dropped at 10M); this
  index therefore expects **uint64 keys** (``ops.lsh.band_keys_wide`` +
  :func:`pack_keys64`), where ε_key ≈ 1e-11 at 10M and the filter term
  dominates.  uint32 keys are still accepted for small/bounded streams.
- **capacity is a sizing decision, not a free lunch** — a Bloom filter
  saturates: at the default 2²⁴ bits/band (k=4, 16 bands, 32 MiB total)
  the MEASURED row false-drop rate is ~3e-3 at 500k kept docs, ~28% at
  2M, and ~100% by 10M (saturated filters) — measured by
  ``tools/soak_bloom.py`` (numbers in DESIGN.md), tracking the formula
  above to within a few % at every checkpoint.  For a target stream size use
  :meth:`BloomBandIndex.for_capacity`, which inverts the formula
  (e.g. 10M kept docs at ε_row ≤ 1e-3 → 2²⁹ bits/band, 1 GiB total).
  :meth:`fill_ratio` is the runtime saturation gauge; the streaming
  backend warns once :meth:`predicted_row_fp` crosses 1% (rate-keyed —
  at the defaults 50% bit fill would already be ~64% false drops).
- **bounded memory** — fixed at construction (32 MiB at defaults), forever.
- **mergeable** — Bloom filters combine with bitwise OR, so per-shard /
  per-host indexes union exactly (the collective analogue of the band-key
  ``psum`` merge in ``parallel/sharded.py``).

Within a batch the filter alone cannot order insertions, so the batch probe
uses *true key equality* intra-batch (first-seen wins, exactly) and the
filters only across batches — stream semantics match the exact index.
"""

from __future__ import annotations

import hashlib

import numpy as np

_MIX_A = np.uint64(0xBF58476D1CE4E5B9)
_MIX_B = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * _MIX_A) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * _MIX_B) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


def pack_keys64(wide: np.ndarray) -> np.ndarray:
    """``uint32[..., 2]`` (``ops.lsh.band_keys_wide`` layout) → ``uint64[...]``.

    TPUs have no native uint64, so the two 32-bit lanes are computed on
    device and packed here on host."""
    wide = np.asarray(wide)
    if wide.shape[-1] != 2:
        raise ValueError(f"expected trailing lane dim of 2, got {wide.shape}")
    lo = wide[..., 0].astype(np.uint64)
    hi = wide[..., 1].astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def hash_key64(key: str | bytes) -> int:
    """Stable 64-bit hash of a record key (url) — the exact-dup filter's
    key path.  blake2b-8: keyed-collision rate ~n/2⁶⁴ vs crc32's n/2³²."""
    data = key if isinstance(key, bytes) else key.encode("utf-8", "replace")
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


class BloomBandIndex:
    """One Bloom filter per LSH band over uint64 (preferred) or uint32 keys.

    ``bits`` must be a power of two.  All batch operations are vectorised
    numpy; nothing grows with the stream.
    """

    def __init__(
        self,
        num_bands: int,
        *,
        bits: int = 1 << 24,
        num_hashes: int = 4,
        seed: int = 0,
    ):
        if bits & (bits - 1):
            raise ValueError(f"bits must be a power of two, got {bits}")
        self.num_bands = num_bands
        self.bits = bits
        self.num_hashes = num_hashes
        self.seed = seed
        self._words = np.zeros((num_bands, bits // 64), dtype=np.uint64)
        self.inserted = 0
        # key width is pinned by the FIRST batch: a uint32 key and the same
        # band content's uint64 key hash to different positions, so mixing
        # widths silently corrupts membership — fail loudly instead
        self.key_bits: int | None = None

    @classmethod
    def for_capacity(
        cls,
        capacity: int,
        *,
        num_bands: int = 16,
        row_fp: float = 1e-3,
        num_hashes: int = 4,
        seed: int = 0,
    ) -> "BloomBandIndex":
        """Size the filters for ``capacity`` kept documents at a row-level
        false-drop rate ≤ ``row_fp`` (inverts the saturation math in the
        module docstring — measured to track it in ``tools/soak_bloom.py``).

        Sizing, not magic: 10M docs at ε_row ≤ 1e-3 costs 2²⁹ bits/band
        (1 GiB for 16 bands).  Memory stays fixed at that size forever.
        """
        import math

        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if not 0 < row_fp < 1:
            raise ValueError("row_fp must be in (0, 1)")
        eps_band = 1.0 - (1.0 - row_fp) ** (1.0 / num_bands)
        k = num_hashes
        denom = -math.log(1.0 - eps_band ** (1.0 / k))
        bits = 1 << max(10, math.ceil(math.log2(k * capacity / denom)))
        return cls(num_bands, bits=bits, num_hashes=num_hashes, seed=seed)

    def predicted_row_fp(self, n: int | None = None) -> float:
        """Formula row-level false-drop rate after ``n`` insertions
        (default: what this index has actually inserted)."""
        import math

        n = self.inserted if n is None else n
        eps_band = (1.0 - math.exp(-self.num_hashes * n / self.bits)) ** (
            self.num_hashes
        )
        return 1.0 - (1.0 - eps_band) ** self.num_bands

    # -- core --------------------------------------------------------------

    def _check_width(self, keys: np.ndarray) -> None:
        w = 64 if keys.dtype == np.uint64 else 32
        if self.key_bits is None:
            self.key_bits = w
        elif self.key_bits != w:
            raise ValueError(
                f"index was keyed with {self.key_bits}-bit keys; got "
                f"{keys.dtype} — mixed widths never match each other"
            )

    def _positions(self, keys: np.ndarray) -> np.ndarray:
        """uint64[B, nb, k] bit positions for ``uint{32,64}[B, nb]`` keys."""
        B, nb = keys.shape
        # full-width per-band tweak (splitmix of band index) so 64-bit key
        # entropy survives the band separation; a shifted-constant XOR would
        # collide with the key's high lane
        band_tweak = _splitmix64(
            np.arange(nb, dtype=np.uint64) + np.uint64(self.seed + 1)
        )
        base = keys.astype(np.uint64) ^ band_tweak[None, :]
        hs = np.stack(
            [
                _splitmix64(base + (np.uint64(h) << np.uint64(56)))
                for h in range(self.num_hashes)
            ],
            axis=-1,
        )
        return hs & np.uint64(self.bits - 1)

    def contains_batch(self, keys: np.ndarray) -> np.ndarray:
        """bool[B]: any band of the row fully present in that band's filter."""
        keys = np.asarray(keys)
        self._check_width(keys)
        pos = self._positions(keys)
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        nb = self.num_bands
        band_ix = np.arange(nb)[None, :, None]
        present = (self._words[band_ix, word] & bit) != 0
        return present.all(axis=2).any(axis=1)

    def add_batch(self, keys: np.ndarray, mask: np.ndarray | None = None) -> None:
        """Insert rows (optionally only where ``mask``) into every band filter."""
        keys = np.asarray(keys)
        self._check_width(keys)
        if mask is not None:
            keys = keys[np.asarray(mask, dtype=bool)]
        if keys.size == 0:
            return
        pos = self._positions(keys)
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        band_ix = np.broadcast_to(
            np.arange(self.num_bands)[None, :, None], word.shape
        )
        np.bitwise_or.at(self._words, (band_ix.ravel(), word.ravel()), bit.ravel())
        self.inserted += keys.shape[0]

    def check_and_add_batch(self, keys: np.ndarray) -> np.ndarray:
        """Stream step: ``dup[B]`` per row, then insert the non-dup rows.

        Cross-batch membership via the filters; intra-batch via true key
        equality (vectorised first-occurrence per band) — so a batch of
        identical documents yields one kept row, like the exact index.
        Intra-batch matching is against *any* earlier row sharing the band
        key, including rows themselves marked duplicate — marginally more
        conservative than the exact index (which only matches kept rows);
        a Bloom index cannot attribute representatives anyway.
        """
        keys = np.asarray(keys)
        dup = self.contains_batch(keys)
        B, nb = keys.shape
        rows = np.arange(B)
        for b in range(nb):
            _, first_ix, inverse = np.unique(
                keys[:, b], return_index=True, return_inverse=True
            )
            dup |= first_ix[inverse] < rows
        self.add_batch(keys, mask=~dup)
        return dup

    # -- distribution ------------------------------------------------------

    def merge(self, other: "BloomBandIndex") -> None:
        """Exact union: bitwise OR (the cross-shard/cross-host merge)."""
        if (self.bits, self.num_bands, self.num_hashes, self.seed) != (
            other.bits,
            other.num_bands,
            other.num_hashes,
            other.seed,
        ):
            raise ValueError("cannot merge differently-configured indexes")
        if (
            self.key_bits is not None
            and other.key_bits is not None
            and self.key_bits != other.key_bits
        ):
            raise ValueError(
                f"cannot merge a {self.key_bits}-bit-keyed index with a "
                f"{other.key_bits}-bit one — their keys never match"
            )
        if self.key_bits is None:
            self.key_bits = other.key_bits
        np.bitwise_or(self._words, other._words, out=self._words)
        self.inserted += other.inserted

    def state(self) -> dict:
        """Arrays/scalars that fully reconstruct membership — for
        checkpointing the stream index across process restarts."""
        return {
            "words": self._words,
            "inserted": np.int64(self.inserted),
            "key_bits": np.int64(self.key_bits if self.key_bits is not None else -1),
        }

    def restore(self, words: np.ndarray, inserted: int, key_bits: int) -> None:
        """Inverse of :meth:`state`; the index must be constructed with the
        same (num_bands, bits, num_hashes, seed) — hash positions depend on
        all four, so mismatched params would corrupt membership silently."""
        if words.shape != self._words.shape or words.dtype != np.uint64:
            raise ValueError(
                f"checkpoint shape {words.shape}/{words.dtype} does not match "
                f"this index ({self._words.shape}); was it saved with the "
                "same bits/num_bands config?"
            )
        self._words[...] = words
        self.inserted = int(inserted)
        self.key_bits = None if int(key_bits) < 0 else int(key_bits)

    @property
    def memory_bytes(self) -> int:
        return self._words.nbytes

    def fill_ratio(self) -> float:
        """Fraction of set bits (FP rate grows as this approaches 1)."""
        return float(np.unpackbits(self._words.view(np.uint8)).mean())
