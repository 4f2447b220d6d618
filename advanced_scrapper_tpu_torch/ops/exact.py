"""Exact 128-bit row hashing for the grouping path of ``ExactDedup``.

Counterpart of the reference's ``ops/exact.py``, bit-equal to it.  Each row
gets four independent 32-bit linear hashes ``h = fmix32((Σ c_i·x_i mod
2³²) ⊕ fmix32(len·0x9E3779B9) ⊕ lane·0x85EBCA77)``: a dot product of the
row's bytes with a seeded coefficient stream per lane.  The reference
leaves the dot product to XLA (``_row_hash_impl``, ``_block_hash_impl``);
here it is plain PyTorch on the hasher's device, carried in ``int64``: a
product is below 2⁴⁰ and a sum of 4,096 of them below 2⁵², so nothing
overflows before the mask to 32 bits after each block sum and after the
segment sum.  Rows go in chunks, so the ``[rows, block]`` transient of a
lane stays bounded.  Zero padding adds nothing, and the length is mixed
in so ``"ab"`` and ``"ab\\x00"`` differ.

The coefficient stream is prefix-consistent (``_coef(L)`` is a prefix of
``_coef(L')``), so a document's hash does not depend on the block length
it was cut at; the port needs none of the reference's shape buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_scrapper_tpu_torch import resolve_device
from advanced_scrapper_tpu_torch.ops.shingle import U32_MASK, fmix32, to_u32

_N_LANES = 4

#: Hard ceiling for a blockwise-hashed document (4 MiB): the coefficient
#: stream costs ~16 bytes per byte of the longest document, so one huge
#: item fails loudly instead of exhausting memory.
MAX_DOC_LEN = 1 << 22

#: Most token elements (rows × block) multiplied at once, a lane at a time.
CHUNK_ELEMS = 1 << 22


def _lane_salt(device: torch.device) -> torch.Tensor:
    return (torch.arange(_N_LANES, dtype=torch.int64, device=device) * 0x85EBCA77) & U32_MASK


def _length_mix(lengths: torch.Tensor) -> torch.Tensor:
    return fmix32((lengths.to(torch.int64) * 0x9E3779B9) & U32_MASK)


def _dots(t: torch.Tensor, coef_blocks: torch.Tensor, pos: torch.Tensor | None) -> torch.Tensor:
    """``int64[N, 4]`` dot products mod 2³² of the rows of ``t uint8[N, L]``
    with their coefficients ``coef_blocks[pos[row]] int64[4, L]`` (the one
    row ``coef_blocks[0]`` for every row when ``pos`` is None), in chunks
    of ``CHUNK_ELEMS`` elements, a lane at a time."""
    n, width = t.shape
    out = torch.zeros((n, _N_LANES), dtype=torch.int64, device=t.device)
    rows = max(1, CHUNK_ELEMS // max(width, 1))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        tr = t[r0:r1].to(torch.int64)
        for lane in range(_N_LANES):
            c = coef_blocks[0, lane][None, :] if pos is None else coef_blocks[pos[r0:r1], lane]
            out[r0:r1, lane] = (tr * c).sum(dim=1) & U32_MASK
    return out


def _row_hash_impl(tokens: torch.Tensor, lengths: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """``uint8[B, L]`` rows, their lengths and ``int64[4, L]`` coefficients
    → ``int64[B, 4]`` hashes in ``[0, 2³²)``."""
    dots = _dots(tokens, coef[None], None)
    salt = _lane_salt(tokens.device)
    return fmix32(dots ^ _length_mix(lengths)[:, None] ^ salt[None, :])


def _block_hash_impl(
    tokens: torch.Tensor,
    block_pos: torch.Tensor,
    owners: torch.Tensor,
    doc_lengths: torch.Tensor,
    coef_blocks: torch.Tensor,
    *,
    num_docs: int,
) -> torch.Tensor:
    """Blockwise hash: each block's dot with the coefficients of its
    position ``coef_blocks[block_pos] int64[N, 4, BL]``, summed per owner
    (``index_add_``), then length-mixed → ``int64[num_docs, 4]``."""
    dots = _dots(tokens, coef_blocks, block_pos.to(torch.int64))
    total = torch.zeros((num_docs, _N_LANES), dtype=torch.int64, device=tokens.device)
    total.index_add_(0, owners.to(torch.int64), dots)
    total &= U32_MASK
    salt = _lane_salt(tokens.device)
    return fmix32(total ^ _length_mix(doc_lengths)[:, None] ^ salt[None, :])


class ExactHasher:
    """Seeded 128-bit row hasher on ``device`` (``None``: the card, raising
    without one; ``"cpu"``: plain PyTorch on the host)."""

    def __init__(self, seed: int = 0xA5C3, device: str | torch.device | None = None):
        self._seed = seed
        self.device = resolve_device(device)
        self._stream = np.zeros((_N_LANES, 0), dtype=np.uint32)

    def _coef(self, L: int) -> np.ndarray:
        # one per-lane stream, made lazily: coef(L) is always a prefix of
        # coef(L'), so the same bytes hash the same at any padded length
        if self._stream.shape[1] < L:
            cols = []
            for lane in range(_N_LANES):
                gen = np.random.RandomState((self._seed * 7919 + lane) % (1 << 31))
                cols.append(
                    gen.randint(0, 1 << 32, size=L, dtype=np.uint64).astype(np.uint32)
                )
            self._stream = np.stack(cols)
        return self._stream[:, :L]

    def _coef_tensor(self, L: int) -> torch.Tensor:
        return torch.from_numpy(self._coef(L).astype(np.int64)).to(self.device)

    def __call__(self, tokens, lengths) -> torch.Tensor:
        """``uint8[B, L]`` rows and their lengths → ``torch.uint32[B, 4]`` on
        the hasher's device (a 128-bit hash in 4 lanes)."""
        tokens = torch.as_tensor(tokens).to(self.device)
        lengths = torch.as_tensor(lengths).to(self.device)
        return to_u32(_row_hash_impl(tokens, lengths, self._coef_tensor(tokens.shape[-1])))

    def hash_docs(self, raw: list[bytes], *, block_len: int = 4096) -> np.ndarray:
        """``uint32[n, 4]``: the same 128-bit hash at any document length.

        The hash is linear in the bytes, so a long document's sum splits
        across blocks of ``block_len``: block p uses the coefficients at
        offset ``p·block_len``, the partial sums add per document, and the
        length mix comes once at the end."""
        from advanced_scrapper_tpu_torch.cpu.hostbatch import (
            block_counts,
            encode_blocks_ranges,
        )

        n = len(raw)
        if n == 0:
            return np.zeros((0, _N_LANES), np.uint32)
        lens = np.fromiter(map(len, raw), np.int64, count=n)
        longest = int(lens.max())
        if longest > MAX_DOC_LEN:
            raise ValueError(
                f"item of {longest} bytes exceeds MAX_DOC_LEN {MAX_DOC_LEN}; "
                "the linear hash needs one coefficient per byte (~16 B/byte "
                "host + device), so an unbounded item would silently become "
                "an allocation storm — reject it loudly instead"
            )
        starts = np.zeros((n,), np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        counts = block_counts(lens, block_len, 0)
        tok, _block_lens, owners = encode_blocks_ranges(
            b"".join(raw), starts, lens, counts, block_len, 0
        )
        first = np.cumsum(counts) - counts
        block_pos = np.arange(tok.shape[0], dtype=np.int64) - np.repeat(first, counts)
        n_pos = int(counts.max())
        coef_blocks = (
            self._coef_tensor(n_pos * block_len)
            .reshape(_N_LANES, n_pos, block_len)
            .transpose(0, 1)
            .contiguous()
        )
        dev = self.device
        out = _block_hash_impl(
            torch.from_numpy(tok).to(dev),
            torch.from_numpy(block_pos).to(dev),
            torch.from_numpy(owners).to(dev),
            torch.from_numpy(lens).to(dev),
            coef_blocks,
            num_docs=n,
        )
        return to_u32(out).view(torch.int32).cpu().numpy().view(np.uint32)
