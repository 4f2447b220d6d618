"""Exact 128-bit row hashing for the grouping path of ``ExactDedup``.

Counterpart of the reference's ``ops/exact.py``, bit-equal to it.  Each
document gets four independent 32-bit linear hashes ``h = fmix32((Σ c_i·x_i
mod 2³²) ⊕ fmix32(len·0x9E3779B9) ⊕ lane·0x85EBCA77)``: a dot product of its
bytes with a seeded coefficient stream per lane.  Zero padding adds
nothing, and the length is mixed in so ``"ab"`` and ``"ab\\x00"`` differ.

The stream is prefix-consistent (``_coef(L)`` is a prefix of ``_coef(L')``),
so the reference's block ``p``, dotted with the stream at ``p·block_len``,
is the stream at each byte's offset in its document.  The port therefore
hashes ragged documents read in place from one joined buffer (``text``,
``starts``, ``span``) and needs no blocks: a document's hash does not depend
on the block length.  On the card that is one launch of the ``exact_hash``
kernel (``csrc/exact.cu``, wrapper ``ops.exact_cuda``); on the CPU its
plain version :func:`exact_hash_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_scrapper_tpu_torch import resolve_device
from advanced_scrapper_tpu_torch.ops import exact_cuda
from advanced_scrapper_tpu_torch.ops.shingle import U32_MASK, fmix32, to_u32

_N_LANES = 4

#: Hard ceiling for a hashed document (4 MiB): the coefficient stream costs
#: ~16 bytes per byte of the longest document, so one huge item fails
#: loudly instead of exhausting memory.
MAX_DOC_LEN = 1 << 22

#: Most bytes multiplied at once by the plain version.
CHUNK_ELEMS = 1 << 22

#: The fewest stream positions kept on the hasher's device; the stream
#: grows to the next power of two above what a call needs.
MIN_STREAM = 64


def exact_hash_plain(
    text: torch.Tensor,
    starts: torch.Tensor,
    span: torch.Tensor,
    mixlen: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the ``exact_hash`` kernel: ``int32[n, 4]``, the bits
    of the ``uint32`` hash lanes of each document ``text[starts[d] :
    starts[d] + span[d]]`` (``uint8[T]``, ``int64[n]``, ``int32[n]``).  Its
    bytes are dotted with ``coef[:span[d]]`` (``int32``/``uint32[C, 4]``,
    the stream interleaved by lane) as ``int64`` products summed mod 2³²,
    in chunks of ``CHUNK_ELEMS`` bytes; ``mixlen[d]`` (``int32``, the
    ``uint32`` bits) is the length mixed in.  An empty document dots to
    0."""
    dev = text.device
    n = starts.shape[0]
    lens = span.to(torch.int64)
    ends = torch.cumsum(lens, 0)
    first = ends - lens
    total = int(ends[-1]) if n else 0
    coef = coef.view(torch.int32)
    acc = torch.zeros((n, _N_LANES), dtype=torch.int64, device=dev)
    for q0 in range(0, total, CHUNK_ELEMS):
        q = torch.arange(q0, min(total, q0 + CHUNK_ELEMS), device=dev)
        owner = torch.searchsorted(ends, q, right=True)
        off = q - first[owner]
        x = text[starts[owner] + off].to(torch.int64)
        c = coef[off].to(torch.int64) & U32_MASK
        # a chunk adds < 2²² products of < 2⁴⁰ to a sum < 2³²: no overflow
        acc.index_add_(0, owner, x[:, None] * c)
        acc &= U32_MASK
    # |mixlen| < 2³¹, so the product fits int64 and its low 32 bits are the
    # uint32 product's
    lmix = fmix32((mixlen.to(torch.int64) * 0x9E3779B9) & U32_MASK)
    salt = (torch.arange(_N_LANES, dtype=torch.int64, device=dev) * 0x85EBCA77) & U32_MASK
    return to_u32(fmix32(acc ^ lmix[:, None] ^ salt[None, :])).view(torch.int32)


def _hash(text, starts, span, mixlen, coef, max_span: int) -> torch.Tensor:
    """The kernel on the card, its plain version on the CPU."""
    if text.device.type == "cuda":
        return exact_cuda.exact_hash(text, starts, span, mixlen, coef, max_span=max_span)
    return exact_hash_plain(text, starts, span, mixlen, coef)


class ExactHasher:
    """Seeded 128-bit row hasher on ``device`` (``None``: the card, raising
    without one; ``"cpu"``: plain PyTorch on the host)."""

    def __init__(self, seed: int = 0xA5C3, device: str | torch.device | None = None):
        self._seed = seed
        self.device = resolve_device(device)
        self._stream = np.zeros((_N_LANES, 0), dtype=np.uint32)
        self._coef_dev = torch.zeros((0, _N_LANES), dtype=torch.int32, device=self.device)

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
        """The stream's first ``L`` or more positions on the hasher's
        device, ``int32[C, 4]`` (lanes interleaved, the ``uint32`` bits);
        uploaded only when it grows."""
        if self._coef_dev.shape[0] < L:
            size = max(MIN_STREAM, 1 << (L - 1).bit_length())
            if size > MAX_DOC_LEN:
                size = max(L, MAX_DOC_LEN)
            host = np.ascontiguousarray(self._coef(size).T).view(np.int32)
            self._coef_dev = torch.from_numpy(host).to(self.device)
        return self._coef_dev

    def __call__(self, tokens, lengths) -> torch.Tensor:
        """``uint8[B, L]`` rows and their lengths → ``torch.uint32[B, 4]`` on
        the hasher's device (a 128-bit hash in 4 lanes).  All ``L`` bytes of
        a row are dotted, as the reference dots its padded row; the length
        mixed in is ``lengths[b]``."""
        tokens = torch.as_tensor(tokens).to(self.device)
        if tokens.dtype != torch.uint8 or tokens.ndim != 2:
            raise TypeError(f"tokens must be uint8[B, L], got {tokens.dtype} {tuple(tokens.shape)}")
        B, L = tokens.shape
        lengths = torch.as_tensor(lengths).to(self.device).to(torch.int64) & U32_MASK
        dev = self.device
        starts = torch.arange(B, dtype=torch.int64, device=dev) * L
        span = torch.full((B,), L, dtype=torch.int32, device=dev)
        mixlen = to_u32(lengths).view(torch.int32)
        out = _hash(tokens.contiguous().view(-1), starts, span, mixlen, self._coef_tensor(L), L)
        return out.view(torch.uint32)

    def doc_inputs(self, raw: list[bytes]) -> tuple:
        """``(text, starts, span, mixlen, coef, max_span)`` of the items
        ``raw`` on the hasher's device, the arguments of the kernel and of
        its plain version.  The items are joined behind their descriptors
        (``int64`` starts, then the ``int32`` lengths twice: the span dotted
        and the length mixed in; 16 bytes an item, so the text stays
        16-byte aligned) into one buffer, which goes to the device in one
        copy.  Raises past ``MAX_DOC_LEN``."""
        n = len(raw)
        lens = np.fromiter(map(len, raw), np.int64, count=n)
        longest = int(lens.max()) if n else 0
        if longest > MAX_DOC_LEN:
            raise ValueError(
                f"item of {longest} bytes exceeds MAX_DOC_LEN {MAX_DOC_LEN}; "
                "the linear hash needs one coefficient per byte (~16 B/byte "
                "host + device), so an unbounded item would silently become "
                "an allocation storm — reject it loudly instead"
            )
        head = np.empty((4 * n,), np.int32)
        starts = head[: 2 * n].view(np.int64)
        if n:
            starts[0] = 0
            np.cumsum(lens[:-1], out=starts[1:])
        head[2 * n: 3 * n] = lens
        head[3 * n:] = lens
        buf = torch.frombuffer(bytearray(b"").join([head.tobytes(), *raw]), dtype=torch.uint8)
        buf = buf.to(self.device)
        hb = 16 * n
        return (buf[hb:], buf[: 8 * n].view(torch.int64), buf[8 * n: 12 * n].view(torch.int32),
                buf[12 * n: hb].view(torch.int32), self._coef_tensor(longest), longest)

    def hash_docs(self, raw: list[bytes], *, block_len: int = 4096) -> np.ndarray:
        """``uint32[n, 4]``: the same 128-bit hash at any document length
        (``block_len`` is the reference's block width; the hash does not
        depend on it): the items in one copy (:meth:`doc_inputs`), one
        launch, 16 bytes an item back."""
        if not raw:
            return np.zeros((0, _N_LANES), np.uint32)
        return _hash(*self.doc_inputs(raw)).cpu().numpy().view(np.uint32)
