"""The exact hash's kernel formulation (``csrc/exact.cu``) on the CPU.

The kernel runs only on the card; here its plain version,
``ops.exact.exact_hash_plain`` through ``ExactHasher(device="cpu")``, is
held bit-equal to the JAX package's ``ops/exact.py:ExactHasher`` (its
``hash_docs`` over block lengths and block edges is held in
``tests/test_torch_exact.py``): ``hash_docs`` of only empty documents, and
``__call__`` on rows whose bytes past ``lengths`` are not zero (the row
form dots every column and mixes ``lengths``).  The plain version reads
ragged documents in place: starts at every residue mod 16, gaps and
garbage between documents, a span dotted apart from the length mixed in,
documents split across its chunks.  A model
of the kernel's walk (a lane a byte, the stream's prefix in shared memory)
equals it and reads every byte once.  The wrapper raises on a CPU tensor.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.ops.exact import ExactHasher as RefHasher
from advanced_scrapper_tpu_torch.ops import exact as port_exact
from advanced_scrapper_tpu_torch.ops import _build, exact_cuda
from advanced_scrapper_tpu_torch.ops.exact import ExactHasher, exact_hash_plain

U32 = 0xFFFFFFFF
#: the kernel's shared prefix of the stream, read from its source
PREFIX_MAX = int(re.search(r"constexpr int kPrefixMax = (\d+);",
                           (_build.CSRC_DIR / "exact.cu").read_text()).group(1))


@pytest.fixture(scope="module")
def hashers():
    return RefHasher(), ExactHasher(device="cpu")


def _docs(rng: np.random.RandomState, n: int, lengths) -> list[bytes]:
    return [rng.randint(0, 256, size=int(rng.choice(lengths)), dtype=np.uint8).tobytes()
            for _ in range(n)]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def test_hash_docs_of_only_empty_documents(hashers):
    ref, port = hashers
    raw = [b"", b"", b""]
    got = port.hash_docs(raw, block_len=16)
    assert np.array_equal(got, ref.hash_docs(raw, block_len=16))
    assert (got == got[0]).all()  # the same bytes, the same length


@pytest.mark.parametrize("width", [1, 16, 37, 96])
def test_row_form_counts_bytes_past_lengths(hashers, width):
    """``__call__`` dots all ``L`` columns (non-zero bytes past a row's
    length count) and mixes ``lengths``, as the reference's row hash."""
    ref, port = hashers
    rng = np.random.RandomState(width)
    tok = rng.randint(0, 256, size=(24, width), dtype=np.uint8)
    lens = rng.randint(0, width + 1, size=24).astype(np.int32)
    lens[:3] = [0, width, 0]
    tok[2] = 0  # an all-zero row of length 0
    want = np.asarray(ref(jnp.asarray(tok), jnp.asarray(lens)))
    got = port(tok, lens)
    assert got.dtype == torch.uint32 and got.shape == (24, 4)
    assert np.array_equal(_u32(got), want)
    # the tail bytes matter: zeroing them changes the hash of rows that had some
    cut = tok.copy()
    cut[np.arange(width)[None, :] >= lens[:, None]] = 0
    changed = (cut != tok).any(axis=1)
    same = (_u32(port(cut, lens)) == want).all(axis=1)
    assert not (same & changed).any() and same[~changed].all()


def _ragged(rng: np.random.RandomState, docs: list[bytes]):
    """Documents placed at scattered starts of a buffer of random bytes,
    out of order, with gaps: ``(text, starts)``."""
    slots = rng.permutation(len(docs))
    text, starts, pos = [], np.zeros(len(docs), np.int64), 0
    for i in slots:
        gap = int(rng.randint(0, 23))
        text.append(rng.randint(0, 256, size=gap, dtype=np.uint8).tobytes())
        pos += gap
        starts[i] = pos
        text.append(docs[i])
        pos += len(docs[i])
    return np.frombuffer(b"".join(text) + b"\xff" * 7, np.uint8), starts


def _plain(port: ExactHasher, text, starts, span, mixlen) -> np.ndarray:
    coef = port._coef_tensor(int(max(span, default=0)))
    return _u32(exact_hash_plain(torch.from_numpy(text.copy()), torch.from_numpy(starts),
                                 torch.from_numpy(np.asarray(span, np.int32)),
                                 torch.from_numpy(np.asarray(mixlen, np.uint32).view(np.int32)),
                                 coef))


def test_plain_reads_ragged_documents_in_place(hashers):
    ref, port = hashers
    rng = np.random.RandomState(7)
    docs = _docs(rng, 48, [0, 1, 2, 15, 16, 17, 31, 33, 64, 200, 1000])
    text, starts = _ragged(rng, docs)
    assert len(set((starts % 16).tolist())) >= 10  # starts off 16-byte alignment
    lens = [len(d) for d in docs]
    assert np.array_equal(_plain(port, text, starts, lens, lens), ref.hash_docs(docs))


def test_plain_span_apart_from_the_mixed_length(hashers):
    """The row form through the ragged entry point: span ``L`` at ``b·L``,
    length ``lengths[b]``."""
    ref, port = hashers
    rng = np.random.RandomState(8)
    tok = rng.randint(0, 256, size=(10, 45), dtype=np.uint8)
    lens = rng.randint(0, 46, size=10).astype(np.int32)
    got = _plain(port, tok.reshape(-1), np.arange(10, dtype=np.int64) * 45, [45] * 10, lens)
    assert np.array_equal(got, np.asarray(ref(jnp.asarray(tok), jnp.asarray(lens))))


def test_plain_splits_documents_across_chunks(hashers, monkeypatch):
    ref, port = hashers
    monkeypatch.setattr(port_exact, "CHUNK_ELEMS", 97)
    rng = np.random.RandomState(9)
    raw = _docs(rng, 12, [0, 5, 96, 97, 98, 500, 3000])
    assert np.array_equal(port.hash_docs(raw), ref.hash_docs(raw, block_len=256))


def test_coefficient_stream_grows_only_when_needed():
    port = ExactHasher(device="cpu")
    first = port._coef_tensor(10)
    assert first.shape == (port_exact.MIN_STREAM, 4) and first.dtype == torch.int32
    assert port._coef_tensor(port_exact.MIN_STREAM) is first
    grown = port._coef_tensor(1000)
    assert grown.shape == (1024, 4) and port._coef_tensor(3) is grown
    want = RefHasher()._coef(1024)
    assert np.array_equal(grown.numpy().view(np.uint32).T, want)


# -- a model of the kernel's walk -------------------------------------------------


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def kernel_model(text, starts, span, mixlen, coef, max_span: int, prefix_max=PREFIX_MAX):
    """The warp a document of ``exact_hash_kernel``: the stream's prefix in
    shared memory, lane ``l`` summing positions ``l, l + 32, ...`` (past the
    prefix from the stream itself), the lane sums reduced, the length
    mixed; asserts every byte of a document is read once."""
    cols = coef.shape[0]
    pre = min(prefix_max, (min(max_span, cols) + 15) // 16 * 16)
    sm = np.zeros((pre, 4), np.uint64)
    sm[:min(pre, cols)] = coef[:pre]
    out = np.zeros((len(starts), 4), np.uint32)
    for d, (st, sp) in enumerate(zip(starts, span)):
        start = min(max(int(st), 0), len(text))
        ln = min(min(max(int(sp), 0), cols), len(text) - start)
        lanes = np.zeros((32, 4), np.uint64)
        seen = np.zeros(ln, np.int64)
        for lane in range(32):
            for i in range(lane, ln, 32):
                c = sm[i] if i < pre else coef[i].astype(np.uint64)
                lanes[lane] = (lanes[lane] + int(text[start + i]) * c) & U32
                seen[i] += 1
        assert (seen == 1).all()
        s = [int(x) for x in lanes.sum(axis=0) & U32]
        lm = _fmix32((int(mixlen[d]) * 0x9E3779B9) & U32)
        out[d] = [_fmix32(s[j] ^ lm ^ ((j * 0x85EBCA77) & U32)) for j in range(4)]
    return out


def test_kernel_model_equals_plain(hashers):
    """Documents at every start residue, empty ones, lengths beside the
    warp's 32 and the prefix's 16; a prefix shorter than the longest span
    reads the rest from the stream."""
    _ref, port = hashers
    rng = np.random.RandomState(20)
    docs = _docs(rng, 32, [0, 1, 14, 15, 16, 17, 31, 32, 33, 63, 130, 600])
    text, starts = _ragged(rng, docs)
    lens = np.array([len(d) for d in docs])
    mix = rng.randint(0, 1 << 32, size=len(docs), dtype=np.uint64).astype(np.uint32)
    coef = port._coef_tensor(int(lens.max())).numpy().view(np.uint32)
    want = _plain(port, text, starts, lens, mix)
    assert PREFIX_MAX >= 16 and PREFIX_MAX % 16 == 0
    for prefix_max in (PREFIX_MAX, 64):
        assert np.array_equal(kernel_model(text, starts, lens, mix, coef, int(lens.max()),
                                           prefix_max), want)


def test_wrapper_raises_on_cpu_tensors():
    text = torch.zeros(16, dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        exact_cuda.exact_hash(text, one, one.to(torch.int32), one.to(torch.int32),
                              torch.zeros((16, 4), dtype=torch.int32), max_span=1)
