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
of the kernel's walk equals it and reads every byte once: tiles of
back-to-back documents staged (urls, text at every address residue, a 4
KiB document among them taking a warp, empty documents at a tile's edges,
the row form with non-zero tail bytes) and the per-document walk (scattered
starts, a gap between two documents, a tile past the buffer).  The wrapper
raises on a CPU tensor.
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
EXACT_SRC = (_build.CSRC_DIR / "exact.cu").read_text()
#: the kernel's shared prefix of the stream, read from its source
PREFIX_MAX = int(re.search(r"constexpr int kPrefixMax = (\d+);", EXACT_SRC).group(1))


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


def _exact_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", EXACT_SRC).group(1))


#: the kernel's tile sizes, read from its source
THREADS, BUF_BYTES, REACH_STEPS = (_exact_const(n) for n in ("kThreads", "kBufBytes",
                                                             "kReachSteps"))
assert "kTileDocs = kThreads;" in EXACT_SRC


def group_width(max_span: int, cols: int) -> int:
    """The lanes a document of the tile path: 8, 16 or 32, the fewest that
    cover ``min(max_span, cols)`` at 8 positions a lane."""
    need = min(max_span, cols)
    return 8 if need <= 64 else 16 if need <= 128 else 32


def kernel_model(text, starts, span, mixlen, coef, max_span: int, prefix_max=PREFIX_MAX,
                 *, tile_docs=THREADS, buf_bytes=BUF_BYTES, addr=0):
    """``exact_hash_kernel``'s walk over tiles of ``tile_docs`` documents,
    ``text`` at an address ``addr`` mod 16.  A tile whose documents are back
    to back and inside text and the stream, and whose bytes fit
    ``buf_bytes``, is staged from the 16-byte word holding its first byte
    (words past text's ends read as zeros): a group of ``group_width`` lanes
    a document of up to ``group * kReachSteps`` bytes inside the stream's
    shared prefix, lane ``l`` summing positions ``l, l + group, ...`` from
    the staged bytes, the group's sums reduced; longer documents, and every document of any other tile, a warp
    each from text (lane ``l`` positions ``l, l + 32, ...``, reads
    clamped).  Asserts every byte of a document is read once and that the
    staged bytes are text's.  Returns ``(out, paths)``."""
    cols = coef.shape[0]
    pre = min(prefix_max, (min(max_span, cols) + 15) // 16 * 16)
    sm = np.zeros((pre, 4), np.uint64)
    sm[:min(pre, cols)] = coef[:pre]
    group = group_width(max_span, cols)
    reach = min(group * REACH_STEPS, pre)
    n, T = len(starts), len(text)
    out = np.zeros((n, 4), np.uint32)
    paths = {"staged": 0, "per_doc": 0, "long": 0}

    def coef_at(i):
        return sm[i] if i < pre else coef[i].astype(np.uint64)

    def finish(d, lane_sums):
        s = [int(x) for x in np.sum(lane_sums, axis=0) & U32]
        lm = _fmix32((int(mixlen[d]) * 0x9E3779B9) & U32)
        out[d] = [_fmix32(s[j] ^ lm ^ ((j * 0x85EBCA77) & U32)) for j in range(4)]

    def warp_doc(d):
        start = min(max(int(starts[d]), 0), T)
        ln = min(min(max(int(span[d]), 0), cols), T - start)
        lanes = np.zeros((32, 4), np.uint64)
        seen = np.zeros(ln, np.int64)
        for lane in range(32):
            for i in range(lane, ln, 32):
                lanes[lane] = (lanes[lane] + int(text[start + i]) * coef_at(i)) & U32
                seen[i] += 1
        assert (seen == 1).all()
        finish(d, lanes)

    for d0 in range(0, n, tile_docs):
        docs = range(d0, min(n, d0 + tile_docs))
        st = [int(starts[d]) for d in docs]
        sp = [int(span[d]) for d in docs]
        ok = all(x >= 0 and 0 <= y <= cols and x <= T - y for x, y in zip(st, sp))
        ok = ok and all(st[i + 1] == st[i] + sp[i] for i in range(len(st) - 1))
        if not (ok and st[-1] + sp[-1] - st[0] <= buf_bytes):
            paths["per_doc"] += 1
            for d in docs:
                warp_doc(d)
            continue
        paths["staged"] += 1
        base = st[0]
        off = (addr + base) % 16
        words = (off + st[-1] + sp[-1] - base + 15) // 16
        assert 16 * words <= buf_bytes + 32
        buf = np.zeros(16 * words, np.int64)
        for k in range(16 * words):
            at = base - off + k  # the byte's offset in text
            buf[k] = text[at] if 0 <= at < T else 0
        for i, d in enumerate(docs):
            if sp[i] > reach:
                paths["long"] += 1
                warp_doc(d)
                continue
            q = off + st[i] - base
            lanes = np.zeros((group, 4), np.uint64)
            seen = np.zeros(sp[i], np.int64)
            for sub in range(group):
                for j in range(sub, sp[i], group):
                    assert buf[q + j] == text[st[i] + j]
                    lanes[sub] = (lanes[sub] + int(buf[q + j]) * coef_at(j)) & U32
                    seen[j] += 1
            assert (seen == 1).all()
            finish(d, lanes)
    return out, paths


def _model_case(port, text, starts, lens, mix, max_span=None, **kw):
    longest = int(max(lens, default=0))
    coef = port._coef_tensor(longest).numpy().view(np.uint32)
    want = _plain(port, text, starts, lens, mix)
    got, paths = kernel_model(text, starts, lens, mix, coef,
                              longest if max_span is None else max_span, **kw)
    assert np.array_equal(got, want)
    return paths


def _back_to_back(docs: list[bytes]):
    lens = np.array([len(d) for d in docs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return np.frombuffer(b"".join(docs) + b"\x00" * 3, np.uint8), starts, lens


def test_kernel_model_equals_plain(hashers):
    """Scattered documents at every start residue (the per-document walk),
    empty ones, lengths beside the warp's 32 and the prefix's 16; a prefix
    shorter than the longest span reads the rest from the stream."""
    _ref, port = hashers
    rng = np.random.RandomState(20)
    docs = _docs(rng, 32, [0, 1, 14, 15, 16, 17, 31, 32, 33, 63, 130, 600])
    text, starts = _ragged(rng, docs)
    lens = np.array([len(d) for d in docs])
    mix = rng.randint(0, 1 << 32, size=len(docs), dtype=np.uint64).astype(np.uint32)
    assert PREFIX_MAX >= 16 and PREFIX_MAX % 16 == 0
    for prefix_max in (PREFIX_MAX, 64):
        paths = _model_case(port, text, starts, lens, mix, prefix_max=prefix_max)
        assert paths["per_doc"] == 1 and paths["staged"] == 0


@pytest.mark.parametrize("addr", [0, 5, 15])
def test_kernel_model_tiles_of_urls(hashers, addr):
    """Urls back to back, as ``doc_inputs`` lays them out: every tile staged
    (several tiles, the last one partial), 8 lanes a url, text at an
    address 0, 5 or 15 mod 16 (the staged words at both ends pass text's
    bounds); equal to the plain version and to the JAX package."""
    ref, port = hashers
    rng = np.random.RandomState(21 + addr)
    urls = [f"https://news.example/{rng.randint(1 << 30)}/article-{i}.html".encode()
            for i in range(600)]
    text, starts, lens = _back_to_back(urls)
    assert group_width(int(lens.max()), 1 << 10) == 8
    paths = _model_case(port, text, starts, lens, lens.astype(np.uint32), addr=addr)
    assert paths == {"staged": 3, "per_doc": 0, "long": 0}
    assert np.array_equal(port.hash_docs(urls), ref.hash_docs(urls))


def test_kernel_model_spans_past_the_stated_longest(hashers):
    """A caller that states a longest span below the documents' own: the
    stream's shared prefix stops short of them, so each staged url takes a
    warp, whose reads of the stream go past the prefix."""
    _ref, port = hashers
    rng = np.random.RandomState(25)
    urls = [f"https://z.example/{rng.randint(1 << 30)}/b-{i}.html".encode() for i in range(300)]
    text, starts, lens = _back_to_back(urls)
    paths = _model_case(port, text, starts, lens, lens.astype(np.uint32), max_span=20)
    assert paths == {"staged": 2, "per_doc": 0, "long": 300}


def test_kernel_model_long_document_among_urls(hashers):
    """A 4 KiB document among urls: its tile is staged (it fits the
    buffer), the group width follows the longest span, the 4 KiB document
    takes a warp; the JAX package agrees."""
    ref, port = hashers
    rng = np.random.RandomState(22)
    raw = [f"https://x.example/{i}/{rng.randint(1 << 20)}.html".encode() for i in range(300)]
    raw[100] = rng.randint(0, 256, size=4096, dtype=np.uint8).tobytes()
    text, starts, lens = _back_to_back(raw)
    paths = _model_case(port, text, starts, lens, lens.astype(np.uint32))
    assert paths == {"staged": 2, "per_doc": 0, "long": 1}
    assert np.array_equal(port.hash_docs(raw), ref.hash_docs(raw))


def test_kernel_model_tiles_not_back_to_back(hashers):
    """One gap of a byte between two urls of the first tile, and a tile
    whose bytes pass the buffer: both take the per-document walk, the
    other tiles are staged."""
    _ref, port = hashers
    rng = np.random.RandomState(23)
    urls = [f"https://y.example/{rng.randint(1 << 30)}/a-{i}.html".encode() for i in range(700)]
    text, starts, lens = _back_to_back(urls)
    gap = np.concatenate([text[:starts[40]], [7], text[starts[40]:]]).astype(np.uint8)
    starts_gap = starts + (np.arange(len(urls)) >= 40)
    mix = rng.randint(0, 1 << 32, size=len(urls), dtype=np.uint64).astype(np.uint32)
    paths = _model_case(port, gap, starts_gap, lens, mix)
    assert paths == {"staged": 2, "per_doc": 1, "long": 0}
    small = _model_case(port, text, starts, lens, mix, buf_bytes=4096)
    assert small["per_doc"] == 3 and small["staged"] == 0


def test_kernel_model_empty_documents_at_tile_edges(hashers):
    """Empty documents first and last in tiles, a tile of only empty
    documents, and documents ending at text's last byte."""
    ref, port = hashers
    rng = np.random.RandomState(24)
    raw = _docs(rng, 3 * THREADS, [0, 1, 9, 40, 51])
    for i in (0, THREADS - 1, THREADS, 2 * THREADS - 1, len(raw) - 1):
        raw[i] = b""
    raw[-2] = b"tail"
    text, starts, lens = _back_to_back(raw)
    paths = _model_case(port, text[:-3], starts, lens, lens.astype(np.uint32))
    assert paths["staged"] == 3
    empty = [b""] * (THREADS + 5)
    etext, estarts, elens = _back_to_back(empty)
    assert _model_case(port, etext, estarts, elens, elens.astype(np.uint32)) == {
        "staged": 2, "per_doc": 0, "long": 0}
    assert np.array_equal(port.hash_docs(raw), ref.hash_docs(raw))


@pytest.mark.parametrize("width", [37, 96])
def test_kernel_model_row_form(hashers, width):
    """The row form: span ``L`` at ``b·L`` with non-zero bytes past each
    row's length, mixing ``lengths``; staged where the tile fits the buffer
    (``L`` = 37, and the last tile's 40 rows at 96), a warp a row where it
    does not (``L`` = 96 at 256 rows: 24 KiB)."""
    ref, port = hashers
    rng = np.random.RandomState(width)
    rows = THREADS + 40
    tok = rng.randint(1, 256, size=(rows, width), dtype=np.uint8)
    lens = rng.randint(0, width + 1, size=rows).astype(np.int32)
    starts = np.arange(rows, dtype=np.int64) * width
    paths = _model_case(port, tok.reshape(-1), starts, [width] * rows, lens.view(np.uint32))
    staged = THREADS * width <= BUF_BYTES
    assert paths == {"staged": 2 if staged else 1, "per_doc": 0 if staged else 1, "long": 0}
    want = np.asarray(ref(jnp.asarray(tok), jnp.asarray(lens)))
    assert np.array_equal(_u32(port(tok, lens)), want)


def test_wrapper_raises_on_cpu_tensors():
    text = torch.zeros(16, dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        exact_cuda.exact_hash(text, one, one.to(torch.int32), one.to(torch.int32),
                              torch.zeros((16, 4), dtype=torch.int32), max_span=1)
