"""The port's host batcher (``cpu/hostbatch.py:HostBatcher`` over
``native/hostbatch.cpp``, and its Python twin), ``DeviceFeed`` and
``stream_signatures`` on the CPU, against the JAX package's, as
``tests/test_hostbatch_feed.py`` pins the reference's.

Pops of the same pushes give the same ``(n, tokens, lengths, tags)``
from the native and the Python queue of the port and the reference's
queue, with ``min_fill`` and timeouts; ``stream_signatures`` gives the
same tags, signatures and band keys as the JAX one, compared by tag (a
feed with two workers reorders batches).  Every feed and producer is
closed and joined with a timeout."""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np
import pytest

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.core import tokenizer as ref_tokenizer
from advanced_scrapper_tpu.cpu.hostbatch import HostBatcher as RefBatcher
from advanced_scrapper_tpu.pipeline.feed import stream_signatures as ref_stream
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core import tokenizer
from advanced_scrapper_tpu_torch.cpu import hostbatch
from advanced_scrapper_tpu_torch.cpu.hostbatch import HostBatcher
from advanced_scrapper_tpu_torch.pipeline import feed as feed_mod
from advanced_scrapper_tpu_torch.pipeline.feed import (
    DeviceFeed,
    resolve_prefetch_depth,
    stream_signatures,
)
from test_torch_dispatch import _threads_settle


@pytest.fixture(params=[True, False], ids=["native", "python"])
def make(request):
    def build(block=64, **kw):
        return HostBatcher(block, prefer_native=request.param, **kw)

    return build


def _pops_equal(a, b) -> None:
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# -- the queue -------------------------------------------------------------------


def test_native_queue_builds_here():
    assert hostbatch.hostbatch_backend() == "native" and hostbatch.backend_reason() == ""
    assert HostBatcher(8).backend == "native"
    assert HostBatcher(8, prefer_native=False).backend == "python"


def test_failed_native_build_raises(monkeypatch):
    """``prefer_native=True`` never falls back: a failed build raises, and
    the report says why."""
    from advanced_scrapper_tpu_torch.cpu import native

    def broken(*a, **kw):
        raise RuntimeError("g++ failed: no compiler")

    monkeypatch.setattr(hostbatch, "_lib", None)
    monkeypatch.setattr(hostbatch, "_reason", "")
    monkeypatch.setattr(native, "build", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        HostBatcher(8)
    assert hostbatch.hostbatch_backend() == "python"
    assert "no compiler" in hostbatch.backend_reason()
    assert HostBatcher(8, prefer_native=False).backend == "python"


@pytest.mark.parametrize("script", ["tiles", "fifo", "caps", "close", "many", "min_fill"])
def test_pops_equal_the_reference_queue(make, script):
    """The same pushes and pops through the port's queue and the
    reference's Python twin give equal pops, return values and stats."""
    def run(b):
        out = []
        if script == "tiles":
            out += [b.push(b"hello", 7), b.push("x" * 40, 8), b.push(b"", 9)]
            out.append(b.pop_batch(4, timeout_ms=0))
        elif script == "fifo":
            out += [b.push(f"doc{i}", i) for i in range(5)]
            out += [b.pop_batch(3, timeout_ms=0), b.pop_batch(3, timeout_ms=0), b.size()]
        elif script == "caps":
            out += [b.push(b"a" * 5, 0), b.push(b"b" * 6, 1), b.push(b"c" * 5, 2),
                    b.push(b"d", 3), b.arena_used()]
            out += [b.pop_batch(2, timeout_ms=0), b.arena_used()]
        elif script == "close":
            out.append(b.push(b"last", 1))
            b.close()
            out += [b.closed(), b.push(b"late", 2), b.pop_batch(4, timeout_ms=-1),
                    b.pop_batch(4, timeout_ms=-1)]
        elif script == "many":
            docs = [f"doc number {i}".encode() for i in range(20)]
            docs[7], docs[8] = b"nul\x00inside\x00doc", b""
            out += [b.push_many(docs, np.arange(20, dtype=np.uint64)),
                    b.push_many([b"a", b"b", b"c"], np.arange(2, dtype=np.uint64)),
                    b.push_many([b"s", b"t"], {30: 0, 31: 0}.keys()),
                    b.pop_batch(32, timeout_ms=0)]
        else:
            out += [b.push(b"x" * i, i) for i in range(3)]
            out.append(b.pop_batch(8, timeout_ms=50, min_fill=8))  # timeout: partial
            out += [b.push(b"y", 100 + i) for i in range(8)]
            out.append(b.pop_batch(8, timeout_ms=5000, min_fill=8))  # full
            out.append(b.push(b"w", 300))
            b.close()
            out += [b.pop_batch(8, timeout_ms=-1, min_fill=8), b.pop_batch(8, min_fill=8)]
        out.append(b.stats())
        return out

    kw = dict(max_docs=3, arena_bytes=10) if script == "caps" else {}
    got = run(make(block=16, **kw))
    want = run(RefBatcher(16, prefer_native=False, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _pops_equal(g, w)
        else:
            assert g == w


def test_blocking_pop_wakes_on_push(make):
    b = make(block=8)
    got = {}
    t = threading.Thread(target=lambda: got.update(res=b.pop_batch(2, timeout_ms=5000)))
    t.start()
    time.sleep(0.05)
    b.push(b"wake", 42)
    t.join(timeout=10)
    assert not t.is_alive()
    n, _, _, tags = got["res"]
    assert n == 1 and tags[0] == 42


def test_min_fill_pop_wakes_on_backpressure(make):
    """A queue whose caps reject a push cannot reach a waiting pop's fill:
    the rejection wakes it to drain what is there."""
    b = make(block=8, max_docs=64, arena_bytes=32)
    for i in range(4):
        assert b.push(b"12345678", i)
    got = {}
    t = threading.Thread(
        target=lambda: got.update(res=b.pop_batch(16, timeout_ms=10000, min_fill=16)))
    t.start()
    time.sleep(0.05)
    assert not b.push(b"x", 99)
    t.join(timeout=5)
    assert not t.is_alive(), "min_fill pop starved behind backpressure"
    n, _, _, tags = got["res"]
    assert n == 4 and list(tags[:4]) == [0, 1, 2, 3]


def test_concurrent_producers_lose_nothing(make):
    b = make(block=8, max_docs=10000)
    n_each, producers = 300, 4

    def produce(base):
        for i in range(n_each):
            assert b.push_blocking(f"d{base + i}", base + i, timeout_s=10)

    threads = [threading.Thread(target=produce, args=(p * n_each,)) for p in range(producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    seen = []
    while True:
        n, _, _, tags = b.pop_batch(128, timeout_ms=0)
        if n == 0:
            break
        seen.extend(tags[:n].tolist())
    assert sorted(seen) == list(range(n_each * producers))


def test_feed_returns_promptly_on_a_closed_batcher(make):
    b = make(block=64, max_docs=4)
    b.close()
    t0 = time.monotonic()
    assert b.feed([b"a"] * 100, timeout_s=60.0) == 0
    assert time.monotonic() - t0 < 5.0


def test_feed_pushes_sequential_tags(make):
    b = make(block=8)
    assert b.feed((f"d{i}" for i in range(10)), start_tag=5, chunk=3) == 10
    n, tok, lens, tags = b.pop_batch(16, timeout_ms=0)
    assert n == 10 and tags[:10].tolist() == list(range(5, 15))
    with b:
        pass
    assert b.closed()


# -- the tokenizer's batch helpers -------------------------------------------------


@pytest.mark.parametrize("n,batch", [(0, 4), (3, 4), (8, 4), (9, 4)])
def test_iter_batches_and_pad_match_reference(n, batch):
    rng = np.random.RandomState(n)
    texts = [rng.randint(32, 127, size=rng.randint(0, 40), dtype=np.uint8).tobytes()
             for _ in range(n)]
    got = list(tokenizer.iter_batches(texts, batch, 16))
    want = list(ref_tokenizer.iter_batches(texts, batch, 16))
    assert len(got) == len(want)
    for (gt, gl, gn), (wt, wl, wn) in zip(got, want):
        assert gn == wn and np.array_equal(gt, wt) and np.array_equal(gl, wl)
        assert gt.dtype == wt.dtype and gl.dtype == wl.dtype
    tok, lens = tokenizer.encode_batch(texts[:3] or [b""], 16)
    for target in (3, 5):
        if tok.shape[0] > target:
            continue
        g, w = tokenizer.pad_batch_to(tok, lens, target), ref_tokenizer.pad_batch_to(tok, lens, target)
        assert g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    with pytest.raises(ValueError):
        tokenizer.pad_batch_to(np.zeros((4, 8), np.uint8), np.zeros(4, np.int32), 2)


# -- DeviceFeed --------------------------------------------------------------------


def test_prefetch_depth_env_knob(monkeypatch):
    monkeypatch.delenv("ASTPU_FEED_PREFETCH", raising=False)
    assert resolve_prefetch_depth(None) == 2 and resolve_prefetch_depth(0) == 2
    assert resolve_prefetch_depth(5) == 5
    monkeypatch.setenv("ASTPU_FEED_PREFETCH", "7")
    assert resolve_prefetch_depth(None) == 7 and resolve_prefetch_depth(3) == 3


@pytest.mark.parametrize("workers", [1, 2])
def test_device_feed_delivers_every_batch_once(workers):
    before = threading.active_count()
    b = HostBatcher(32)
    feed = DeviceFeed(b, 8, depth=3, workers=workers, device="cpu")
    total = 64

    def produce():
        for i in range(total):
            assert b.push(b"doc-%d" % i, 1000 + i)
        b.close()

    p = threading.Thread(target=produce, daemon=True)
    p.start()
    seen: list[int] = []
    for n, tok, lens, tags in feed:
        assert n > 0 and tok.shape == (8, 32) and lens.shape == (8,)
        seen.extend(tags[:n].tolist())
    p.join(timeout=10)
    feed.join()
    assert sorted(seen) == [1000 + i for i in range(total)]
    assert list(iter(feed)) == []  # an exhausted feed terminates again
    assert _threads_settle(before)


def test_device_feed_assembles_full_tiles():
    batch, chunk, total = 64, 16, 256
    b = HostBatcher(8)
    feed = DeviceFeed(b, batch, workers=1, poll_timeout_ms=2000, device="cpu")

    def produce():
        for start in range(0, total, chunk):
            b.push_many([b"d%d" % i for i in range(start, start + chunk)],
                        list(range(start, start + chunk)))
        b.close()

    t = threading.Thread(target=produce)
    t.start()
    fills = [n for n, _, _, _ in feed]
    t.join(timeout=10)
    feed.join()
    assert fills == [batch] * (total // batch)


def test_device_feed_worker_death_raises_instead_of_hanging():
    class ExplodingBatcher:
        def pop_batch(self, batch, timeout_ms=-1, min_fill=1):
            raise RuntimeError("transport dropped")

        def closed(self):
            return False

        def size(self):
            return 1

    feed = DeviceFeed(ExplodingBatcher(), batch_size=4, device="cpu")
    with pytest.raises(RuntimeError, match="died mid-stream") as ei:
        for _ in feed:
            pass
    assert "transport dropped" in str(ei.value.__cause__)
    feed.join(timeout=5)


def test_device_feed_multi_worker_death_raises_promptly():
    """Two workers and a poisoned copy on a batcher that is never closed:
    only stop-on-error can end the feed."""
    b = HostBatcher(32)
    feed = DeviceFeed(b, 4, depth=2, workers=2, poll_timeout_ms=50, device="cpu")
    boom = RuntimeError("transport died")

    def bad_put(arr):
        raise boom

    feed._put_device = bad_put
    for i in range(8):
        b.push(b"x%d" % i, i)
    got: list[BaseException] = []

    def consume():
        try:
            for _ in feed:
                pass
        except BaseException as e:  # noqa: BLE001 - the test inspects it
            got.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10)
    try:
        assert not t.is_alive(), "consumer hung: peers did not stop on death"
        assert got and "DeviceFeed worker died" in str(got[0]) and got[0].__cause__ is boom
    finally:
        b.close()
        feed.join()


def test_device_feed_sharding_and_default_device():
    """``sharding=mesh`` (once a raise naming the mesh slice) splits each
    tile's rows over the data shards, and the mesh's batch step resolves
    a duplicate across shards (the reference's
    ``test_hostbatch_feed.py`` sharded-feed case); a tile that does not
    split, or a sharding that is not a mesh, is refused."""
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.core.mesh import ShardedArray, build_mesh
    from advanced_scrapper_tpu_torch.obs import stages
    from advanced_scrapper_tpu_torch.parallel.sharded import make_sharded_dedup

    mesh = build_mesh(8, 1, devices=["cpu"] * 8)
    step = make_sharded_dedup(mesh, make_params())
    batch, block = 64, 128
    rng = np.random.RandomState(5)
    base = rng.randint(32, 127, size=(batch, block), dtype=np.uint8)
    base[batch // 2] = base[3]  # a duplicate across shards (4 vs 0)
    b = HostBatcher(block)
    b.feed([base[i].tobytes() for i in range(batch)], start_tag=0)
    b.close()
    before = stages.sharded_device_counters("feed")
    feed = DeviceFeed(b, batch, depth=2, sharding=mesh)
    got = []
    for n, t_dev, l_dev, tags in feed:
        assert isinstance(t_dev, ShardedArray) and t_dev.spec == ("data", None)
        assert [p.shape for p in t_dev.pieces] == [(batch // 8, block)] * 8
        assert np.array_equal(t_dev.numpy(), base)
        rep, _h = step(t_dev, l_dev)
        got.append((rep.numpy()[:n], tags[:n]))
    feed.join()
    assert len(got) == 1
    rep, tags = got[0]
    assert rep[batch // 2] == 3 and tags.tolist() == list(range(batch))
    after = stages.sharded_device_counters("feed")
    assert all(after[str(s)]["device_puts"] - before.get(str(s), {}).get("device_puts", 0) == 2
               for s in range(8))
    with pytest.raises(ValueError, match="does not split"):
        DeviceFeed(HostBatcher(8), 12, sharding=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        DeviceFeed(HostBatcher(8), 8, sharding=(None, None))
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceFeed(b, 4)


# -- stream_signatures ----------------------------------------------------------


@pytest.fixture(scope="module")
def stream_docs():
    rng = np.random.RandomState(0)
    docs = [bytes(rng.randint(32, 127, size=rng.randint(0, 300), dtype=np.uint8))
            for _ in range(70)]
    return docs + docs[:6] + ["ünïcödé text that is long enough " * 3]


def _by_tag(batches) -> dict:
    out = {}
    for tags, sigs, keys in batches:
        assert len(tags) == len(sigs) == len(keys)
        for t, s, k in zip(tags.tolist(), sigs, keys):
            assert t not in out
            out[t] = (s, k)
    return out


@pytest.fixture(scope="module")
def ref_streams(stream_docs):
    cfg = RefConfig(block_len=128, batch_size=16)
    return {bits: _by_tag(ref_stream(stream_docs, cfg=cfg, sig_bits=bits)) for bits in (16, 32)}


@pytest.mark.parametrize("sig_bits", [16, 32])
@pytest.mark.parametrize("feed_workers", [1, 2])
@pytest.mark.parametrize("prefer_native", [True, False], ids=["native", "python"])
def test_stream_signatures_match_reference(stream_docs, ref_streams, sig_bits, feed_workers,
                                           prefer_native):
    before = threading.active_count()
    cfg = DedupConfig(block_len=128, batch_size=16)
    got = _by_tag(stream_signatures(stream_docs, cfg=cfg, sig_bits=sig_bits,
                                    feed_workers=feed_workers, prefer_native=prefer_native,
                                    device="cpu"))
    want = ref_streams[sig_bits]
    assert sorted(got) == sorted(want) == list(range(len(stream_docs)))
    for t, (ws, wk) in want.items():
        gs, gk = got[t]
        assert gs.dtype == ws.dtype == (np.uint16 if sig_bits == 16 else np.uint32)
        assert gk.dtype == wk.dtype == np.uint32 and gk.shape == (cfg.num_bands,)
        assert np.array_equal(gs, ws) and np.array_equal(gk, wk), t
    assert _threads_settle(before)


def test_stream_signatures_rejects_other_widths():
    with pytest.raises(ValueError, match="sig_bits"):
        next(stream_signatures([b"abcdef"], sig_bits=8, device="cpu"))


def test_stream_signatures_consumer_error_stops_producer_promptly():
    """A consumer that leaves stops the producer: the batcher closes and
    the unbounded ``docs`` iterable is no longer pulled."""
    before = threading.active_count()
    pulled = {"n": 0}

    def docs():
        for i in itertools.count():
            pulled["n"] += 1
            yield b"doc %d" % i

    gen = stream_signatures(docs(), batch_size=8, block=64, device="cpu")
    next(gen)
    gen.close()
    time.sleep(0.3)
    n = pulled["n"]
    time.sleep(0.3)
    assert pulled["n"] == n, "producer kept consuming after close"
    assert _threads_settle(before)


def test_stream_signatures_surfaces_producer_death():
    """A producer that dies mid-corpus is not a short stream: it raises."""
    def docs():
        yield b"first document, long enough"
        raise OSError("source went away")

    with pytest.raises(RuntimeError, match="producer died") as ei:
        for _ in stream_signatures(docs(), batch_size=4, block=64, device="cpu"):
            pass
    assert isinstance(ei.value.__cause__, OSError)


def test_stream_signatures_surfaces_an_exploding_batcher(monkeypatch):
    class Exploding(HostBatcher):
        def pop_batch(self, batch, *, timeout_ms=-1, min_fill=1):
            raise RuntimeError("batcher exploded")

    monkeypatch.setattr(feed_mod, "HostBatcher", Exploding)
    with pytest.raises(RuntimeError, match="died mid-stream") as ei:
        for _ in stream_signatures([b"abcdefgh"] * 10, batch_size=4, block=64, device="cpu"):
            pass
    assert "batcher exploded" in str(ei.value.__cause__)
