"""The port's pipelined chunk dispatcher (``pipeline/dispatch.py``) and
the engine's dispatched chunk loop, on the CPU, against the JAX package.

The executor cases mirror ``tests/test_dispatch.py``: every tile
delivered once, the window resolution, worker and encode-generator errors
re-raised at the consumer, the watchdog (a hung put, a hung caller
dispatch, a quiet clean run), the OOM floor and markers.  The engine's
representatives and signatures equal the JAX engine's byte for byte at
every ``put_workers`` × ``dispatch_window`` with a chunk budget small
enough for many chunks, under the ``ASTPU_CHAOS_DISPATCH_OOM`` ladder, on
the legacy transport (``packed_h2d=False``) and after a prewarm.  Every
dispatcher is closed and every thread joined with a timeout."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.pipeline import dispatch as ref_dispatch
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.cpu.hostbatch import chunk_ranges
from advanced_scrapper_tpu_torch.pipeline import dedup, dispatch
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from advanced_scrapper_tpu_torch.pipeline.dispatch import (
    OOM_FLOOR_ROWS,
    DispatchTimeout,
    PipelinedDispatcher,
    dispatch_with_oom_backoff,
    is_resource_exhausted,
    resolve_dispatch_window,
    resolve_watchdog_s,
)
from test_torch_hashing import adversarial_corpus

BASE = dict(rerank=False, exact_verify_band=0.0)
#: a chunk budget of a few kB: ~30 chunks over the corpus, articles
#: longer than a chunk among them
SMALL_CHUNK = 8192


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this module's torch work: the suite runs
    several test processes at once, and each one's thread pool, spinning
    at its barriers, would take the cores the others need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus():
    return adversarial_corpus(np.random.RandomState(11), 48)


@pytest.fixture(scope="module")
def want(corpus):
    """The JAX engine's signatures and representatives, estimator-only."""
    ref = RefEngine(RefConfig(**BASE))
    return ref.signatures(corpus), np.asarray(ref.dedup_reps(corpus))


@pytest.fixture(scope="module")
def want_default(corpus):
    """The JAX engine's representatives at the default configuration."""
    return np.asarray(RefEngine(RefConfig()).dedup_reps(corpus))


@pytest.fixture(scope="module")
def want_unpacked(corpus):
    """The JAX engine on its legacy transport: estimator-only signatures,
    representatives and tiles, and the default configuration's
    representatives."""
    ref = RefEngine(RefConfig(**BASE, packed_h2d=False))
    sigs = ref.signatures(corpus)
    tiles = ref.last_tiles
    return (sigs, np.asarray(ref.dedup_reps(corpus)), tiles,
            np.asarray(RefEngine(RefConfig(packed_h2d=False)).dedup_reps(corpus)))


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(dedup, "CHUNK_BYTES", SMALL_CHUNK)


@pytest.fixture
def folds(monkeypatch):
    """Count the engine's ``fold_segments`` calls (one kernel launch each
    on the card)."""
    calls = []
    real = dedup.fold_segments

    def counted(*a, **kw):
        calls.append(a[2].numel())
        return real(*a, **kw)

    monkeypatch.setattr(dedup, "fold_segments", counted)
    return calls


@pytest.fixture
def chaos(monkeypatch):
    def arm(n: int):
        monkeypatch.setenv("ASTPU_CHAOS_DISPATCH_OOM", str(n))
        dispatch.reset_chaos_oom()

    yield arm
    monkeypatch.delenv("ASTPU_CHAOS_DISPATCH_OOM", raising=False)
    dispatch.reset_chaos_oom()


def _chunks_with_shingles(corpus, k=5) -> int:
    lens = np.fromiter(map(len, corpus), np.int64, count=len(corpus))
    return sum(1 for lo, hi in chunk_ranges(lens, SMALL_CHUNK) if (lens[lo:hi] >= k).any())


def _threads_settle(before: int, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    return threading.active_count() <= before


# -- the executor --------------------------------------------------------------


@pytest.mark.parametrize("put_workers,window", [(1, 0), (3, 2), (2, 5)])
def test_executor_delivers_every_tile_and_window_resolution(put_workers, window):
    before = threading.active_count()
    pipe = PipelinedDispatcher(
        iter(range(57)), pack=lambda x: x * 10, put=lambda x: x + 1,
        put_workers=put_workers, window=window, name="test.h2d",
    )
    try:
        got = sorted(pipe)  # the put pool may reorder; the set must be exact
    finally:
        pipe.close()
    assert got == [x * 10 + 1 for x in range(57)]
    assert pipe.lag_count == 57 and 0 <= pipe.lag_sum_s and pipe.lag_max_s >= 0
    assert pipe.watchdog_trips == 0
    for name, tally in pipe.times.items():  # every item timed once in every stage
        t = tally.as_dict()
        assert t["count"] == 57 and 0 <= t["max_s"] <= t["sum_s"], (name, t)
    assert _threads_settle(before)
    for args in ((0, 1), (0, 4), (7, 4), (0, 0), (-1, 3)):
        assert resolve_dispatch_window(*args) == ref_dispatch.resolve_dispatch_window(*args)
    assert resolve_dispatch_window(0, 1) == 2 and resolve_dispatch_window(7, 4) == 7


def test_executor_propagates_worker_errors():
    def bad_put(x):
        if x == 3:
            raise ValueError("boom in put")
        return x

    pipe = PipelinedDispatcher(iter(range(8)), pack=lambda x: x, put=bad_put, put_workers=2)
    try:
        with pytest.raises(RuntimeError, match="worker died") as ei:
            list(pipe)
        assert isinstance(ei.value.__cause__, ValueError)
    finally:
        pipe.close()
    pipe.close()  # idempotent


def test_executor_encode_generator_error_fails_graph():
    def gen():
        yield 1
        raise OSError("encode died")

    pipe = PipelinedDispatcher(gen(), pack=lambda x: x, put=lambda x: x)
    try:
        with pytest.raises(RuntimeError) as ei:
            list(pipe)
        assert isinstance(ei.value.__cause__, OSError)
    finally:
        pipe.close()


def test_executor_staged_lag_counts_the_wait_for_the_caller():
    """Items staged while the caller is busy wait on the edge: the lag
    shows it; the window bounds how many wait."""
    pipe = PipelinedDispatcher(iter(range(6)), pack=lambda x: x, put=lambda x: x, window=2)
    try:
        got = []
        for x in pipe:
            got.append(x)
            time.sleep(0.05)
    finally:
        pipe.close()
    assert got == list(range(6)) and pipe.lag_count == 6
    assert pipe.lag_max_s >= 0.03 and pipe.lag_sum_s >= pipe.lag_max_s
    dispatch_s = pipe.times["dispatch"]  # the caller's sleeps, on its thread
    assert dispatch_s.count == 6 and dispatch_s.sum_s >= 6 * 0.045
    assert pipe.times["dispatch_cpu"].sum_s < dispatch_s.sum_s / 2  # a sleep is no CPU


def test_executor_times_the_pack_on_its_thread():
    """A pack that sleeps shows in ``pack`` (wall) and not in ``pack_cpu``;
    the caller, waiting for it, shows it in ``wait``."""
    def slow_pack(x):
        time.sleep(0.02)
        return x

    pipe = PipelinedDispatcher(iter(range(4)), pack=slow_pack, put=lambda x: x)
    try:
        assert list(pipe) == list(range(4))
    finally:
        pipe.close()
    times = pipe.times
    assert times["pack"].count == 4 and times["pack"].sum_s >= 4 * 0.018
    assert times["pack_cpu"].sum_s < times["pack"].sum_s / 2
    assert times["wait"].sum_s >= 0.04


def test_watchdog_budget_resolution(monkeypatch):
    monkeypatch.delenv("ASTPU_DISPATCH_WATCHDOG_S", raising=False)
    assert resolve_watchdog_s() == 0.0
    assert resolve_watchdog_s(0.5) == 0.5
    monkeypatch.setenv("ASTPU_DISPATCH_WATCHDOG_S", "2.5")
    assert resolve_watchdog_s() == 2.5 and resolve_watchdog_s(1.0) == 1.0
    monkeypatch.setenv("ASTPU_DISPATCH_WATCHDOG_S", "nope")
    assert resolve_watchdog_s() == 0.0


def test_watchdog_trips_on_hung_put():
    before = threading.active_count()
    hang = threading.Event()

    def hung_put(x):
        hang.wait(30.0)
        return x

    pipe = PipelinedDispatcher(iter(range(4)), pack=lambda x: x, put=hung_put, watchdog_s=0.2)
    try:
        t0 = time.monotonic()
        with pytest.raises(DispatchTimeout):
            list(pipe)
        assert time.monotonic() - t0 < 5
        assert pipe.watchdog_trips == 1 and isinstance(pipe.error, DispatchTimeout)
    finally:
        hang.set()
        pipe.close(timeout=10)
    assert _threads_settle(before)


def test_watchdog_trips_on_hung_caller_dispatch():
    release = threading.Event()
    pipe = PipelinedDispatcher(iter(range(4)), pack=lambda x: x, put=lambda x: x,
                               watchdog_s=0.2)
    err = []

    def consume():
        try:
            for _item in pipe:
                release.wait(20.0)  # a hung device call on the first tile
        except DispatchTimeout as e:
            err.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5
        while pipe.error is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert isinstance(pipe.error, DispatchTimeout) and pipe.watchdog_trips == 1
    finally:
        release.set()
        t.join(timeout=5)
        pipe.close(timeout=10)
    assert not t.is_alive() and len(err) == 1


def test_watchdog_quiet_on_clean_run():
    before = threading.active_count()
    pipe = PipelinedDispatcher(iter(range(32)), pack=lambda x: x, put=lambda x: x,
                               watchdog_s=5.0)
    try:
        assert sorted(pipe) == list(range(32))
    finally:
        pipe.close()
    assert pipe.watchdog_trips == 0 and pipe.error is None
    assert _threads_settle(before)


# -- the OOM back-off ------------------------------------------------------------


def test_oom_backoff_floor_and_markers():
    for exc in (RuntimeError("RESOURCE_EXHAUSTED: oom"), MemoryError("Resource exhausted: HBM"),
                RuntimeError("ran out of memory on device"), ValueError("shape mismatch")):
        assert is_resource_exhausted(exc) == ref_dispatch.is_resource_exhausted(exc)
    assert not is_resource_exhausted(ValueError("shape mismatch"))
    # the allocator's own error, built on the CPU, with or without the words
    assert is_resource_exhausted(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried"))
    assert is_resource_exhausted(torch.cuda.OutOfMemoryError("allocation failed"))
    assert OOM_FLOOR_ROWS == ref_dispatch.OOM_FLOOR_ROWS

    calls = []
    with pytest.raises(ValueError):  # not an OOM: never split
        dispatch_with_oom_backoff(
            lambda c, i: (_ for _ in ()).throw(ValueError("boom")), 0, (None, 128),
            split=lambda i: calls.append(i) or [], rows_of=lambda i: i[1],
        )
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):  # at the floor
        dispatch_with_oom_backoff(
            lambda c, i: (_ for _ in ()).throw(RuntimeError("RESOURCE_EXHAUSTED: x")),
            0, (None, OOM_FLOOR_ROWS), split=lambda i: calls.append(i) or [],
            rows_of=lambda i: i[1],
        )
    assert not calls


@pytest.mark.parametrize("error", [RuntimeError("RESOURCE_EXHAUSTED: too big"),
                                   torch.cuda.OutOfMemoryError("CUDA out of memory")],
                         ids=["marker", "torch-oom"])
def test_oom_backoff_generic_fold_halves_to_success(error):
    def fn(carry, item):
        lo, hi = item
        if hi - lo > 128:
            raise error
        return carry + sum(range(lo, hi))

    def split(item):
        lo, hi = item
        mid = lo + (hi - lo) // 2
        return [(lo, mid), (mid, hi)]

    total = dispatch_with_oom_backoff(fn, 0, (0, 1024), split=split,
                                      rows_of=lambda it: it[1] - it[0])
    assert total == sum(range(1024))


def test_chaos_seam_budget(chaos):
    chaos(2)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            dispatch.maybe_inject_oom("dedup")
    dispatch.maybe_inject_oom("dedup")  # spent
    dispatch.reset_chaos_oom()
    with pytest.raises(RuntimeError, match="ASTPU_CHAOS_DISPATCH_OOM"):
        dispatch.maybe_inject_oom("dedup")


# -- the engine's dispatched chunk loop ------------------------------------------


@pytest.mark.parametrize("put_workers", [1, 2, 3])
@pytest.mark.parametrize("window", [0, 1, 4])
def test_engine_knobs_match_reference(corpus, want, small_chunks, folds, put_workers, window):
    before = threading.active_count()
    cfg = DedupConfig(**BASE, put_workers=put_workers, dispatch_window=window)
    eng = NearDupEngine(cfg, device="cpu")
    sigs = eng.signatures(corpus)
    assert sigs.dtype == np.uint32 and np.array_equal(sigs, want[0])
    chunks = _chunks_with_shingles(corpus)
    assert eng.last_chunks == len(folds) == chunks > 12 and eng.last_halvings == 0
    assert eng.last_dispatcher.lag_count == chunks
    reps = eng.dedup_reps(corpus)
    assert np.array_equal(reps, want[1])
    assert (reps != np.arange(len(corpus))).sum() > 5
    assert _threads_settle(before)


@pytest.mark.parametrize("budget", [0, 2])
def test_engine_one_chunk_runs_inline(corpus, want, folds, chaos, budget, monkeypatch):
    """A corpus of one chunk (a stream batch) is packed, copied and folded
    on the caller's thread: no dispatcher, no thread, the same output, the
    clock's laps once each; the OOM back-off still halves it."""
    monkeypatch.setattr(dedup, "SEGMENT_SHINGLES", 64)  # room to halve

    def no_graph(*a, **kw):
        raise AssertionError("a dispatcher for one chunk")

    monkeypatch.setattr(dedup, "PipelinedDispatcher", no_graph)
    before = threading.active_count()
    eng = NearDupEngine(DedupConfig(**BASE, put_workers=2), device="cpu")
    chaos(budget)
    sigs, _keys = eng.signatures_and_keys(corpus)
    assert threading.active_count() == before
    assert np.array_equal(sigs, want[0])
    assert eng.last_dispatcher is None and eng.last_chunks == 1
    assert eng.last_halvings == budget and len(folds) == 1 + budget
    assert set(eng.last_clock.seconds) >= {"encode", "copy", "fold"}
    assert np.array_equal(eng.dedup_reps(corpus), want[1])


def test_default_engine_through_the_dispatcher_matches_reference(corpus, small_chunks,
                                                                 want_default):
    cfg = DedupConfig(put_workers=2, dispatch_window=1)
    assert np.array_equal(NearDupEngine(cfg, device="cpu").dedup_reps(corpus), want_default)


@pytest.mark.parametrize("budget", [1, 3])
def test_engine_oom_ladder_converges_byte_identical(corpus, want, small_chunks, folds,
                                                    chaos, budget, monkeypatch):
    """Each injected OOM halves the chunk in hand (at a segment boundary,
    the text span of each half copied on its own): the fold is the same,
    with one more launch a halving."""
    monkeypatch.setattr(dedup, "SEGMENT_SHINGLES", 64)  # room to halve
    eng = NearDupEngine(DedupConfig(**BASE, put_workers=2), device="cpu")
    chaos(budget)
    sigs = eng.signatures(corpus)
    assert np.array_equal(sigs, want[0])
    assert eng.last_halvings == budget
    assert len(folds) == eng.last_chunks + budget == _chunks_with_shingles(corpus) + budget
    assert np.array_equal(eng.dedup_reps(corpus), want[1])  # the budget is spent


def test_engine_oom_ladder_to_the_floor_fails_clean(corpus, want, small_chunks, folds, chaos,
                                                    monkeypatch):
    """A budget deeper than the first chunk's halvings: the chunk halves
    down to one segment, which then raises; no thread is left, and the
    engine is reusable."""
    monkeypatch.setattr(dedup, "SEGMENT_SHINGLES", 64)
    before = threading.active_count()
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    eng.signatures(corpus)
    first = folds[0]  # the first chunk's segments
    folds.clear()
    chaos(50)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        eng.signatures(corpus)
    # the leftmost path g → ⌊g/2⌋ → ... → 1, every step an injected OOM
    depth = 0
    while first > 1:
        first //= 2
        depth += 1
    assert eng.last_halvings == depth and not folds
    assert _threads_settle(before)
    monkeypatch.delenv("ASTPU_CHAOS_DISPATCH_OOM")
    assert np.array_equal(eng.signatures(corpus), want[0])


def test_engine_real_oom_halves_until_it_fits(corpus, want, small_chunks, monkeypatch):
    """``torch.cuda.OutOfMemoryError`` from the fold (built on the CPU)
    engages the same ladder: chunks of more than 4 segments are halved."""
    real = dedup.fold_segments

    def tight(running, text, start, *a, **kw):
        if start.numel() > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
        return real(running, text, start, *a, **kw)

    monkeypatch.setattr(dedup, "fold_segments", tight)
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    assert np.array_equal(eng.signatures(corpus), want[0])
    assert eng.last_halvings > 0


def test_split_chunk_keeps_each_segment_bytes(corpus, small_chunks):
    eng = NearDupEngine(DedupConfig(**BASE), device="cpu")
    raw = list(corpus)
    k = eng.params.shingle_k
    for text, start, shingles, owner in eng._host_chunks(raw):
        g = start.numel()
        if g < 3:
            continue
        chunk = dedup._Chunk(text, start, shingles, owner, text_dev=text)
        halves = eng._split_chunk(chunk)
        assert chunk.text_dev is None and len(halves) == 2
        assert [h.start.numel() for h in halves] == [g // 2, g - g // 2]
        seen = 0
        for h in halves:
            for j in range(h.start.numel()):
                s, n = int(h.start[j]), int(h.shingles[j])
                orig = seen + j
                a = int(start[orig])
                assert bytes(h.text[s: s + n + k - 1].numpy()) == \
                    bytes(text[a: a + n + k - 1].numpy())
                assert int(h.owner[j]) == int(owner[orig])
            assert int(h.start[0]) == 0
            assert h.text.numel() == int((h.start + h.shingles).max()) + k - 1
            seen += h.start.numel()
        return
    pytest.fail("no chunk of three or more segments")


# -- the legacy transport and prewarm -------------------------------------------


@pytest.mark.parametrize("put_workers", [1, 2])
def test_unpacked_transport_matches_reference_and_packed(corpus, want, want_unpacked,
                                                         put_workers):
    ref_sigs, ref_reps, ref_tiles, _default = want_unpacked
    eng = NearDupEngine(DedupConfig(**BASE, packed_h2d=False, put_workers=put_workers),
                        device="cpu")
    sigs = eng.signatures(corpus)
    assert np.array_equal(sigs, ref_sigs)
    assert np.array_equal(sigs, want[0])  # the packed path's
    n_tiles = sum(1 for _ in eng._host_tiles(list(corpus)))
    assert eng.last_chunks == n_tiles == ref_tiles
    reps = eng.dedup_reps(corpus)
    assert np.array_equal(reps, ref_reps) and np.array_equal(reps, want[1])


def test_unpacked_default_engine_matches_reference(corpus, want_unpacked, want_default):
    got = NearDupEngine(DedupConfig(packed_h2d=False), device="cpu").dedup_reps(corpus)
    assert np.array_equal(got, want_unpacked[3]) and np.array_equal(got, want_default)


@pytest.mark.parametrize("rerank,prewarm,launches", [(False, 1, 1), (True, 1, 2),
                                                     (True, 5000, 2), (False, 300, 1)])
def test_prewarm_counts_warm_launches_and_leaves_the_output(corpus, want, want_default, folds,
                                                            rerank, prewarm, launches):
    cfg = DedupConfig(prewarm=prewarm) if rerank else DedupConfig(**BASE, prewarm=prewarm)
    eng = NearDupEngine(cfg, device="cpu")
    assert eng.prewarm_launches == launches and len(folds) == 1
    assert eng.prewarm(64) == launches and len(folds) == 2
    if rerank:
        assert np.array_equal(eng.dedup_reps(corpus), want_default)
    else:
        assert np.array_equal(eng.signatures(corpus), want[0])
        assert np.array_equal(eng.dedup_reps(corpus), want[1])


def test_prewarm_is_skipped_on_the_unpacked_transport(folds):
    """The reference's rule: ``cfg.prewarm`` runs only with ``packed_h2d``."""
    eng = NearDupEngine(DedupConfig(**BASE, packed_h2d=False, prewarm=1), device="cpu")
    assert eng.prewarm_launches == 0 and not folds


def test_sharded_methods_name_the_mesh_slice(corpus, want):
    """The sharded methods, once a raise naming the mesh slice, run their
    tile groups through the dispatcher (``dedup.sharded.h2d``): the
    representatives equal the reference's, one group a step, and
    ``prewarm_sharded`` warms one fold a shard."""
    from advanced_scrapper_tpu_torch.core.mesh import build_mesh

    eng = NearDupEngine(DedupConfig(**BASE, put_workers=2, dispatch_window=3), device="cpu")
    mesh = build_mesh(8, 1, devices=["cpu"] * 8)
    assert eng.prewarm_sharded(mesh) == 8
    assert np.array_equal(eng.dedup_reps_sharded(corpus, mesh), want[1])
    pipe = eng.last_dispatcher
    assert pipe is not None and pipe.window == 3
    assert pipe.times["put"].count == eng.last_tiles > 0
