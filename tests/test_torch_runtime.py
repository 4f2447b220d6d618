"""The port's stage-graph runtime (``advanced_scrapper_tpu_torch/runtime``)
held to the reference's semantics: every case runs on both packages'
runtimes (``rt``), as ``tests/test_runtime.py`` pins the reference's —
close propagation, error fan-out, backpressure at capacity, several
workers a stage, ``RETRY``/``DONE`` sources, ``pop_batch``'s ``min_fill``.
Every graph is joined with a timeout; every blocking wait has one."""

from __future__ import annotations

import queue as _stdqueue
import threading
import time

import pytest

from advanced_scrapper_tpu import runtime as ref_runtime
from advanced_scrapper_tpu_torch import runtime as port_runtime


@pytest.fixture(params=["reference", "port"])
def rt(request):
    return ref_runtime if request.param == "reference" else port_runtime


def _locked_iter(rt, seq):
    it = iter(seq)
    lock = threading.Lock()

    def pull():
        with lock:
            return next(it, rt.DONE)

    return pull


def _finish(g):
    g.stop()
    g.join(timeout=10, raise_error=False)
    assert not g.running()


# -- Edge ---------------------------------------------------------------------


def test_edge_fifo_and_close_drain(rt):
    e = rt.Edge("x", capacity=8)
    for i in range(5):
        assert e.put(i)
    e.close()
    assert not e.put(99)
    assert list(e) == [0, 1, 2, 3, 4]
    assert e.pop() is rt.DONE


def test_edge_backpressure_blocks_then_wakes(rt):
    e = rt.Edge("x", capacity=2)
    assert e.put(1) and e.put(2)
    done = threading.Event()

    def blocked_put():
        assert e.put(3)
        done.set()

    t = threading.Thread(target=blocked_put, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not done.is_set(), "put must block on a full edge"
    assert e.pop() == 1
    t.join(timeout=5)
    assert done.is_set() and not t.is_alive()
    assert e.put(4, timeout=0.01) is False


def test_edge_pop_batch_min_fill_full_tile(rt):
    e = rt.Edge("x", capacity=16)
    got: list = []
    t = threading.Thread(target=lambda: got.append(e.pop_batch(8, min_fill=8, timeout=10)),
                         daemon=True)
    t.start()
    for i in range(4):
        e.put(i)
    time.sleep(0.15)
    assert not got, "min_fill pop must wait for the full tile"
    for i in range(4, 8):
        e.put(i)
    t.join(timeout=5)
    assert got == [list(range(8))]


def test_edge_min_fill_clamps_to_capacity(rt):
    e = rt.Edge("x", capacity=4)
    for i in range(4):
        e.put(i)
    assert e.pop_batch(16, min_fill=16, timeout=5) == [0, 1, 2, 3]


def test_edge_rejected_put_wakes_min_fill_waiter(rt):
    e = rt.Edge("x", capacity=8)
    e.put(0)
    got: list = []
    t = threading.Thread(target=lambda: got.append(e.pop_batch(8, min_fill=4, timeout=10)),
                         daemon=True)
    t.start()
    time.sleep(0.1)
    e._rejects += 1  # an upstream cap rejected a push: no more items soon
    with e._lock:
        e._not_empty.notify_all()
    t.join(timeout=5)
    assert got == [[0]]


def test_edge_timeout_yields_partial(rt):
    e = rt.Edge("x", capacity=8)
    e.put(1)
    assert e.pop_batch(4, min_fill=4, timeout=0.05) == [1]
    assert e.pop_batch(4, min_fill=4, timeout=0.05) == []
    assert e.pop(timeout=0.01) is rt.RETRY


def test_edge_queue_compat_surface(rt):
    e = rt.Edge("x", capacity=2)
    e.put(1)
    assert e.qsize() == 1 and not e.empty()
    assert e.get(timeout=0.1) == 1
    with pytest.raises(_stdqueue.Empty):
        e.get(timeout=0.01)
    e.put_nowait(2)
    e.put_nowait(3)
    with pytest.raises(_stdqueue.Full):
        e.put_nowait(4)
    e.task_done()
    e.close()
    with pytest.raises(rt.EdgeClosed):
        e.put_nowait(5)
    assert len(e) == 2
    assert e.get(timeout=0.1) == 2 and e.get(timeout=0.1) == 3
    t0 = time.monotonic()
    with pytest.raises(_stdqueue.Empty):
        e.get(timeout=5)
    assert time.monotonic() - t0 < 1, "closed edge must not wait the timeout"


def test_edge_closes_when_its_last_producer_is_done(rt):
    e = rt.Edge("x", capacity=4)
    e.register_producer()
    e.register_producer()
    e.producer_done()
    assert not e.closed()
    e.producer_done()
    assert e.closed()
    snap = e.snapshot()
    assert (snap["edge"], snap["depth"], snap["capacity"], snap["closed"]) == ("x", 0, 4, True)


# -- StageGraph ---------------------------------------------------------------


def test_graph_pipeline_orders_and_drains(rt):
    g = rt.StageGraph("t")
    mid = g.edge("mid", capacity=4)
    out = g.edge("out", capacity=4)
    g.stage("gen", source=_locked_iter(rt, range(20)), out_edge=mid)
    g.stage("double", fn=lambda x: x * 2, in_edge=mid, out_edge=out)
    g.start()
    assert list(out) == [i * 2 for i in range(20)]
    g.join(timeout=10)
    assert not g.running()


@pytest.mark.parametrize("workers", [1, 3])
def test_graph_several_workers_close_edge_after_last_producer(rt, workers):
    g = rt.StageGraph("t")
    mid = g.edge("mid", capacity=8)
    out = g.edge("out", capacity=8)
    g.stage("gen", source_iter=iter(range(40)), out_edge=mid, workers=workers)
    g.stage("id", fn=lambda x: x, in_edge=mid, out_edge=out, workers=workers)
    g.start()
    assert sorted(out) == list(range(40))
    g.join(timeout=10)
    assert not g.running()


def test_graph_none_filters_and_fan_out(rt):
    g = rt.StageGraph("t")
    mid = g.edge("mid", capacity=4)
    out = g.edge("out", capacity=4)
    g.stage("gen", source=_locked_iter(rt, range(6)), out_edge=mid)
    g.stage("explode", fn=lambda x: None if x % 2 else [x, x], in_edge=mid,
            out_edge=out, fan_out=True)
    g.start()
    assert list(out) == [0, 0, 2, 2, 4, 4]
    g.join(timeout=10)


def test_graph_source_retry_then_done(rt):
    """A source that says RETRY is polled again; DONE ends the stage and
    closes its out edge."""
    calls = iter([rt.RETRY, 1, rt.RETRY, rt.RETRY, 2, rt.DONE])
    g = rt.StageGraph("t")
    out = g.edge("out", capacity=4)
    g.stage("gen", source=lambda: next(calls), out_edge=out)
    g.start()
    assert list(out) == [1, 2]
    g.join(timeout=10)


def test_graph_worker_init_close_bracket_context(rt):
    events = []

    def init():
        events.append("init")
        return {"n": 0}

    def fn(item, ctx):
        ctx["n"] += 1
        return item

    g = rt.StageGraph("t")
    src = g.edge("src", capacity=4)
    out = g.edge("out", capacity=4)
    g.stage("gen", source=_locked_iter(rt, range(3)), out_edge=src)
    g.stage("work", fn=fn, in_edge=src, out_edge=out, worker_init=init,
            worker_close=lambda ctx: events.append(("close", ctx["n"])))
    g.start()
    assert list(out) == [0, 1, 2]
    g.join(timeout=10)
    assert events == ["init", ("close", 3)]


def test_graph_error_fans_out_and_join_reraises(rt):
    g = rt.StageGraph("t")
    mid = g.edge("mid", capacity=2)
    out = g.edge("out", capacity=2)

    def boom(x):
        if x == 3:
            raise ValueError("boom")
        return x

    g.stage("gen", source=_locked_iter(rt, range(100)), out_edge=mid)
    g.stage("b", fn=boom, in_edge=mid, out_edge=out)
    g.start()
    assert len(list(out)) < 100  # the close wakes the consumer
    with pytest.raises(RuntimeError, match="worker died") as ei:
        g.join(timeout=10)
    assert isinstance(ei.value.__cause__, ValueError)
    assert isinstance(g.error, ValueError)
    assert not g.running()


def test_graph_source_iter_error_fails_graph(rt):
    def gen():
        yield 1
        raise OSError("encode died")

    g = rt.StageGraph("t")
    out = g.edge("out", capacity=4)
    g.stage("gen", source_iter=gen(), out_edge=out, workers=2)
    g.start()
    assert list(out) == [1]
    with pytest.raises(RuntimeError):
        g.join(timeout=10)
    assert isinstance(g.error, OSError)


def test_graph_worker_init_failure_fails_graph(rt):
    def bad_init():
        raise OSError("no transport")

    g = rt.StageGraph("t")
    src = g.edge("src", capacity=2)
    out = g.edge("out", capacity=2)
    g.stage("gen", source=_locked_iter(rt, range(5)), out_edge=src)
    g.stage("w", fn=lambda x, ctx: x, in_edge=src, out_edge=out, worker_init=bad_init)
    g.start()
    list(out)
    with pytest.raises(RuntimeError):
        g.join(timeout=10)
    assert isinstance(g.error, OSError)


def test_graph_stop_aborts_without_draining(rt):
    g = rt.StageGraph("t")
    mid = g.edge("mid", capacity=2)
    gate = threading.Event()
    seen = []

    def slow(x):
        gate.wait(5)
        seen.append(x)

    g.stage("gen", source=_locked_iter(rt, range(50)), out_edge=mid)
    g.stage("slow", fn=slow, in_edge=mid)
    g.start()
    time.sleep(0.1)
    g.stop()
    gate.set()
    g.join(timeout=10)
    assert not g.running() and len(seen) < 50


def test_graph_declaration_errors(rt):
    g = rt.StageGraph("t")
    e = g.edge("e", capacity=1)
    assert g.edge("e") is e
    with pytest.raises(ValueError, match="source"):
        g.stage("none")
    with pytest.raises(ValueError, match="both"):
        g.stage("two", source=lambda: rt.DONE, source_iter=[1])
    with pytest.raises(ValueError, match="both"):
        g.stage("mixed", source=lambda: rt.DONE, in_edge=e)
    g.stage("ok", source=lambda: rt.DONE)
    g.start()
    with pytest.raises(RuntimeError, match="started"):
        g.stage("late", source=lambda: rt.DONE)
    g.join(timeout=10)


def test_drain_snapshot_shows_in_flight_and_depths(rt):
    g = rt.StageGraph("snapgraph")
    mid = g.edge("mid", capacity=8)
    out = g.edge("out", capacity=8)
    gate = threading.Event()

    def slow(x):
        gate.wait(5)
        return x

    g.stage("gen", source=_locked_iter(rt, range(6)), out_edge=mid)
    g.stage("slow", fn=slow, in_edge=mid, out_edge=out)
    g.start()
    try:
        time.sleep(0.2)
        snap = g.drain_snapshot()
        assert snap["graph"] == "snapgraph" and snap["error"] is None
        assert snap["stages"]["slow"]["in_flight"] == ["int"]
        assert snap["stages"]["slow"]["workers"] == 1
        depths = {e["edge"]: e["depth"] for e in snap["edges"]}
        assert depths["mid"] >= 1
    finally:
        gate.set()
    assert list(out) == list(range(6))
    g.join(timeout=10)


# -- what the port keeps as plain numbers, and what it leaves out -------------


def test_port_edge_counts_items_and_stalls():
    e = port_runtime.Edge("x", capacity=1)
    assert e.put(1)
    assert e.put(2, timeout=0.05) is False
    assert e.pop() == 1
    assert e.pop(timeout=0.05) is port_runtime.RETRY
    snap = e.snapshot()
    assert (snap["in"], snap["out"]) == (1, 1)
    assert snap["put_stall_s"] >= 0.04 and snap["get_stall_s"] >= 0.04


def test_port_graph_pause_is_not_ported():
    """The pause gate is ported: a ``pausable`` stage waits it out, a stage
    that is not pausable does not."""
    pause = port_runtime.PauseGate()
    g = port_runtime.StageGraph("t", pause=pause)
    mid = g.edge("mid", capacity=8)
    out = g.edge("out", capacity=8)
    stamps: list[float] = []
    g.stage("gen", source_iter=range(2), out_edge=mid)
    g.stage("w", fn=lambda x: stamps.append(time.monotonic()) or x, in_edge=mid,
            out_edge=out, pausable=True)
    pause.trigger(0.4)
    t0 = time.monotonic()
    g.start()
    assert list(out) == [0, 1]
    g.join(timeout=10)
    assert stamps[0] - t0 >= 0.3, "a pausable stage must wait out the gate"
    assert g.pause is pause


def test_runtime_imports_no_torch():
    """The matcher's verify-pool workers may import the runtime: it must
    not load torch."""
    import subprocess
    import sys

    code = ("import sys, advanced_scrapper_tpu_torch.runtime; "
            "sys.exit('torch' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code], timeout=60).returncode == 0


def test_port_graph_threads_end_with_the_graph():
    before = threading.active_count()
    g = port_runtime.StageGraph("t")
    out = g.edge("out", capacity=2)
    g.stage("gen", source=lambda: port_runtime.RETRY, out_edge=out, workers=3)
    g.start()
    assert threading.active_count() == before + 3
    _finish(g)
    assert threading.active_count() == before
