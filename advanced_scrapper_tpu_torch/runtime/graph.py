"""Stage-graph scheduler: edges, stages, and the graph that runs them.

A copy of the reference's ``runtime/graph.py``, its telemetry, trace spans,
crash-snapshot fault hook, pause gate and ``FanoutPool`` (the index
fleet's per-shard fan-out) included.

**How do items move.**  An :class:`Edge` is a bounded FIFO owned by the
graph.  Producers ``put`` (blocking while full: backpressure is the
default), consumers ``pop`` one item or ``pop_batch`` with the full-tile
``min_fill`` discipline (wait for k items unless a timeout, a close, or a
producer's rejected push says "dispatch what you have").  Edges also
speak the ``queue.Queue`` surface (``get``/``put``/``task_done``/``qsize``).

**What bounds them.**  Capacity, declared per edge.  ``min_fill`` is
clamped to capacity so a consumer never waits for more items than the
edge may hold.

**Who wakes whom.**  Closes are one-way and wake every waiter.  An edge
closes when its last producer stage exits, so drains propagate in
topological order.  A producer whose timed put is rejected wakes
``min_fill`` waiters.  A failing worker fails the whole graph: every edge
closes, every blocked peer wakes, and :meth:`StageGraph.join` re-raises
the first error.

**What it exports.**  Each edge's items in and out and the seconds its
producers and consumers waited (``astpu_edge_items_total``,
``astpu_edge_stall_seconds_total``, and the scrape-time gauges
``astpu_edge_depth`` / ``astpu_edge_capacity``), each stage's items and
busy seconds (``astpu_stage_items_total``,
``astpu_stage_busy_seconds_total``), all no-ops while telemetry is off; the
same numbers as plain values in :meth:`Edge.snapshot` and
:meth:`StageGraph.drain_snapshot`.  A stage with a ``tag`` runs each item
under a trace span.  Every started graph is registered
(:func:`live_graphs`, :func:`snapshot_all`), and a flight-recorder fault
hook lands every live graph's snapshot in the ring before a crash dump.

Pure Python, no torch: the matcher's verify-pool workers may import it.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

from advanced_scrapper_tpu_torch.obs import telemetry, trace

__all__ = [
    "DONE", "RETRY", "Edge", "EdgeClosed", "FanoutPool", "Stage", "StageGraph",
    "live_graphs", "snapshot_all",
]

class _Sentinel:
    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<runtime.{self._name}>"


#: returned by :meth:`Edge.pop` (and accepted from stage sources) when the
#: stream is exhausted: closed and drained, no more items will ever come.
DONE = _Sentinel("DONE")

#: returned by a stage source (or :meth:`Edge.pop` on timeout) meaning
#: "nothing yet — poll again".
RETRY = _Sentinel("RETRY")


class EdgeClosed(RuntimeError):
    """Raised by :meth:`Edge.put_nowait` on a closed edge (the blocking
    :meth:`Edge.put` returns False instead)."""


class Edge:
    """Named bounded FIFO between stages.  Thread-safe.  ``capacity=None``
    means unbounded; bounded edges block producers when full."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(
        self, name: str, capacity: int | None = None, *, graph: str = "-",
        instance: str | None = None,
    ):
        self.name = name
        self.graph = graph
        # graph-owned edges take the graph's instance label; a bare edge
        # draws its own, so two live edges never replace each other's gauges
        graph_owned = instance is not None
        if instance is None:
            with Edge._seq_lock:
                instance = f"e{Edge._seq}"
                Edge._seq += 1
        self.capacity = capacity if capacity and capacity > 0 else None
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._rejects = 0  # timed-out or refused puts; wakes min_fill waiters
        self._producers = 0
        self._in = 0
        self._out = 0
        #: seconds producers waited on a full edge, consumers on an empty one
        self.put_stall_s = 0.0
        self.get_stall_s = 0.0
        self._instrument(graph, instance)
        if not graph_owned:
            with _live_lock:  # bare edges show in a fault dump themselves
                _BARE_EDGES.add(self)

    def _instrument(self, graph: str, instance: str) -> None:
        """The reference's series.  Counters are keyed by (graph, edge)
        without the instance label (graphs are built per call, and
        per-instance counters would pile up in the registry); gauges carry
        it and are swept with the edge."""
        labels = {"graph": graph, "edge": self.name}
        self._m_in = telemetry.counter(
            "astpu_edge_items_total", "items accepted by the edge", dir="in", **labels,
        )
        self._m_out = telemetry.counter(
            "astpu_edge_items_total", "items handed to consumers", dir="out", **labels,
        )
        self._m_stall_put = telemetry.counter(
            "astpu_edge_stall_seconds_total",
            "seconds producers spent blocked on a full edge", side="put", **labels,
        )
        self._m_stall_get = telemetry.counter(
            "astpu_edge_stall_seconds_total",
            "seconds consumers spent waiting on an empty edge", side="get", **labels,
        )
        telemetry.gauge_fn(
            "astpu_edge_depth", lambda e: len(e._items), owner=self,
            help="items buffered on the edge", g=instance, **labels,
        )
        telemetry.gauge_fn(
            "astpu_edge_capacity", lambda e: e.capacity or 0, owner=self,
            help="edge capacity (0 = unbounded)", g=instance, **labels,
        )

    def _stalled_put(self, seconds: float) -> None:
        self.put_stall_s += seconds
        self._m_stall_put.inc(seconds)

    def _stalled_get(self, seconds: float) -> None:
        self.get_stall_s += seconds
        self._m_stall_get.inc(seconds)

    # -- producer side -----------------------------------------------------

    def register_producer(self) -> "Edge":
        """Count an (external or stage) producer; the edge closes when the
        count, once positive, returns to zero."""
        with self._lock:
            self._producers += 1
        return self

    def producer_done(self) -> None:
        with self._lock:
            self._producers -= 1
            if self._producers <= 0 and not self._closed:
                self._close_locked()

    def put(self, item, timeout: float | None = None) -> bool:
        """Append ``item``; blocks while full.  Returns False (and wakes
        ``min_fill`` waiters) when the edge is closed or the timeout
        expires without space."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._closed:
                    self._rejects += 1
                    self._not_empty.notify_all()
                    return False
                if self.capacity is None or len(self._items) < self.capacity:
                    self._items.append(item)
                    self._in += 1
                    self._m_in.inc()
                    self._not_empty.notify()
                    return True
                t0 = time.perf_counter()
                if deadline is None:
                    self._not_full.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._not_full.wait(remaining):
                        self._stalled_put(time.perf_counter() - t0)
                        self._rejects += 1
                        self._not_empty.notify_all()
                        return False
                self._stalled_put(time.perf_counter() - t0)

    # -- consumer side -----------------------------------------------------

    def pop(self, timeout: float | None = None):
        """One item, else :data:`DONE` (closed and drained) or
        :data:`RETRY` (timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._items:
                    return self._pop_locked()
                if self._closed:
                    return DONE
                t0 = time.perf_counter()
                if deadline is None:
                    self._not_empty.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._not_empty.wait(remaining):
                        self._stalled_get(time.perf_counter() - t0)
                        return RETRY
                self._stalled_get(time.perf_counter() - t0)

    def pop_batch(
        self, max_n: int, *, min_fill: int = 1, timeout: float | None = None
    ) -> list:
        """Up to ``max_n`` items, waiting for at least ``min_fill`` of them
        (clamped to capacity) unless a close, a timeout, or a producer's
        rejected push ends the wait first.  Returns a possibly-empty list;
        emptiness + :meth:`closed` + empty depth together mean exhausted."""
        if self.capacity is not None:
            min_fill = min(min_fill, self.capacity)
        min_fill = max(1, min(min_fill, max_n))
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            rejects_seen = self._rejects
            while (
                len(self._items) < min_fill
                and not self._closed
                and self._rejects == rejects_seen
            ):
                t0 = time.perf_counter()
                if deadline is None:
                    self._not_empty.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._not_empty.wait(remaining):
                        self._stalled_get(time.perf_counter() - t0)
                        break
                self._stalled_get(time.perf_counter() - t0)
            out = []
            while self._items and len(out) < max_n:
                out.append(self._pop_locked())
            return out

    def _pop_locked(self):
        item = self._items.popleft()
        self._out += 1
        self._m_out.inc()
        self._not_full.notify()
        return item

    def __iter__(self) -> Iterator:
        while True:
            item = self.pop()
            if item is DONE:
                return
            yield item

    # -- queue.Queue compatibility -----------------------------------------

    def get(self, block: bool = True, timeout: float | None = None):
        """``queue.Queue.get``: raises ``queue.Empty`` on timeout and on a
        closed-and-drained edge."""
        item = self.pop(timeout=timeout if block else 0.0)
        if item is DONE or item is RETRY:
            raise _queue.Empty
        return item

    def get_nowait(self):
        return self.get(block=False)

    def put_nowait(self, item) -> None:
        if not self.put(item, timeout=0.0):
            raise _queue.Full if self._closed is False else EdgeClosed(
                f"edge '{self.name}' is closed"
            )

    def task_done(self) -> None:  # drain is tracked by close/DONE
        pass

    def qsize(self) -> int:
        with self._lock:
            return len(self._items)

    def empty(self) -> bool:
        return self.qsize() == 0

    def __len__(self) -> int:
        return self.qsize()

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """One-way: no further puts accepted; pops drain the remainder then
        report :data:`DONE`.  Wakes every waiter."""
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        self._closed = True
        self._not_empty.notify_all()
        self._not_full.notify_all()

    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "edge": self.name,
                "depth": len(self._items),
                "capacity": self.capacity or 0,
                "closed": self._closed,
                "in": self._in,
                "out": self._out,
                "put_stall_s": self.put_stall_s,
                "get_stall_s": self.get_stall_s,
            }


@dataclass
class Stage:
    """Declarative stage spec; the graph owns its threads and queues.

    Exactly one of ``source`` (a zero-arg puller returning an item,
    :data:`RETRY`, or :data:`DONE`; shared by all workers, so it must be
    thread-safe), ``source_iter`` (any iterable; the graph wraps it in a
    locked puller) or ``in_edge`` feeds the stage.  ``fn`` transforms one
    item; ``None`` results are filtered, and with ``fan_out=True`` an
    iterable result emits item by item.  ``worker_init``/``worker_close``
    bracket per-worker context; when ``worker_init`` is set, ``fn`` is
    called as ``fn(item, ctx)``.  ``pausable`` stages honour the graph's
    :class:`~.pause.PauseGate` between pop and work.
    """

    name: str
    fn: Callable | None = None
    in_edge: Edge | None = None
    out_edge: Edge | None = None
    source: Callable | None = None
    source_iter: Iterable | None = None
    workers: int = 1
    worker_init: Callable | None = None
    worker_close: Callable | None = None
    fan_out: bool = False
    pausable: bool = False
    #: ``tag(item) -> dict | None``: with the flight recorder on, each item
    #: runs under a ``<graph>.<stage>`` trace span carrying these fields
    tag: Callable | None = None
    # -- runtime state (owned by the graph) --
    live: int = field(default=0, repr=False)
    threads: list = field(default_factory=list, repr=False)


class StageGraph:
    """A set of stages wired by edges, run by one scheduler.

    Lifecycle: declare edges (:meth:`edge`) and stages (:meth:`stage`),
    :meth:`start`, optionally push into externally-produced edges (close
    them when done), consume a terminal edge (iterate it), then
    :meth:`join`, which re-raises the first worker error.  :meth:`stop`
    aborts: closes every edge and joins without draining.  ``pause`` (a
    :class:`~.pause.PauseGate` or None) holds the ``pausable`` stages.
    """

    def __init__(self, name: str, *, pause=None):
        self.name = name
        self.pause = pause
        with StageGraph._seq_lock:
            self._instance = str(StageGraph._seq)
            StageGraph._seq += 1
        self._edges: dict[str, Edge] = {}
        self._stages: dict[str, Stage] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._started = False
        self._in_flight: dict[tuple[str, int], str] = {}
        self._m_items: dict[str, object] = {}
        self._m_busy: dict[str, object] = {}

    _seq = 0
    _seq_lock = threading.Lock()

    def _stage_metrics(self, name: str):
        """The stage's items and busy-seconds counters, keyed by (graph,
        stage) without an instance label, as the edges' counters are."""
        m = self._m_items.get(name)
        if m is None:
            labels = {"graph": self.name, "stage": name}
            m = self._m_items[name] = telemetry.counter(
                "astpu_stage_items_total", "items processed by the stage", **labels,
            )
            self._m_busy[name] = telemetry.counter(
                "astpu_stage_busy_seconds_total", "seconds the stage spent inside its fn",
                **labels,
            )
        return m, self._m_busy[name]

    # -- construction ------------------------------------------------------

    def edge(self, name: str, capacity: int | None = None) -> Edge:
        """Declare (or fetch) the named edge."""
        e = self._edges.get(name)
        if e is None:
            e = self._edges[name] = Edge(
                name, capacity, graph=self.name, instance=self._instance
            )
        return e

    def stage(self, name: str, **kw) -> Stage:
        """Declare a stage (see :class:`Stage` for the spec fields)."""
        if self._started:
            raise RuntimeError("cannot add stages to a started graph")
        st = Stage(name=name, **kw)
        if st.source_iter is not None:
            if st.source is not None:
                raise ValueError(f"stage '{name}' cannot have both source and source_iter")
            st.source = _locked_iter_source(st.source_iter)
        if st.source is None and st.in_edge is None:
            raise ValueError(f"stage '{name}' needs a source or an in_edge")
        if st.source is not None and st.in_edge is not None:
            raise ValueError(f"stage '{name}' cannot have both source and in_edge")
        self._stages[name] = st
        if st.out_edge is not None:
            st.out_edge.register_producer()
        return st

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StageGraph":
        if self._started:
            return self
        self._started = True
        with _live_lock:
            _LIVE.add(self)
        for st in self._stages.values():
            st.live = st.workers
            for w in range(st.workers):
                t = threading.Thread(
                    target=self._run_worker,
                    args=(st, w),
                    name=f"astpu-{self.name}-{st.name}-{w}",
                    daemon=True,
                )
                st.threads.append(t)
                t.start()
        return self

    @property
    def error(self) -> BaseException | None:
        return self._error

    def fail(self, exc: BaseException) -> None:
        """First error wins; every edge closes so no peer stays blocked."""
        with self._lock:
            if self._error is None:
                self._error = exc
        self._stop.set()
        for e in self._edges.values():
            e.close()

    def stop(self) -> None:
        """Abort: wake and stop every worker without draining."""
        self._stop.set()
        for e in self._edges.values():
            e.close()

    def join(self, timeout: float | None = None, *, raise_error: bool = True):
        """Wait for every worker (``timeout`` bounds the total wait), then
        re-raise the first worker error (unless ``raise_error=False``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for st in self._stages.values():
            for t in st.threads:
                t.join(
                    timeout=None if deadline is None else max(0.0, deadline - time.monotonic())
                )
        if raise_error and self._error is not None:
            raise RuntimeError(f"stage-graph '{self.name}' worker died") from self._error
        return self

    def running(self) -> bool:
        return any(t.is_alive() for st in self._stages.values() for t in st.threads)

    # -- the worker loop ---------------------------------------------------

    def _run_worker(self, st: Stage, widx: int) -> None:
        m_items, m_busy = self._stage_metrics(st.name)
        ctx = None
        slot = (st.name, widx)
        try:
            if st.worker_init is not None:
                ctx = st.worker_init()
            while not self._stop.is_set():
                if st.source is not None:
                    item = st.source()
                else:
                    item = st.in_edge.pop(timeout=0.5)
                if item is RETRY:
                    continue
                if item is DONE:
                    break
                if st.pausable and self.pause is not None:
                    self.pause.wait(should_stop=self._stop.is_set)
                    if self._stop.is_set():
                        break
                self._in_flight[slot] = _describe(item)
                t0 = time.perf_counter()
                try:
                    if st.fn is None:
                        out = item
                    elif st.worker_init is not None:
                        out = st.fn(item, ctx)
                    elif trace.RECORDER.active and st.tag is not None:
                        with trace.span(f"{self.name}.{st.name}", **(st.tag(item) or {})):
                            out = st.fn(item)
                    else:
                        out = st.fn(item)
                finally:
                    m_busy.inc(time.perf_counter() - t0)
                    self._in_flight.pop(slot, None)
                m_items.inc()
                if out is None or st.out_edge is None:
                    continue
                if st.fan_out:
                    for o in out:
                        if not st.out_edge.put(o):
                            break
                elif not st.out_edge.put(out):
                    break  # closed under us: the graph is stopping or failing
        except BaseException as e:
            self.fail(e)
        finally:
            if st.worker_close is not None and ctx is not None:
                try:
                    st.worker_close(ctx)
                except Exception:
                    pass
            with self._lock:
                st.live -= 1
                last = st.live == 0
            if last and st.out_edge is not None:
                st.out_edge.producer_done()

    # -- observability -----------------------------------------------------

    def drain_snapshot(self) -> dict:
        """Whole-graph state: per-stage live worker counts and in-flight
        item descriptions, per-edge depths and counts."""
        in_flight = dict(self._in_flight)
        stages = {
            name: {
                "workers": st.live,
                "in_flight": [v for (s, _w), v in in_flight.items() if s == name],
            }
            for name, st in self._stages.items()
        }
        return {
            "graph": self.name,
            "instance": self._instance,
            "error": None if self._error is None else repr(self._error),
            "stages": stages,
            "edges": [e.snapshot() for e in self._edges.values()],
        }


def _locked_iter_source(items: Iterable) -> Callable:
    """Wrap an iterable as a thread-safe stage source: workers draw items
    under one lock (generators are not re-entrant), :data:`DONE` on
    exhaustion.  An exception raised by the iterator propagates out of the
    puller and fails the graph like any worker error."""
    it = iter(items)
    lock = threading.Lock()

    def _pull():
        with lock:
            return next(it, DONE)

    return _pull


def _describe(item) -> str:
    """A short description of an in-flight item (never the payload)."""
    if isinstance(item, (str, bytes)):
        return f"{type(item).__name__}[{len(item)}]"
    if isinstance(item, tuple):
        return f"tuple[{len(item)}]"
    return type(item).__name__


# -- crash-snapshot registry --------------------------------------------------

_live_lock = threading.Lock()
_LIVE: "weakref.WeakSet[StageGraph]" = weakref.WeakSet()
#: edges built outside a graph: the fault hook covers them directly
_BARE_EDGES: "weakref.WeakSet[Edge]" = weakref.WeakSet()


def live_graphs() -> list[StageGraph]:
    """Every started graph still referenced."""
    with _live_lock:
        return list(_LIVE)


def snapshot_all() -> list[dict]:
    """Drain snapshots of every live graph."""
    return [g.drain_snapshot() for g in live_graphs()]


def _record_snapshots(recorder) -> None:
    """Fault hook: land every live graph's snapshot (and touched bare
    edges, at most 64) in the flight-recorder ring before the dump is
    written.  A ``graphs`` summary goes first, so a fault before any graph
    started still shows the hook ran (``live=0``)."""
    snaps = snapshot_all()
    recorder.record("snapshot", "graphs", live=len(snaps))
    for snap in snaps:
        recorder.record("snapshot", "graph", **snap)
    with _live_lock:
        bare = list(_BARE_EDGES)
    touched = [e.snapshot() for e in bare]
    touched = [t for t in touched if t["in"] or t["depth"]][:64]
    if touched:
        recorder.record("snapshot", "edges", edges=touched)


# registered at import: a fault before any graph exists still writes the
# (live=0) summary
trace.add_fault_hook(_record_snapshots)


# -- bounded fan-out pool -----------------------------------------------------


class FanoutPool:
    """A tiny Edge-fed executor for bounded parallel fan-out.

    The index fleet's per-shard RPC fan-out (and any other remote hop)
    rides this instead of a bespoke ``ThreadPoolExecutor``: the task queue
    is a runtime :class:`Edge`, so depth/stall telemetry and the crash
    snapshot see remote work exactly like local stage work.
    """

    def __init__(self, workers: int, *, name: str = "fanout"):
        from concurrent.futures import Future

        self._Future = Future
        self.name = name
        self._tasks = Edge(f"{name}.tasks", None, graph=name)
        self._tasks.register_producer()
        self._threads = [
            threading.Thread(
                target=self._run, name=f"astpu-{name}-{i}", daemon=True
            )
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self._tasks.pop()
            if item is DONE:
                return
            fut, fn, args, kw = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kw))
            except BaseException as e:
                fut.set_exception(e)

    def submit(self, fn, *args, **kw):
        fut = self._Future()
        if not self._tasks.put((fut, fn, args, kw)):
            raise RuntimeError(f"FanoutPool '{self.name}' is shut down")
        return fut

    def map(self, fn, items: Iterable):
        return [self.submit(fn, it) for it in items]

    def shutdown(self, wait: bool = True) -> None:
        self._tasks.producer_done()
        if wait:
            for t in self._threads:
                t.join(timeout=30)
