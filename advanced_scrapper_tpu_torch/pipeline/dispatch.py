"""Pipelined device-dispatch executor, and the device-OOM back-off.

A copy of the reference's ``pipeline/dispatch.py`` on the port's stage
graph (``runtime/graph.py``).  The executor is workload-blind: ``pack``
and ``put`` are the caller's callables.

- the ``pack`` stage draws items off the caller's iterator
  (``source_iter``, a locked puller) and packs them on a worker thread,
  overlapping the next item's host work with the previous one's copy;
- the ``h2d`` stage (``put_workers`` threads) copies them to the device;
- the caller's thread drains the ``staged`` edge and dispatches: the
  dedup accumulator has one writer.  The edge's capacity is the dispatch
  window, so at most ``window + put_workers + 1`` items are resident on
  the device plus two packed ones awaiting their copy.

Each staged item is stamped as its put returns; the time to the caller's
pop is observed on the reference's
``astpu_dispatch_queue_lag_seconds{graph}`` histogram (``obs/devprof.py``)
and kept as plain numbers on the dispatcher (``lag_count``,
``lag_sum_s``, ``lag_max_s``): near-zero lag means the caller's dispatch is
the bottleneck, a sustained lag that the host pipeline runs ahead.  Beside it, ``times`` tallies each
item's seconds in every stage, taken on the thread that runs it: ``pack``
(wall) and ``pack_cpu`` (the pack thread's CPU time), ``put``, and on the
caller's thread ``wait`` (blocked on the staged edge), ``dispatch`` (from
handing an item over to asking for the next) and ``dispatch_cpu`` (the
caller's CPU time in it).  A stage whose CPU time falls far short of its
wall time was waiting: for the GIL, a lock or the device.  A watchdog (``watchdog_s`` or
``ASTPU_DISPATCH_WATCHDOG_S``) fails the graph with
:class:`DispatchTimeout` when no item makes progress within its budget,
counted in ``watchdog_trips`` and on
``astpu_dispatch_watchdog_trips_total``, after a flight-recorder dump
(``obs/trace.py``; the runtime's fault hook lands every live graph's
snapshot in the ring first).

Items may arrive out of order from the put pool; a worker error closes
every edge and re-raises at the consumer.

:func:`dispatch_with_oom_backoff` runs one dispatch and, when the device
runs out of memory (``torch.cuda.OutOfMemoryError`` or the reference's
``RESOURCE_EXHAUSTED`` markers, or the ``ASTPU_CHAOS_DISPATCH_OOM`` chaos
seam), splits the item in two and retries each half, down to a floor;
each halving is counted on ``astpu_dispatch_oom_backoff_total{plane}``
with a ``dispatch.oom_backoff`` event, each injected OOM on
``astpu_fault_injected_total{plane,kind}``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Iterable, Iterator

from advanced_scrapper_tpu_torch.obs import devprof, telemetry, trace
from advanced_scrapper_tpu_torch.runtime import DONE, StageGraph

__all__ = [
    "DispatchTimeout",
    "OOM_FLOOR_ROWS",
    "PipelinedDispatcher",
    "Tally",
    "auto_h2d_workers",
    "dispatch_with_oom_backoff",
    "is_resource_exhausted",
    "maybe_inject_oom",
    "reset_chaos_oom",
    "resolve_dispatch_window",
    "resolve_watchdog_s",
]


class DispatchTimeout(RuntimeError):
    """The dispatch watchdog tripped: no item made progress inside the
    wall-clock budget.  The graph is already torn down when this reaches
    the caller."""


def auto_h2d_workers() -> int:
    """Default put-thread count for the attached transport: 1.  The
    reference's ``core/mesh.py:auto_h2d_workers`` gives 4 only on its
    tunnelled TPU, where every transfer is a serialized round trip; a
    local card, like the reference's local backends, takes one."""
    return 1


def resolve_watchdog_s(watchdog_s: float | None = None) -> float:
    """Effective per-item watchdog budget: an explicit value wins, else
    ``ASTPU_DISPATCH_WATCHDOG_S`` (seconds; 0 = off, the default)."""
    if watchdog_s is not None and watchdog_s > 0:
        return float(watchdog_s)
    try:
        return float(os.environ.get("ASTPU_DISPATCH_WATCHDOG_S", "0") or 0)
    except ValueError:
        return 0.0


def resolve_dispatch_window(window: int, put_workers: int) -> int:
    """Effective staged-edge capacity: an explicit ``window`` wins, else
    ``max(2, put_workers)`` (double buffering, or a put-pool-deep window)."""
    if window and window > 0:
        return window
    return max(2, put_workers)


class Tally:
    """Count, sum and maximum of one stage's seconds, added from any
    thread."""

    __slots__ = ("count", "sum_s", "max_s", "_lock")

    def __init__(self):
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.sum_s += seconds
            self.max_s = max(self.max_s, seconds)

    def as_dict(self) -> dict:
        return {"count": self.count, "sum_s": self.sum_s,
                "mean_s": self.sum_s / max(self.count, 1), "max_s": self.max_s}


class PipelinedDispatcher:
    """Run ``items → pack → put`` as a stage graph and iterate the staged
    results in the caller's thread, which owns the dispatch.

    Iteration yields whatever ``put`` returned, ends when the iterator is
    exhausted and every staged item was handed over, and re-raises the
    first worker error (with the original as cause).  :meth:`close` stops
    the graph and joins its threads and the watchdog's.
    """

    def __init__(
        self,
        tiles: Iterable,
        *,
        pack: Callable,
        put: Callable,
        put_workers: int = 1,
        window: int = 0,
        name: str = "dedup.h2d",
        watchdog_s: float | None = None,
    ):
        window = resolve_dispatch_window(window, put_workers)
        #: the staged edge's capacity
        self.window = window
        self._watchdog_s = resolve_watchdog_s(watchdog_s)
        self._beat = time.monotonic()
        self._finished = threading.Event()
        #: watchdog trips, and the staged items' lag (put done → popped)
        self.watchdog_trips = 0
        self.lag_count = 0
        self.lag_sum_s = 0.0
        self.lag_max_s = 0.0
        self._lag_hist = devprof.queue_lag_histogram(name)
        #: each stage's seconds per item (see the module docstring)
        self.times = {k: Tally() for k in ("pack", "pack_cpu", "put", "wait", "dispatch",
                                           "dispatch_cpu")}
        times = self.times

        def timed_pack(item, _pack=pack):
            t0, c0 = time.perf_counter(), time.thread_time()
            packed = _pack(item)
            times["pack_cpu"].add(time.thread_time() - c0)
            times["pack"].add(time.perf_counter() - t0)
            return packed

        def stamped_put(item, _put=put):
            # stamped after the put returns: the copy is not lag
            t0 = time.perf_counter()
            staged = _put(item)
            done = time.perf_counter()
            times["put"].add(done - t0)
            return (done, staged)

        self._graph = StageGraph(name)
        # a fixed two-deep buffer: scaling it with the window would break
        # the window + put_workers + 1 bound on resident items
        packed = self._graph.edge("packed", capacity=2)
        self._staged = self._graph.edge("staged", capacity=window)
        self._graph.stage("pack", source_iter=tiles, fn=timed_pack, out_edge=packed)
        self._graph.stage(
            "h2d", in_edge=packed, fn=stamped_put, out_edge=self._staged,
            workers=max(1, put_workers),
        )
        self._graph.start()
        self._watchdog = None
        if self._watchdog_s > 0:
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True, name=f"astpu-{name}-watchdog"
            )
            self._watchdog.start()

    # -- watchdog ----------------------------------------------------------

    def beat(self) -> None:
        """Progress heartbeat: the iterator beats on every staged pop and
        on every re-entry (after the caller's dispatch returned), so a hang
        anywhere on the path leaves the beat stale."""
        self._beat = time.monotonic()

    def _watch(self) -> None:
        budget = self._watchdog_s
        tick = max(0.01, min(0.25, budget / 4))
        while not self._finished.wait(tick):
            if time.monotonic() - self._beat <= budget:
                continue
            # counted, dumped (the fault hooks land every live graph's
            # snapshot in the ring first), then the graph torn down: the
            # blocked consumer wakes on the closed staged edge and raises;
            # one stuck inside a hung device call cannot be woken from
            # here, but every worker exits
            self.watchdog_trips += 1
            telemetry.event_counter(
                "astpu_dispatch_watchdog_trips_total",
                "dispatch tiles that blew their wall-clock budget "
                "(graph torn down with a flight-recorder dump)",
            ).inc()
            trace.record("event", "dispatch.watchdog", graph=self._graph.name, budget_s=budget)
            trace.dump_on_fault(
                f"dispatch watchdog: no tile progress in {budget:.3g}s "
                f"on graph '{self._graph.name}'"
            )
            self._graph.fail(DispatchTimeout(
                f"no tile progress in {budget:.3g}s (graph '{self._graph.name}')"
            ))
            return

    @property
    def error(self) -> BaseException | None:
        return self._graph.error

    def __iter__(self) -> Iterator:
        while True:
            self.beat()
            t0 = time.perf_counter()
            item = self._staged.pop()
            popped, popped_cpu = time.perf_counter(), time.thread_time()
            self.beat()
            if item is DONE:
                self._finished.set()
                err = self._graph.error
                if err is not None:
                    if isinstance(err, DispatchTimeout):
                        raise err
                    raise RuntimeError("pipelined dispatch worker died mid-corpus") from err
                return
            staged_ts, payload = item
            self.times["wait"].add(popped - t0)
            lag = popped - staged_ts
            self.lag_count += 1
            self.lag_sum_s += lag
            self.lag_max_s = max(self.lag_max_s, lag)
            self._lag_hist.observe(lag)
            yield payload
            self.times["dispatch_cpu"].add(time.thread_time() - popped_cpu)
            self.times["dispatch"].add(time.perf_counter() - popped)

    def close(self, timeout: float = 30.0) -> None:
        """Stop the graph and join its threads (idempotent; safe
        mid-iteration on error paths)."""
        self._finished.set()
        self._graph.stop()
        deadline = time.monotonic() + timeout
        self._graph.join(timeout=timeout, raise_error=False)
        if self._watchdog is not None:
            self._watchdog.join(timeout=max(0.0, deadline - time.monotonic()))


# -- device-OOM back-off ------------------------------------------------------

#: the reference's halving floor, in tile rows; the engine's chunks pass
#: their own floor (one segment)
OOM_FLOOR_ROWS = 64

_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory")


def is_resource_exhausted(exc: BaseException) -> bool:
    """Does this exception say that a device allocation failed?
    ``torch.cuda.OutOfMemoryError``, or a message with the reference's
    markers (XLA's ``RESOURCE_EXHAUSTED:`` status, "out of memory")."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    s = f"{type(exc).__name__}: {exc}".lower()
    return any(m in s for m in _OOM_MARKERS)


_chaos_oom_lock = threading.Lock()
_chaos_oom_used = 0


def reset_chaos_oom() -> None:
    """Re-arm the ``ASTPU_CHAOS_DISPATCH_OOM`` budget."""
    global _chaos_oom_used
    with _chaos_oom_lock:
        _chaos_oom_used = 0


def maybe_inject_oom(plane: str) -> None:
    """Chaos seam: ``ASTPU_CHAOS_DISPATCH_OOM=N`` makes the next N
    dispatch attempts of the process raise a synthetic
    ``RESOURCE_EXHAUSTED``, so the halving ladder is exercised on a card
    that never runs out of memory."""
    spec = os.environ.get("ASTPU_CHAOS_DISPATCH_OOM", "")
    if not spec:
        return
    try:
        budget = int(spec)
    except ValueError:
        return
    if budget <= 0:
        return
    global _chaos_oom_used
    with _chaos_oom_lock:
        if _chaos_oom_used >= budget:
            return
        _chaos_oom_used += 1
    telemetry.event_counter(
        "astpu_fault_injected_total", "chaos faults injected, by plane and kind",
        plane="dispatch", kind="oom",
    ).inc()
    raise RuntimeError(
        f"RESOURCE_EXHAUSTED: injected device OOM on {plane} (ASTPU_CHAOS_DISPATCH_OOM)"
    )


def dispatch_with_oom_backoff(
    fn: Callable,
    carry,
    item,
    *,
    split: Callable,
    rows_of: Callable,
    floor: int = OOM_FLOOR_ROWS,
    plane: str = "dedup",
):
    """Run one device dispatch ``fn(carry, item) -> carry``, halving the
    item on device OOM.

    An out-of-memory error (or the injected chaos equivalent) splits the
    item with ``split(item)`` into two halves, each retried recursively,
    so a transient memory squeeze converges to the same fold at a smaller
    granularity.  At ``floor`` (``rows_of(item)``) the error propagates.
    Any other error propagates untouched.  The halves run after the
    handler has returned, so the failed attempt's frames (and the device
    memory they hold) are released first.
    """
    try:
        maybe_inject_oom(plane)
        return fn(carry, item)
    except Exception as e:
        if not is_resource_exhausted(e):
            raise
        rows = int(rows_of(item))
        if rows <= floor or rows < 2:
            raise
    telemetry.event_counter(
        "astpu_dispatch_oom_backoff_total",
        "device-OOM tile halvings (re-packed and retried)",
        plane=plane,
    ).inc()
    trace.record("event", "dispatch.oom_backoff", plane=plane, rows=rows, halved_to=rows // 2)
    for sub in split(item):
        carry = dispatch_with_oom_backoff(
            fn, carry, sub, split=split, rows_of=rows_of, floor=floor, plane=plane,
        )
    return carry
