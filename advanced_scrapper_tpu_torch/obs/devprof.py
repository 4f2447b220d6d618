"""Device dispatch latency ledger and kernel-build sentinel (the time domain).

The port's copy of the reference's ``obs/devprof.py``.  The launch-count
ledgers (``obs/stages.py`` device counters) answer "how many copies and
launches did a chunk cost"; this module answers "where did launch time go,
and did anything build when it should not have".  Three always-on
instruments, under the reference's series names:

- **``astpu_dispatch_latency_seconds{kernel, shape}``** — one observation
  per kernel launch, labelled by the launch seam (``dedup_fold_segments``,
  the unpacked transport's ``dedup_tile_sig``) and its shape (``RxW``:
  segments × bytes of a chunk, rows × width of a tile).  Timing is
  **async-submit** by default: the clock stops when the launch call
  returns, i.e. it measures what the host pays to enqueue (a hidden kernel
  reads ~0).  ``ASTPU_DISPATCH_TIMING=fenced`` records a CUDA event on the
  current stream after the launch and waits on it before the clock stops
  — the launch's device latency, at the cost of serialising the pipeline
  (a measurement mode).  The always-on ``astpu_dispatch_timing_fenced``
  gauge says which mode produced the numbers.
- **``astpu_dispatch_queue_lag_seconds{graph}``** — how long a staged
  chunk sat in ``pipeline/dispatch.py``'s window before the caller's
  thread took it.
- **``astpu_jit_compiles_total{kernel}``** and
  **``astpu_jit_compile_seconds``** — the recompile sentinel.  The
  reference counts jit-cache misses and XLA backend compiles; the port
  compiles no shapes, so the same series count **kernel builds and
  loads**: :func:`count_build` is called by ``ops/_build.py:load`` the
  first time a process loads a CUDA library (building it first when its
  hash-named file is missing) and by ``cpu/native.py:build`` the first
  time a process builds or finds a host library.  Warm-up and a first
  corpus count; a steady-state run reads zero, as the reference's does.

Cost: one ``perf_counter`` pair and a histogram observe per launch.  This
module imports torch only inside the fenced wait.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

from advanced_scrapper_tpu_torch.obs import telemetry

__all__ = [
    "DISPATCH_HISTOGRAM",
    "QUEUE_LAG_HISTOGRAM",
    "JIT_COMPILES",
    "COMPILE_SECONDS",
    "resolve_timing_mode",
    "dispatch_span",
    "queue_lag_histogram",
    "count_build",
    "jit_compiles_total",
    "jit_compiles_by_kernel",
    "compile_seconds_count",
]

DISPATCH_HISTOGRAM = "astpu_dispatch_latency_seconds"
QUEUE_LAG_HISTOGRAM = "astpu_dispatch_queue_lag_seconds"
JIT_COMPILES = "astpu_jit_compiles_total"
COMPILE_SECONDS = "astpu_jit_compile_seconds"

_lock = threading.Lock()
_hists: dict[tuple, telemetry.Histogram] = {}
_lag_hists: dict[str, telemetry.Histogram] = {}
_compile_counters: dict[str, telemetry.Counter] = {}


def resolve_timing_mode() -> str:
    """``"async"`` (default: the clock stops when the launch call returns)
    or ``"fenced"`` (``ASTPU_DISPATCH_TIMING=fenced``: wait for the card).
    Read per span, so a run can flip the mode without re-importing."""
    v = os.environ.get("ASTPU_DISPATCH_TIMING", "").strip().lower()
    return "fenced" if v == "fenced" else "async"


def _latency_hist(kernel: str, shape: str) -> telemetry.Histogram:
    key = (kernel, shape)
    h = _hists.get(key)
    if h is None:
        h = telemetry.REGISTRY.histogram(
            DISPATCH_HISTOGRAM,
            "per-dispatch wall clock by kernel/tile-shape (async-submit "
            "timing unless ASTPU_DISPATCH_TIMING=fenced)",
            always=True,
            kernel=kernel,
            shape=shape,
        )
        with _lock:
            _hists[key] = h
    return h


def _mark_timing_mode(mode: str) -> None:
    """Stamp which timing mode produced the latency numbers (0 = async
    submit, 1 = fenced), on every observation, so a mid-run flip of
    ``ASTPU_DISPATCH_TIMING`` shows on ``/metrics``."""
    telemetry.REGISTRY.gauge(
        "astpu_dispatch_timing_fenced",
        "1 = dispatch latency is block-until-ready truth, 0 = "
        "async submission cost",
        always=True,
    ).set(1.0 if mode == "fenced" else 0.0)


def _fence(out) -> None:
    """Wait for the work queued on ``out``'s card so far: a CUDA event
    recorded on the current stream, then its ``synchronize``.  A CPU
    result (the plain versions) ran synchronously."""
    device = getattr(out, "device", None)
    if device is None or device.type != "cuda":
        return
    import torch

    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    event.synchronize()


class _Span:
    """Result carrier for :func:`dispatch_span`: set ``out`` to the
    launch's output tensor so fenced mode knows which card to wait on."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = None


@contextmanager
def dispatch_span(
    kernel: str,
    *,
    rows: int | None = None,
    width: int | None = None,
    trace: str | None = None,
):
    """Time one kernel launch into the latency ledger::

        with devprof.dispatch_span("dedup_fold_segments", rows=g, width=t) as sp:
            sp.out = fold(running, ...)

    Only launches that return are observed (an OOM back-off's failed
    parent attempt does not pollute the distribution).  Under
    ``ASTPU_DISPATCH_TIMING=fenced`` the exit waits for the card before
    the clock stops.  ``trace`` attaches a slow-call exemplar when the
    observation lands in the histogram's top bucket."""
    span = _Span()
    shape = f"{rows}x{width}" if rows is not None and width is not None else ""
    t0 = time.perf_counter()
    yield span
    mode = resolve_timing_mode()
    if mode == "fenced" and span.out is not None:
        _fence(span.out)
    _mark_timing_mode(mode)
    _latency_hist(kernel, shape).observe(time.perf_counter() - t0, trace=trace)


def queue_lag_histogram(graph: str) -> telemetry.Histogram:
    """The staged-pop lag series of one dispatch graph (always-on;
    ``pipeline/dispatch.py`` stamps a chunk when its copy is staged and
    observes the gap when the caller takes it)."""
    h = _lag_hists.get(graph)
    if h is None:
        h = telemetry.REGISTRY.histogram(
            QUEUE_LAG_HISTOGRAM,
            "staged-tile wait between h2d completion and the caller's "
            "dispatch pop (pipeline/dispatch.py staged window)",
            always=True,
            graph=graph,
        )
        with _lock:
            _lag_hists[graph] = h
    return h


# -- kernel-build sentinel ------------------------------------------------------


def _compiles(kernel: str) -> telemetry.Counter:
    c = _compile_counters.get(kernel)
    if c is None:
        c = telemetry.REGISTRY.counter(
            JIT_COMPILES,
            "kernel builds and loads per library (steady state must stay "
            "flat — prewarm exists to front-load these)",
            always=True,
            kernel=kernel,
        )
        with _lock:
            _compile_counters[kernel] = c
    return c


def count_build(kernel: str, seconds: float) -> None:
    """Count one build-or-load of library ``kernel`` (``csrc/<name>.cu``
    or a ``native/`` source) that took ``seconds``, on the sentinel
    counter and the global compile histogram, with a flight-recorder
    event."""
    _compiles(kernel).inc()
    telemetry.REGISTRY.histogram(
        COMPILE_SECONDS,
        "wall clock of every kernel build and load in this process "
        "(a library loaded once is not built again)",
        always=True,
    ).observe(float(seconds))
    from advanced_scrapper_tpu_torch.obs import trace

    trace.record("event", "jit.compile", kernel=kernel, n=1)


# -- windowed reads -------------------------------------------------------------


def jit_compiles_by_kernel() -> dict[str, float]:
    """Cumulative sentinel counts per kernel label (subtract two snapshots
    to window a run)."""
    out: dict[str, float] = {}
    for c in telemetry.REGISTRY.find(JIT_COMPILES):
        k = c.labels.get("kernel", "")
        out[k] = out.get(k, 0.0) + c.value
    return out


def jit_compiles_total() -> float:
    """Cumulative sentinel count across every library."""
    return sum(jit_compiles_by_kernel().values())


def compile_seconds_count() -> tuple[int, float]:
    """``(count, sum_seconds)`` of the global build histogram."""
    n, s = 0, 0.0
    for h in telemetry.REGISTRY.find(COMPILE_SECONDS):
        n += h.count
        s += h.sum
    return n, s


def _clear_for_tests() -> None:
    """Registry-reset hook: drop cached handles so a reset never leaves
    series fed outside the registry's view."""
    with _lock:
        _hists.clear()
        _lag_hists.clear()
        _compile_counters.clear()


telemetry.REGISTRY.add_reset_hook(_clear_for_tests)
