"""Profiling hooks: step timing, the device trace, a continuous host profiler.

The port's copy of the reference's ``obs/profiler.py``:

- :class:`StepTimer` — rolling per-step durations (the engine's
  ``step_timer``, ``DeviceFeed.timer``), mirrored into a telemetry
  histogram;
- :func:`device_trace` — the counterpart of the reference's ``xla_trace``
  (``jax.profiler.trace``): a ``torch.profiler`` window over the CPU and,
  where there is a card, CUDA activity, exported as a Chrome trace
  (``chrome://tracing``, Perfetto) that names every kernel launch;
- :class:`StackSampler` — an N-Hz daemon thread walking
  ``sys._current_frames()`` and folding every thread's stack
  (``root;frame;leaf count``, the flamegraph input format), with its own
  overhead measured (:meth:`StackSampler.overhead_ratio`);
- ``ASTPU_PROFILE=<hz>`` starts one process-global sampler when an
  exporter comes up (``telemetry.StatusServer``), which serves its folded
  stacks as ``GET /profile``.

Sampling is statistical: a stack's count over the total samples is the
share of wall time that stack owned.  The default 19 Hz is off the beat of
10/20 Hz loops.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import deque

__all__ = [
    "StepTimer",
    "device_trace",
    "StackSampler",
    "resolve_profile_hz",
    "maybe_start_global",
    "ensure_global",
    "global_sampler",
    "stop_global",
    "profile_response_text",
    "serve_profile",
]


class StepTimer:
    """Rolling per-step duration tracker (device batches, host stages).

    Production step loops own one (``pipeline.feed.DeviceFeed.timer``,
    ``pipeline.dedup.NearDupEngine.step_timer``) so :meth:`summary` is
    reachable live, and each observation can mirror into a telemetry
    histogram (``histogram=``) so the same steps show on ``/metrics`` —
    the registry hands back a no-op handle when telemetry is disabled,
    keeping the mirrored path free.  Appends are deque ops (thread-safe
    under the GIL); :meth:`summary` reads a snapshot.
    """

    def __init__(self, maxlen: int = 512, histogram=None):
        self._durations: deque[float] = deque(maxlen=maxlen)
        self._items: deque[int] = deque(maxlen=maxlen)
        self._histogram = histogram

    @contextlib.contextmanager
    def step(self, n_items: int = 1):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(time.perf_counter() - t0, n_items)

    def add(self, seconds: float, n_items: int = 1) -> None:
        """Record a step timed by the caller — for loops where the item
        count is only known after the work (e.g. a pop that may drain a
        partial tile)."""
        self._durations.append(seconds)
        self._items.append(n_items)
        if self._histogram is not None:
            self._histogram.observe(seconds)

    def summary(self) -> dict:
        if not self._durations:
            return {"steps": 0}
        ds = sorted(self._durations)
        total_t = sum(ds)
        total_n = sum(self._items)
        return {
            "steps": len(ds),
            "p50_ms": round(ds[len(ds) // 2] * 1e3, 3),
            "p95_ms": round(ds[int(len(ds) * 0.95)] * 1e3, 3),
            "items_per_sec": round(total_n / total_t, 1) if total_t > 0 else 0.0,
        }


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace to
    ``<log_dir>/trace-<pid>-<n>.json``; a no-op when ``log_dir`` is falsy.
    The counterpart of the reference's ``xla_trace``.  Yields the
    profiler (``key_averages()`` for per-kernel device times), or None."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the body's launches end inside the window
    global _traces
    with _global_lock:
        _traces += 1
        n = _traces
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{n}.json"))


# -- continuous host profiler -------------------------------------------------

DEFAULT_HZ = 19.0
#: distinct-stack cap: a pathological workload (deep recursion with
#: varying shapes) must not grow the fold table without bound — overflow
#: collapses into one honest bucket instead of evicting silently
MAX_STACKS = 4096
OVERFLOW_KEY = "_overflow_"


class StackSampler:
    """N-Hz all-threads stack sampler aggregating folded stacks.

    ``hz`` is the target sampling rate; ``maxdepth`` bounds the walked
    frames per thread (deepest frames kept — the leaf is what names the
    hot code).  The sampler accounts its own busy time: the tier-1
    overhead gate asserts :meth:`overhead_ratio` stays under 1% on the
    ragged dedup regime, so "continuous" is a measured claim.

    Telemetry (always-on — the sampler only exists because an operator
    set ``ASTPU_PROFILE``): ``astpu_prof_samples_total`` passes,
    ``astpu_prof_sample_seconds`` per-pass cost, plus live callback
    gauges ``astpu_prof_stacks`` / ``astpu_prof_overhead_ratio`` /
    ``astpu_prof_hz``.
    """

    def __init__(self, hz: float = DEFAULT_HZ, *, maxdepth: int = 64):
        self.hz = max(0.1, float(hz))
        self.maxdepth = maxdepth
        self._counts: dict[str, int] = {}
        self._label_cache: dict[int, str] = {}  # id(code) → "file:func"
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._samples = 0
        self._busy_s = 0.0
        self._started_mono: float | None = None
        self._started_ts: float | None = None

        self._instrument()
        # a registry reset (tests) must not leave a LIVE sampler feeding
        # orphaned handles invisible to /metrics — re-instrument lazily,
        # self-unregistering once this sampler is gone (the obs/stages
        # reset-hook lesson, per-instance flavor)
        import weakref

        from advanced_scrapper_tpu_torch.obs import telemetry

        ref = weakref.ref(self)

        def _reinstrument():
            s = ref()
            if s is None:
                return False  # unregister the hook with its sampler
            s._instrument()
            return True

        telemetry.REGISTRY.add_reset_hook(_reinstrument)

    def _instrument(self) -> None:
        """(Re-)fetch the sampler's metric handles from the CURRENT
        registry generation; called at init and from the reset hook."""
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._m_samples = telemetry.REGISTRY.counter(
            "astpu_prof_samples_total",
            "stack-sampler passes taken (all threads per pass)",
            always=True,
        )
        self._m_pass = telemetry.REGISTRY.histogram(
            "astpu_prof_sample_seconds",
            "cost of one sampling pass (the overhead numerator)",
            always=True,
        )
        telemetry.REGISTRY.gauge_fn(
            "astpu_prof_stacks",
            lambda s: float(len(s._counts)),
            owner=self,
            always=True,
            help="distinct folded stacks held by the sampler",
        )
        telemetry.REGISTRY.gauge_fn(
            "astpu_prof_overhead_ratio",
            lambda s: s.overhead_ratio(),
            owner=self,
            always=True,
            help="measured sampler busy fraction of wall time (<0.01 gated)",
        )
        telemetry.REGISTRY.gauge_fn(
            "astpu_prof_hz",
            lambda s: s.hz,
            owner=self,
            always=True,
            help="configured sampling rate",
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StackSampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._started_mono = time.monotonic()
        self._started_ts = time.time()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="astpu-prof-sampler"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- sampling ----------------------------------------------------------

    def _label(self, code) -> str:
        key = id(code)
        lab = self._label_cache.get(key)
        if lab is None:
            fn = code.co_filename
            base = os.path.basename(fn)
            if base.endswith(".py"):
                base = base[:-3]
            lab = f"{base}:{code.co_name}"
            if len(self._label_cache) < 65536:  # id-reuse is harmless here
                self._label_cache[key] = lab
        return lab

    def sample_once(self) -> int:
        """One pass over every live thread; returns stacks folded.  The
        sampler's own thread is skipped (profiling the profiler would put
        a constant artifact at the top of every report)."""
        t0 = time.perf_counter()
        me = threading.get_ident()
        frames = sys._current_frames()
        folded = 0
        with self._lock:
            for tid, frame in frames.items():
                if tid == me:
                    continue
                parts: list[str] = []
                depth = 0
                while frame is not None and depth < self.maxdepth:
                    parts.append(self._label(frame.f_code))
                    frame = frame.f_back
                    depth += 1
                if not parts:
                    continue
                key = ";".join(reversed(parts))  # root → leaf
                if key not in self._counts and len(self._counts) >= MAX_STACKS:
                    key = OVERFLOW_KEY
                self._counts[key] = self._counts.get(key, 0) + 1
                folded += 1
            self._samples += 1
        dt = time.perf_counter() - t0
        self._busy_s += dt
        self._m_samples.inc()
        self._m_pass.observe(dt)
        return folded

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            except Exception:
                # sampling must never take the process down; skip the beat
                continue

    # -- views -------------------------------------------------------------

    @property
    def samples(self) -> int:
        return self._samples

    def overhead_ratio(self) -> float:
        """Busy seconds inside sampling passes / wall seconds since
        start — the measured overhead the <1% gate asserts on."""
        if self._started_mono is None:
            return 0.0
        wall = time.monotonic() - self._started_mono
        return (self._busy_s / wall) if wall > 0 else 0.0

    def folded(self, top: int | None = None) -> str:
        """Folded-stack text (``stack count`` per line, hottest first) —
        the flamegraph input format, and what ``/profile`` serves."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: (-kv[1], kv[0])
            )
        if top is not None:
            items = items[:top]
        return "\n".join(f"{k} {v}" for k, v in items)

    def profile_text(self) -> str:
        """``/profile`` response body: a comment header (hz, samples,
        measured overhead — every parser skips ``#`` lines) + folded
        stacks."""
        head = (
            f"# astpu-profile hz={self.hz:g} samples={self._samples} "
            f"overhead={self.overhead_ratio():.5f} "
            f"started={self._started_ts or 0:.3f} pid={os.getpid()}"
        )
        body = self.folded()
        return head + ("\n" + body if body else "") + "\n"

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self._samples = 0
        self._busy_s = 0.0
        if self._started_mono is not None:
            self._started_mono = time.monotonic()


# -- process-global sampler ---------------------------------------------------

_global_lock = threading.Lock()
_GLOBAL: StackSampler | None = None
_traces = 0  # device_trace files written by this process

_TRUTHY = ("1", "true", "yes", "on")


def resolve_profile_hz() -> float:
    """``ASTPU_PROFILE`` → sampling hz: a number is the rate, a bare
    truthy flag means the default rate, anything else (or unset) is 0 =
    disabled."""
    v = os.environ.get("ASTPU_PROFILE", "").strip().lower()
    if not v:
        return 0.0
    if v in _TRUTHY:
        return DEFAULT_HZ
    try:
        hz = float(v)
    except ValueError:
        return 0.0
    return hz if hz > 0 else 0.0


def maybe_start_global() -> StackSampler | None:
    """Start the process-global sampler if ``ASTPU_PROFILE`` asks for one
    (idempotent).  Called by every exporter start (``StatusServer``), so
    any process that serves ``/metrics`` profiles itself under the env
    knob with no extra wiring."""
    hz = resolve_profile_hz()
    if hz <= 0:
        return None
    return ensure_global(hz)


def ensure_global(hz: float = DEFAULT_HZ) -> StackSampler:
    """Start (or return) the process-global sampler at ``hz``."""
    global _GLOBAL
    with _global_lock:
        if _GLOBAL is None or not _GLOBAL.running:
            _GLOBAL = StackSampler(hz).start()
        return _GLOBAL


def global_sampler() -> StackSampler | None:
    return _GLOBAL


def stop_global() -> None:
    global _GLOBAL
    with _global_lock:
        if _GLOBAL is not None:
            _GLOBAL.stop()
            _GLOBAL = None


def profile_response_text() -> str:
    """The ``GET /profile`` body for this process: the global sampler's
    folded view, or a one-line comment naming the knob when profiling is
    off (a 200 either way — a scraping collector must tell "disabled"
    apart from "dead")."""
    s = _GLOBAL
    if s is None:
        return "# astpu-profile disabled (set ASTPU_PROFILE=<hz>)\n"
    return s.profile_text()


def serve_profile(handler) -> None:
    """Mount ``GET /profile`` on a ``BaseHTTPRequestHandler`` (shared by
    ``StatusServer`` and every sidecar that rides it)."""
    from advanced_scrapper_tpu_torch.obs import telemetry

    telemetry.send_http_payload(
        handler,
        200,
        profile_response_text().encode("utf-8"),
        "text/plain; charset=utf-8",
    )
