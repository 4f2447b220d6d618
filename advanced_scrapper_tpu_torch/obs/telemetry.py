"""Process-wide metrics registry: counters, gauges, log-bucketed histograms.

The port's copy of the reference's ``obs/telemetry.py``: the same handles,
series names, metric types, label keys and exporters, so the two packages
render the same Prometheus text and JSON snapshot for the same sequence of
metric operations.

- :class:`Counter` / :class:`Gauge` / :class:`Histogram` — thread-safe
  metric handles.  Histograms are log₂-bucketed latency distributions
  (~1 µs … 64 s) with p50/p95/p99 estimation; one lock and a bucket
  increment per observation.
- :class:`Registry` — names metric handles (with optional labels), renders
  them as Prometheus text (``/metrics``) and a JSON snapshot (``/status``),
  and hosts *callback gauges*: gauges read at scrape time (queue depth,
  index size), held by weakref so transient owners (a ``DeviceFeed`` per
  stream) never leak.
- :class:`StatusServer` — a small stdlib HTTP exporter serving ``GET
  /metrics``, ``GET /status`` and ``GET /profile`` (``obs/profiler.py``).

Cost model: telemetry is OFF by default (``ASTPU_TELEMETRY=1`` enables).
Disabled, the factory methods hand back shared no-op singletons — a call
site's per-batch cost is one attribute call, no lock, no allocation.  Two
families bypass the gate: *stage histograms* (``always=True`` —
``obs/stages.py`` is a view over them) and *event counters* for rare
faults (quarantines, chaos injections, watchdog trips), whose firing is
off the fast path by definition.

Metric naming scheme: ``astpu_<layer>_<what>[_total|_seconds|_bytes]``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import weakref

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "StatusServer",
    "REGISTRY",
    "NOOP",
    "enabled",
    "set_enabled",
    "counter",
    "gauge",
    "histogram",
    "gauge_fn",
    "event_counter",
    "stage_histogram",
    "stage_histograms",
    "register_process_metrics",
    "serve_metrics",
    "serve_status",
    "send_http_payload",
    "PROMETHEUS_CONTENT_TYPE",
]

_TRUTHY = ("1", "true", "yes", "on")


class _Noop:
    """Shared do-nothing metric handle — what call sites get when telemetry
    is disabled.  No lock, no state: the disabled hot path is one attribute
    call per event."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v, trace=None):
        pass

    @property
    def value(self):
        return 0.0

    @property
    def exemplar(self):
        return None


NOOP = _Noop()


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    kind = "counter"
    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels: dict, help: str = ""):
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    kind = "gauge"
    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels: dict, help: str = ""):
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


#: log₂ bucket upper bounds in seconds: 2⁻²⁰ (~1 µs) … 2⁶ (64 s).  Base-2 so
#: the bucket of an observation falls out of one ``math.frexp`` — no search.
_BUCKET_LO_EXP = -20
_BUCKET_HI_EXP = 6
BUCKET_BOUNDS = tuple(2.0**e for e in range(_BUCKET_LO_EXP, _BUCKET_HI_EXP + 1))


class Histogram:
    """Log-bucketed distribution (latencies in seconds by convention).

    Cumulative, Prometheus-style: ``sum``/``count`` grow forever; views
    that need a window (bench ``stage_ms``) snapshot-and-subtract.
    """

    kind = "histogram"
    __slots__ = (
        "name", "labels", "help", "_lock", "_buckets", "_sum", "_count",
        "_max_bucket", "_exemplar",
    )

    def __init__(self, name: str, labels: dict, help: str = ""):
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self._lock = threading.Lock()
        # one slot per bound + overflow (+Inf)
        self._buckets = [0] * (len(BUCKET_BOUNDS) + 1)
        self._sum = 0.0
        self._count = 0
        self._max_bucket = -1       # highest occupied bucket index so far
        self._exemplar: dict | None = None  # slow-call exemplar (see observe)

    @staticmethod
    def _bucket_index(v: float) -> int:
        if v <= BUCKET_BOUNDS[0]:
            return 0
        m, e = math.frexp(v)  # v = m · 2^e, 0.5 ≤ m < 1
        if m == 0.5:  # exact powers of two belong in their own bucket
            e -= 1
        i = e - _BUCKET_LO_EXP
        return i if i < len(BUCKET_BOUNDS) else len(BUCKET_BOUNDS)

    def observe(self, v: float, trace: str | None = None) -> None:
        """Record one observation.  ``trace`` attaches a *slow-call
        exemplar*: when the observation lands in (or above) the highest
        bucket this histogram has ever occupied — i.e. it is one of the
        p99-tail outliers — the trace id is kept as the series' exemplar,
        so a dashboard can jump from "p99 spiked" straight to the one
        stitched trace that caused it.  O(1), one compare on the hot
        path."""
        i = self._bucket_index(v)
        with self._lock:
            self._buckets[i] += 1
            self._sum += v
            self._count += 1
            if i >= self._max_bucket:
                self._max_bucket = i
                if trace is not None:
                    self._exemplar = {
                        "trace": trace,
                        "value": v,
                        "ts": time.time(),
                    }

    @property
    def exemplar(self) -> dict | None:
        """The current slow-call exemplar (``{trace, value, ts}``) or None."""
        with self._lock:
            return dict(self._exemplar) if self._exemplar else None

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def state(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._buckets), self._sum, self._count

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) by linear interpolation inside
        the containing bucket; 0.0 when empty."""
        buckets, _s, count = self.state()
        if count == 0:
            return 0.0
        target = q * count
        cum = 0
        for i, n in enumerate(buckets):
            if n == 0:
                continue
            if cum + n >= target:
                lo = 0.0 if i == 0 else BUCKET_BOUNDS[i - 1]
                hi = (
                    BUCKET_BOUNDS[i]
                    if i < len(BUCKET_BOUNDS)
                    else BUCKET_BOUNDS[-1] * 2
                )
                frac = (target - cum) / n
                return lo + (hi - lo) * frac
            cum += n
        return BUCKET_BOUNDS[-1] * 2

    def percentiles_ms(self) -> dict[str, float]:
        return {
            "p50_ms": round(self.percentile(0.50) * 1e3, 3),
            "p95_ms": round(self.percentile(0.95) * 1e3, 3),
            "p99_ms": round(self.percentile(0.99) * 1e3, 3),
        }


class _CallbackGauge:
    """Deferred gauge: ``fn(owner)`` is evaluated at scrape time, the owner
    held by weakref so registration never extends its lifetime.  ``fn`` may
    return a number, or (with ``expand``) a ``{label_value: number}`` dict
    that fans out into one series per key."""

    kind = "gauge"
    __slots__ = ("name", "labels", "help", "expand", "_fn", "_owner")

    def __init__(self, name, labels, fn, owner, expand, help=""):
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self.expand = expand
        self._fn = fn
        self._owner = weakref.ref(owner) if owner is not None else None

    def samples(self):
        """``[(labels, value)]`` or None when the owner died / fn failed."""
        owner = None
        if self._owner is not None:
            owner = self._owner()
            if owner is None:
                return None
        try:
            v = self._fn(owner) if self._owner is not None else self._fn()
        except Exception:
            return []
        if self.expand is not None and isinstance(v, dict):
            return [
                ({**self.labels, self.expand: str(k)}, float(val))
                for k, val in sorted(v.items(), key=lambda kv: str(kv[0]))
            ]
        return [(self.labels, float(v))]


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_bound(b: float) -> str:
    return format(b, ".9g")


class Registry:
    """Thread-safe named-metric store + exporter."""

    def __init__(self, enabled: bool | None = None):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}
        self._callbacks: dict[tuple, _CallbackGauge] = {}
        self._enabled = enabled  # None → resolve from ASTPU_TELEMETRY lazily
        self._reset_hooks: list = []  # see reset(): handle-cache droppers
        #: bumped by reset(): handle-caching instrumenters (the admission
        #: plane) compare it lazily and re-instrument on first use after
        #: a reset — dormant objects never pollute a fresh registry
        self.generation = 0

    # -- gating ------------------------------------------------------------

    def enabled(self) -> bool:
        if self._enabled is None:
            self._enabled = (
                os.environ.get("ASTPU_TELEMETRY", "").lower() in _TRUTHY
            )
        return self._enabled

    def set_enabled(self, on: bool | None) -> None:
        """Force the gate (tests); ``None`` re-reads ``ASTPU_TELEMETRY`` at
        next use.  Affects handles created AFTER the call — call sites
        fetch handles at construction time."""
        self._enabled = on

    # -- factories ---------------------------------------------------------

    def _get(self, cls, name, labels, help, always):
        if not (always or self.enabled()):
            return NOOP
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, help)
                self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "", always: bool = False, **labels):
        return self._get(Counter, name, labels, help, always)

    def gauge(self, name: str, help: str = "", always: bool = False, **labels):
        return self._get(Gauge, name, labels, help, always)

    def histogram(self, name: str, help: str = "", always: bool = False, **labels):
        return self._get(Histogram, name, labels, help, always)

    def gauge_fn(
        self,
        name: str,
        fn,
        *,
        owner=None,
        expand: str | None = None,
        help: str = "",
        always: bool = False,
        **labels,
    ) -> None:
        """Register a scrape-time callback gauge.  With ``owner``, ``fn`` is
        called as ``fn(owner)`` and the owner is weakref'd (a dead owner
        unregisters the gauge); re-registering the same (name, labels)
        replaces the previous callback."""
        if not (always or self.enabled()):
            return
        key = (name, _label_key(labels))
        cb = _CallbackGauge(name, labels, fn, owner, expand, help)
        with self._lock:
            self._callbacks[key] = cb

    # -- introspection -----------------------------------------------------

    def find(self, name: str) -> list:
        """Live (non-callback) metrics registered under ``name``."""
        with self._lock:
            return [m for (n, _), m in sorted(self._metrics.items()) if n == name]

    def _collect(self):
        """``(stored_metrics, callback_samples)`` with dead callbacks swept."""
        with self._lock:
            metrics = [m for _, m in sorted(self._metrics.items())]
            callbacks = list(self._callbacks.items())
        samples = []
        dead = []
        for key, cb in callbacks:
            s = cb.samples()
            if s is None:
                dead.append((key, cb))
                continue
            for labels, v in s:
                samples.append((cb.name, labels, v, cb.help))
        if dead:
            with self._lock:
                for key, cb in dead:
                    # identity check: a replacement registered between the
                    # snapshot and this sweep must not be swept with its
                    # dead predecessor
                    if self._callbacks.get(key) is cb:
                        del self._callbacks[key]
        return metrics, samples

    # -- exporters ---------------------------------------------------------

    def prometheus_text(self) -> str:
        """The full registry in Prometheus text exposition format."""
        metrics, cb_samples = self._collect()
        lines: list[str] = []
        typed: set[str] = set()

        def head(name: str, kind: str, help: str) -> None:
            if name in typed:
                return
            typed.add(name)
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")

        for m in metrics:
            head(m.name, m.kind, m.help)
            if m.kind == "histogram":
                buckets, total, count = m.state()
                cum = 0
                for i, n in enumerate(buckets[:-1]):
                    cum += n
                    lab = _fmt_labels({**m.labels, "le": _fmt_bound(BUCKET_BOUNDS[i])})
                    lines.append(f"{m.name}_bucket{lab} {cum}")
                cum += buckets[-1]
                lab = _fmt_labels({**m.labels, "le": "+Inf"})
                lines.append(f"{m.name}_bucket{lab} {cum}")
                lines.append(f"{m.name}_sum{_fmt_labels(m.labels)} {repr(total)}")
                lines.append(f"{m.name}_count{_fmt_labels(m.labels)} {count}")
                ex = m.exemplar
                if ex is not None:
                    # comment line (not OpenMetrics exemplar syntax): every
                    # Prometheus text parser skips it, and the collector's
                    # parser picks it back up to stitch fleet-wide
                    lines.append(
                        f"# exemplar {m.name}{_fmt_labels(m.labels)} "
                        f'trace="{ex["trace"]}" value={repr(ex["value"])} '
                        f"ts={repr(ex['ts'])}"
                    )
            else:
                lines.append(
                    f"{m.name}{_fmt_labels(m.labels)} {_fmt_value(m.value)}"
                )
        for name, labels, v, help in cb_samples:
            head(name, "gauge", help)
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"

    def status(self) -> dict:
        """JSON-able snapshot for ``/status``: one entry per series, with
        p50/p95/p99 attached to histograms."""
        metrics, cb_samples = self._collect()
        out = []
        for m in metrics:
            entry = {"name": m.name, "kind": m.kind, "labels": m.labels}
            if m.kind == "histogram":
                _b, total, count = m.state()
                entry["count"] = count
                entry["sum"] = total
                entry.update(m.percentiles_ms())
                ex = m.exemplar
                if ex is not None:
                    entry["exemplar"] = ex
            else:
                entry["value"] = m.value
            out.append(entry)
        for name, labels, v, _help in cb_samples:
            out.append({"name": name, "kind": "gauge", "labels": labels, "value": v})
        return {"ts": time.time(), "pid": os.getpid(), "metrics": out}

    def reset(self) -> None:
        """Drop every metric and callback (tests only — production metrics
        are cumulative for the life of the process).  Modules that cache
        metric HANDLES (``obs/stages.py``'s always-on device counters)
        register a reset hook so their caches drop with the registry —
        otherwise a reset orphans the cached objects and later
        increments land outside :meth:`find`'s view (a real test-ordering
        bug this hook retired)."""
        with self._lock:
            self._metrics.clear()
            self._callbacks.clear()
            self.generation += 1
        keep = []
        for fn in list(self._reset_hooks):
            try:
                # a hook returning False unregisters itself (how
                # per-instance hooks — a dead AdmissionController's
                # re-instrumenter — avoid accumulating forever)
                if fn() is not False:
                    keep.append(fn)
            except Exception:
                keep.append(fn)
        self._reset_hooks = keep

    def add_reset_hook(self, fn) -> None:
        self._reset_hooks.append(fn)


#: the process-wide registry every layer instruments against
REGISTRY = Registry()


def enabled() -> bool:
    return REGISTRY.enabled()


def set_enabled(on: bool | None) -> None:
    REGISTRY.set_enabled(on)


def counter(name: str, help: str = "", **labels):
    return REGISTRY.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels):
    return REGISTRY.gauge(name, help, **labels)


def histogram(name: str, help: str = "", **labels):
    return REGISTRY.histogram(name, help, **labels)


def gauge_fn(name: str, fn, **kw) -> None:
    REGISTRY.gauge_fn(name, fn, **kw)


def event_counter(name: str, help: str = "", **labels):
    """Always-on counter for RARE events (quarantines, fault injections,
    rate-limit trips): firing is off the fast path by definition, and the
    counts must be visible on ``/metrics`` whenever anything exports."""
    return REGISTRY.counter(name, help, always=True, **labels)


#: stage histograms — the one source of truth behind ``obs/stages.py`` AND
#: the live ``/metrics`` stage series (``always`` because stage timing
#: predates this layer and bench's stage_ms depends on it unconditionally)
STAGE_HISTOGRAM = "astpu_stage_seconds"


def stage_histogram(stage: str) -> Histogram:
    return REGISTRY.histogram(
        STAGE_HISTOGRAM,
        "per-stage wall clock (call-site attribution; obs/stages.py)",
        always=True,
        stage=stage,
    )


def stage_histograms() -> list[Histogram]:
    return REGISTRY.find(STAGE_HISTOGRAM)


def register_process_metrics(registry: Registry | None = None) -> None:
    """Standard process-health gauges (RSS, CPU seconds, uptime, thread
    count) — registered by exporters at start so even a quiet pipeline
    serves a meaningful ``/metrics``.  Idempotent (same keys replace)."""
    import resource
    import sys

    reg = registry or REGISTRY
    t0 = time.time()
    # ru_maxrss is KiB on Linux/BSD but BYTES on macOS
    rss_scale = 1 if sys.platform == "darwin" else 1024

    reg.gauge_fn(
        "astpu_process_uptime_seconds",
        lambda: time.time() - t0,
        always=True,
        help="seconds since process metrics were registered",
    )
    reg.gauge_fn(
        "astpu_process_max_rss_bytes",
        lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * rss_scale,
        always=True,
        help="peak resident set size",
    )
    reg.gauge_fn(
        "astpu_process_cpu_seconds",
        lambda: (
            resource.getrusage(resource.RUSAGE_SELF).ru_utime
            + resource.getrusage(resource.RUSAGE_SELF).ru_stime
        ),
        always=True,
        help="user+system CPU time consumed",
    )
    reg.gauge_fn(
        "astpu_process_threads",
        lambda: threading.active_count(),
        always=True,
        help="live Python threads",
    )


# -- HTTP export ------------------------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


def send_http_payload(handler, code: int, body: bytes, ctype: str) -> None:
    """One HTTP response on a ``BaseHTTPRequestHandler``, swallowing client
    disconnects — a scraper hanging up mid-``/metrics`` must not dump a
    traceback from the server thread."""
    try:
        handler.send_response(code)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        pass


def serve_metrics(handler, registry: Registry | None = None) -> None:
    """``GET /metrics`` body — the ONE implementation every exporter
    (StatusServer, the control plane) mounts."""
    reg = registry or REGISTRY
    send_http_payload(
        handler, 200, reg.prometheus_text().encode("utf-8"),
        PROMETHEUS_CONTENT_TYPE,
    )


def serve_status(handler, registry: Registry | None = None, extra_status=None) -> None:
    """``GET /status`` body; ``extra_status()``'s dict merges into the
    payload (a failing callback degrades to an error field, never a 500)."""
    reg = registry or REGISTRY
    payload = reg.status()
    if extra_status is not None:
        try:
            payload.update(extra_status())
        except Exception as e:
            payload["extra_status_error"] = str(e)
    send_http_payload(
        handler, 200, json.dumps(payload).encode("utf-8"), "application/json"
    )


class StatusServer:
    """Minimal stdlib exporter: ``GET /metrics`` (Prometheus text) and
    ``GET /status`` (JSON).  Rides beside servers that aren't HTTP (the
    lease plane) and inside processes that have no server at all (bench).

    ``extra_status`` is an optional zero-arg callable whose dict is merged
    into the ``/status`` payload under its own keys (e.g. the lease
    server's fleet view).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        registry: Registry | None = None,
        extra_status=None,
        name: str | None = None,
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry or REGISTRY
        register_process_metrics(reg)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    serve_metrics(self, reg)
                elif self.path == "/status":
                    serve_status(self, reg, extra_status)
                elif self.path == "/profile":
                    # the continuous host profiler's folded stacks
                    # (obs/profiler.py; 200 with a comment line when
                    # ASTPU_PROFILE is unset) — lazy import: profiler
                    # imports telemetry at module scope
                    from advanced_scrapper_tpu_torch.obs import profiler

                    profiler.serve_profile(self)
                else:
                    send_http_payload(
                        self,
                        404,
                        json.dumps(
                            {"error": f"no such endpoint {self.path}"}
                        ).encode("utf-8"),
                        "application/json",
                    )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self.name = name or f"pid{os.getpid()}"
        self._thread: threading.Thread | None = None
        self._endpoint_file: str | None = None

    def start(self) -> "StatusServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        # ASTPU_PROFILE=<hz>: any process that exports metrics also
        # profiles itself — the sampler is process-global and idempotent,
        # and /profile (above) serves its folded stacks
        from advanced_scrapper_tpu_torch.obs import profiler

        profiler.maybe_start_global()
        # fleet discovery: under ASTPU_OBS_DIR every exporter announces
        # its endpoint as a one-line file the metrics collector
        # (obs/collector.py) watches — no port registry, no race against
        # ephemeral binds (the file appears only after listen succeeded)
        obs_dir = os.environ.get("ASTPU_OBS_DIR")
        if obs_dir:
            try:
                self.announce(obs_dir)
            except OSError:
                pass  # discovery is best-effort, serving is not
        return self

    def announce(self, obs_dir: str, name: str | None = None) -> str:
        """Write ``<obs_dir>/<name>.endpoint`` containing this server's
        base url, atomically (tmp + rename) so a concurrently-scanning
        collector never reads a half-written line.  Returns the path."""
        name = name or self.name
        os.makedirs(obs_dir, exist_ok=True)
        path = os.path.join(obs_dir, f"{name}.endpoint")
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(f"http://{self.host}:{self.port}\n")
        os.replace(tmp, path)
        self._endpoint_file = path
        return path

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._endpoint_file is not None:
            try:
                os.unlink(self._endpoint_file)
            except OSError:
                pass
            self._endpoint_file = None
