"""Structured span tracing and an in-memory crash flight recorder.

The port's copy of the reference's ``obs/trace.py``.  Metrics
(``obs/telemetry.py``) answer "how fast, how many"; this module answers
"what was in flight when it died".  A fixed-size ring records spans and
events — trace ids flow from a corpus's encode through the copy, the
kernel launches and the resolve — and on a crash or an injected fault the
ring is dumped to a JSONL sidecar.

Recording is OFF unless ``ASTPU_TELEMETRY`` is truthy or
``ASTPU_FLIGHT_RECORDER=<path>`` names a dump destination (an env knob that
forked children inherit).  Disabled, :func:`span` costs one attribute
check before yielding.

The dump bypasses the ``storage.fsio`` seam on purpose: the recorder fires
during injected storage faults, and routing its own sidecar through the
faulty substrate would recurse the injection.  Every record line is
self-contained JSON, so a tail cut off by the OS stays parseable.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

__all__ = [
    "FlightRecorder",
    "RECORDER",
    "enabled",
    "set_enabled",
    "set_dump_path",
    "dump_path",
    "span",
    "record",
    "new_trace_id",
    "new_span_id",
    "current_context",
    "current_trace_id",
    "trace_context",
    "wire_context",
    "context_from_wire",
    "dump",
    "dump_on_fault",
    "add_fault_hook",
    "install_excepthook",
]

#: callbacks run (once, with the recorder) inside :meth:`dump_on_fault`
#: BEFORE the sidecar is written — how the stage-graph runtime lands a
#: whole-graph drain snapshot in the ring at the kill point without this
#: module importing the runtime (the hook is registered BY the runtime).
_FAULT_HOOKS: list = []


def add_fault_hook(fn) -> None:
    """Register ``fn(recorder)`` to run on the crash path.  Hooks must be
    fast and must never raise (they run while the process is dying)."""
    if fn not in _FAULT_HOOKS:
        _FAULT_HOOKS.append(fn)

_TRUTHY = ("1", "true", "yes", "on")

_trace_ids = itertools.count(1)
_span_ids = itertools.count(1)


def new_trace_id() -> str:
    """Process-unique trace id (pid-qualified so multi-process sweeps can
    interleave their sidecars without collision)."""
    return f"{os.getpid():x}-{next(_trace_ids):x}"


def new_span_id() -> str:
    """Process-unique span id (same pid-qualified scheme as trace ids:
    server-side spans of a propagated trace are minted in ANOTHER
    process, and the stitched view must never alias two of them)."""
    return f"s{os.getpid():x}.{next(_span_ids):x}"


# -- trace context -----------------------------------------------------------
#
# The ambient (trace_id, span_id) pair, carried by contextvars so it flows
# through nested spans on one thread but NOT across threads or sockets by
# accident — a server-side span whose trace id matches a client's proves the
# id travelled over the wire (the RPC ``_trace`` header), not through
# shared process state.  ``span`` inherits and extends the context; RPC
# clients serialize it with :func:`wire_context` and servers restore it
# with :func:`context_from_wire`.

_CTX: contextvars.ContextVar = contextvars.ContextVar("astpu_trace", default=None)


def current_context() -> tuple[str, str] | None:
    """The ambient ``(trace_id, span_id)`` pair, or None outside a trace."""
    return _CTX.get()


def current_trace_id() -> str | None:
    ctx = _CTX.get()
    return ctx[0] if ctx else None


@contextmanager
def trace_context(trace_id: str | None, span_id: str | None = None):
    """Run the body under an explicit trace context (the server-side
    entry point: restore a propagated context, or start a fresh corpus
    trace).  ``trace_id=None`` clears the context for the body."""
    if trace_id is None:
        token = _CTX.set(None)
    else:
        token = _CTX.set((trace_id, span_id or new_span_id()))
    try:
        yield
    finally:
        _CTX.reset(token)


def wire_context() -> dict | None:
    """The ambient context as a JSON-able header fragment (``None`` when
    there is nothing to propagate) — what RPC/lease clients attach."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    return {"t": ctx[0], "s": ctx[1]}


def context_from_wire(frag) -> tuple[str, str] | None:
    """Parse a :func:`wire_context` fragment from a request header;
    malformed fragments (an old peer, a fuzzer) are dropped, never raised
    — trace propagation must not be able to fail a request."""
    if not isinstance(frag, dict):
        return None
    t, s = frag.get("t"), frag.get("s")
    if not isinstance(t, str) or not t:
        return None
    return (t, s if isinstance(s, str) and s else new_span_id())


class FlightRecorder:
    """Bounded ring of structured events; thread-safe; cheap when off."""

    def __init__(self, capacity: int = 2048):
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._active: bool | None = None  # None → resolve from env lazily
        self._dump_path: str | None = None
        self._dumped = False
        self.capacity = capacity

    # -- gating ------------------------------------------------------------

    @property
    def active(self) -> bool:
        if self._active is None:
            env = os.environ
            self._active = (
                env.get("ASTPU_TELEMETRY", "").lower() in _TRUTHY
                or bool(env.get("ASTPU_FLIGHT_RECORDER"))
            )
        return self._active

    def set_active(self, on: bool | None) -> None:
        self._active = on

    def set_dump_path(self, path: str | None) -> None:
        self._dump_path = path

    def dump_path(self) -> str | None:
        return self._dump_path or os.environ.get("ASTPU_FLIGHT_RECORDER") or None

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, name: str, **fields) -> None:
        if not self.active:
            return
        ev = {"ts": time.time(), "kind": kind, "name": name}
        if "trace" not in fields:
            # events inherit the ambient trace id so failover/spill/replay
            # records stitch into the corpus trace that triggered them
            ctx = _CTX.get()
            if ctx is not None:
                ev["trace"] = ctx[0]
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)

    @contextmanager
    def span(self, name: str, **fields):
        """Timed span; on any exit (including exception) the duration and
        outcome land in the ring.

        Spans participate in the trace context: an explicit ``trace=``
        field starts/continues that trace; otherwise the ambient context's
        trace id is inherited.  Either way the body runs under a fresh
        span id (with the previous span recorded as ``parent``), so
        nested spans — and RPC calls, which serialize the context into
        their request headers — chain into one stitched corpus trace.
        """
        if not self.active:
            yield
            return
        parent = _CTX.get()
        tid = fields.get("trace") or (parent[0] if parent else None)
        token = None
        if tid is not None:
            sid = new_span_id()
            fields["trace"] = tid
            fields["span"] = sid
            if parent is not None and parent[0] == tid:
                fields["parent"] = parent[1]
            token = _CTX.set((tid, sid))
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            self.record(
                "span",
                name,
                dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
                error=f"{type(e).__name__}: {e}",
                **fields,
            )
            raise
        finally:
            if token is not None:
                _CTX.reset(token)
        self.record(
            "span",
            name,
            dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
            **fields,
        )

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
        self._dumped = False

    # -- crash dump --------------------------------------------------------

    def dump(self, path: str | None = None, *, reason: str = "") -> str | None:
        """Write the ring as JSONL (oldest first) to ``path`` (default: the
        configured dump path).  Returns the path written, or None when no
        destination is configured.  Uses plain ``open`` on purpose — see
        module docstring."""
        path = path or self.dump_path()
        if not path:
            return None
        events = self.snapshot()
        header = {
            "ts": time.time(),
            "kind": "dump",
            "name": "flight_recorder",
            "pid": os.getpid(),
            "reason": reason,
            "events": len(events),
        }
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(header) + "\n")
            for ev in events:
                fh.write(json.dumps(ev, default=str) + "\n")
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:
                pass
        return path

    def dump_on_fault(self, reason: str) -> str | None:
        """Crash-path dump: records the fault event, writes the sidecar
        once (repeated faults in one death don't multiply dumps), and
        never raises — the crash in progress owns the control flow."""
        try:
            if not self.active:
                return None
            self.record("fault", "crash", reason=reason)
            with self._lock:
                if self._dumped:
                    return None
                self._dumped = True
            # fault hooks land their state (e.g. the stage-graph runtime's
            # whole-graph drain snapshot) in the ring BEFORE the dump —
            # each individually guarded so one bad hook cannot cost the
            # sidecar its remaining events
            for fn in list(_FAULT_HOOKS):
                try:
                    fn(self)
                except Exception:
                    pass
            return self.dump(reason=reason)
        except Exception:
            return None


RECORDER = FlightRecorder()

# module-level conveniences bound to the process recorder
span = RECORDER.span
record = RECORDER.record
dump = RECORDER.dump
dump_on_fault = RECORDER.dump_on_fault
set_dump_path = RECORDER.set_dump_path
dump_path = RECORDER.dump_path


def enabled() -> bool:
    return RECORDER.active


def set_enabled(on: bool | None) -> None:
    RECORDER.set_active(on)


def install_excepthook() -> None:
    """Chain the flight-recorder dump onto ``sys.excepthook`` so an
    uncaught exception (not just chaos faults) leaves a sidecar.  Long-
    running entry points (bench, CLI scrape) opt in; libraries never
    mutate the hook on import."""
    import sys

    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        dump_on_fault(f"uncaught {exc_type.__name__}: {exc}")
        prev(exc_type, exc, tb)

    sys.excepthook = hook
