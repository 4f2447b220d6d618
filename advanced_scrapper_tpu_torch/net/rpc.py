"""Length-framed, deadline-aware RPC over TCP — the fleet transport plane.

The port's copy of the reference's ``net/rpc.py``, its telemetry, trace
propagation and admission gate included.  Its frames are the reference's
byte for byte, so a port client talks to a reference server and the other
way round.  Host code over numpy and the standard library: a shard
process imports no torch.

The lease protocol (the reference's ``net/lease.py``, ROADMAP item 18) is
newline-delimited JSON: right for url strings, hopeless for posting
arrays (a million uint64 band keys must not round-trip through base64).
This module is the *binary* sibling the index fleet rides on:

- **length-framed**: every message is ``u32 total | u32 header_len |
  header JSON | raw array bytes``; arrays are described in the header
  (dtype + shape) and travel as their exact buffer bytes — zero copies on
  send, one ``recv_into`` reassembly on receive.  Frames are capped
  (default 64 MiB) and an oversized or never-completing frame closes the
  connection and counts in telemetry — the slow-loris / unbounded-buffer
  lesson from the lease plane, applied from day one.
- **deadline-aware**: every call carries a wall-clock budget; the client
  arms the socket timeout per attempt and the server enforces a per-frame
  read deadline, so a hung peer costs a timeout, not a thread forever.
- **retry-safe**: calls are retried on connection loss / timeout with
  capped exponential backoff plus deterministic jitter, under the SAME
  request id; servers keep a bounded LRU of ``request id → response`` and
  replay instead of re-executing, so a retried ``insert`` can never
  double-apply through this layer (the shard server adds a second,
  semantic idempotency net underneath — ``index/remote.py``).

``RpcClient(connect=...)`` accepts any dialer: the chaos seam (the
reference's ``net/chaos.py``, ROADMAP item 18) and the tests put a
wrapped socket under every connection without touching protocol code.

Layering: ``net/`` imports nothing of ``pipeline/``; ``index/`` imports
THIS module only (transport, not protocol).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Callable

import numpy as np

__all__ = [
    "DEFAULT_MAX_FRAME",
    "RpcClient",
    "RpcError",
    "RpcOverloaded",
    "RpcRemoteError",
    "RpcServer",
    "RpcUnavailable",
    "recv_frame",
    "send_frame",
]

DEFAULT_MAX_FRAME = 64 << 20  # 64 MiB: ~4M uint64 postings per frame

_LEN = struct.Struct("<I")


class RpcError(Exception):
    """Base class for every fault this layer raises."""


class RpcUnavailable(RpcError):
    """The peer could not be reached / answered within the deadline after
    every retry.  The fleet client treats this as a node failure (failover
    or spill); it never means the request semantically failed."""


class RpcRemoteError(RpcError):
    """The handler on the peer raised.  Never retried — the request
    *reached* the peer and failed deterministically."""

    def __init__(self, etype: str, message: str):
        super().__init__(f"{etype}: {message}")
        self.etype = etype


class RpcOverloaded(RpcError):
    """The peer refused admission (overload shed), answering a counted
    reject with a ``retry_after`` hint instead of timing out.  Retriable
    — the handler never executed — and NEVER a node-death signal: the
    fleet client backs off in place on this, it must not fail over or
    promote (an overloaded-but-alive shard failed over would dump its
    load onto the survivors and cascade)."""

    def __init__(self, message: str, retry_after: float = 0.0):
        super().__init__(message)
        self.retry_after = max(0.0, float(retry_after))


class FrameTooLarge(RpcError):
    """A peer announced (or sent) a frame beyond the cap."""


def _count_frame_drop(kind: str) -> None:
    from advanced_scrapper_tpu_torch.obs import telemetry

    telemetry.event_counter(
        "astpu_rpc_frames_dropped_total",
        "RPC frames dropped by the framing guards, by reason",
        reason=kind,
    ).inc()


def send_frame(sock, header: dict, arrays=()) -> None:
    """One framed message: header JSON + the raw bytes of each array.

    Array wire metadata (dtype/shape) goes into the header under
    ``_arrays``; callers never put binary in the JSON.
    """
    metas = []
    bufs = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        metas.append({"dtype": a.dtype.str, "shape": list(a.shape)})
        bufs.append(a.tobytes())
    h = dict(header)
    h["_arrays"] = metas
    hb = json.dumps(h).encode("utf-8")
    body_len = _LEN.size + len(hb) + sum(len(b) for b in bufs)
    sock.sendall(
        b"".join([_LEN.pack(body_len), _LEN.pack(len(hb)), hb, *bufs])
    )


def _read_exact(sock, n: int, deadline: float | None) -> bytes:
    """Read exactly ``n`` bytes or raise; the deadline bounds the WHOLE
    read, so a peer dribbling one byte per timeout window (slow-loris)
    still gets cut off at the frame budget."""
    parts: list[bytes] = []
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("frame read deadline exceeded")
            sock.settimeout(min(remaining, 10.0))
        # plain recv, not recv_into: ChaosSocket's fragmented-read fault
        # intercepts recv, so the reassembly below is what chaos stresses
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def recv_frame(
    sock,
    *,
    max_frame: int = DEFAULT_MAX_FRAME,
    frame_deadline: float | None = None,
) -> tuple[dict, list[np.ndarray]] | None:
    """Read one frame → ``(header, arrays)``; ``None`` on clean EOF.

    ``frame_deadline`` is seconds allowed for the whole frame once its
    length prefix arrived.  Oversized frames raise :class:`FrameTooLarge`
    after counting the drop — the caller must close the connection (the
    stream position is unrecoverable by design).
    """
    # the wait for the FIRST byte runs under whatever timeout the caller
    # armed (the server's idle timeout, the client's call budget); the
    # frame deadline starts once the length prefix begins arriving
    first = sock.recv(_LEN.size)
    if not first:
        return None
    deadline = (
        time.monotonic() + frame_deadline if frame_deadline is not None else None
    )
    if len(first) < _LEN.size:
        first += _read_exact(sock, _LEN.size - len(first), deadline)
    (body_len,) = _LEN.unpack(first)
    if body_len > max_frame:
        _count_frame_drop("oversize")
        raise FrameTooLarge(f"frame of {body_len} bytes exceeds cap {max_frame}")
    body = _read_exact(sock, body_len, deadline)
    (hlen,) = _LEN.unpack_from(body, 0)
    if hlen > body_len - _LEN.size:
        _count_frame_drop("malformed")
        raise RpcError(f"header length {hlen} exceeds frame body {body_len}")
    header = json.loads(body[_LEN.size : _LEN.size + hlen].decode("utf-8"))
    arrays: list[np.ndarray] = []
    off = _LEN.size + hlen
    for meta in header.pop("_arrays", []):
        dt = np.dtype(meta["dtype"])
        count = int(np.prod(meta["shape"])) if meta["shape"] else 1
        nbytes = dt.itemsize * count
        if off + nbytes > len(body):
            _count_frame_drop("malformed")
            raise RpcError("array bytes exceed frame body")
        arrays.append(
            np.frombuffer(body, dt, count=count, offset=off).reshape(
                meta["shape"]
            )
        )
        off += nbytes
    return header, arrays


def backoff_delays(
    attempts: int, *, base: float, cap: float, seed
) -> list[float]:
    """Capped exponential backoff with deterministic full jitter: delay
    ``i`` is uniform in ``(0, min(cap, base·2^i)]``, drawn from a RNG
    seeded by ``seed`` so a given (client, request) retries identically
    on every run — the chaos-certification requirement."""
    import random

    r = random.Random(f"rpc-backoff|{seed}")
    return [
        r.uniform(0, min(cap, base * (2.0**i))) or base
        for i in range(max(0, attempts))
    ]


class RpcServer:
    """Threaded RPC endpoint: one handler table, one idempotency cache.

    ``handlers`` maps method name → ``fn(header, arrays) -> (header,
    arrays)`` (returning a bare dict means no arrays).  A raising handler
    answers an error frame; the connection survives.  A malformed,
    oversized or deadline-blowing frame kills ONLY that connection.

    Every server answers ``__ping__`` natively — the health-check /
    promotion probe needs no handler wiring.

    **Admission** (``admission=``, a
    :class:`~advanced_scrapper_tpu_torch.runtime.admission.AdmissionController`):
    each request to a gated method (``admission_methods``; None = all)
    must be admitted before it may claim the idempotency table or run a
    handler; a refusal answers a counted ``RpcOverloaded`` error frame
    carrying the retry-after hint, and is deliberately NOT cached under
    the request id — the same id retried later must get a fresh
    admission decision.  ``__ping__`` always bypasses admission: an
    overloaded server must stay provably alive, or overload becomes
    indistinguishable from death and triggers failover.
    ``method_priority`` maps method → priority class (default NORMAL).

    ``admission_resolver`` is the PER-REQUEST half of the same gate: a
    callable ``(method, header) -> (controller, priority) | None``
    consulted before the static controller (the service gateway resolves
    the request's tenant id to that tenant's own token bucket here).  A
    resolved gate stacks UNDER the shared one — it is admitted first and
    refused first, so a tenant over its quota is stopped at its own
    bucket (billed to its own pressure series) without consuming a
    shared slot, and its refusal rides the exact same uncached,
    retry-after-carrying ``RpcOverloaded`` path.  Resolving through the
    header rather than raising inside a handler is load-bearing: handler
    exceptions are remembered under the request id and would replay a
    stale refusal at the client's retry.
    """

    def __init__(
        self,
        handlers: dict[str, Callable],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_frame: int = DEFAULT_MAX_FRAME,
        frame_deadline: float = 30.0,
        idle_timeout: float = 300.0,
        idempotent_cache: int = 512,
        name: str = "rpc",
        admission=None,
        admission_methods=None,
        method_priority: dict[str, int] | None = None,
        admission_resolver=None,
    ):
        self.handlers = dict(handlers)
        self.admission = admission
        self.admission_resolver = admission_resolver
        self.admission_methods = (
            None if admission_methods is None else frozenset(admission_methods)
        )
        self.method_priority = dict(method_priority or {})
        self.host = host
        self.port = port
        self.max_frame = max_frame
        self.frame_deadline = frame_deadline
        self.idle_timeout = idle_timeout
        self.name = name
        self._cache_cap = idempotent_cache
        self._cache: dict[str, tuple[dict, list]] = {}
        self._cache_order: list[str] = []
        self._cache_lock = threading.Lock()
        self._inflight: dict[str, threading.Event] = {}
        self._stop = threading.Event()
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self.calls = 0          # handler executions (not replays)
        self.replays = 0        # idempotent cache hits
        self.overload_rejects = 0  # admission refusals answered
        self._instrument()

    def _instrument(self) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._m_calls = telemetry.counter(
            "astpu_rpc_server_calls_total", "handler executions", server=self.name
        )
        self._m_replays = telemetry.counter(
            "astpu_rpc_server_replays_total",
            "duplicate request ids answered from the idempotency cache",
            server=self.name,
        )
        self._m_errors = telemetry.counter(
            "astpu_rpc_server_errors_total", "handler exceptions answered as errors",
            server=self.name,
        )
        # always-on (like every admission counter): an overload reject
        # during an incident must be visible with telemetry off
        self._m_overload: dict[str, object] = {}  # method → reject counter
        self._m_seconds: dict[str, object] = {}  # method → latency histogram

    def _overload_counter(self, method: str):
        c = self._m_overload.get(method)
        if c is None:
            from advanced_scrapper_tpu_torch.obs import telemetry

            c = telemetry.REGISTRY.counter(
                "astpu_rpc_overload_rejects_total",
                "requests refused admission and answered RpcOverloaded",
                always=True, server=self.name, method=method,
            )
            self._m_overload[method] = c
        return c

    def _method_seconds(self, method: str):
        """Per-method server-side latency histogram (lazy: the method set
        is the handler table, but only methods actually called pay a
        series).  Observations carry the propagated trace id as a
        slow-call exemplar, so a p99 outlier on ``/metrics`` names the
        stitched trace that caused it."""
        h = self._m_seconds.get(method)
        if h is None:
            from advanced_scrapper_tpu_torch.obs import telemetry

            h = telemetry.histogram(
                "astpu_rpc_server_seconds",
                "server-side handler wall clock, by method",
                server=self.name,
                method=method,
            )
            self._m_seconds[method] = h
        return h

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RpcServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._sock.settimeout(0.5)
        t = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"rpc-accept-{self.name}"
        )
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        # sever live connections too: a stopped server must look DEAD to
        # its peers (transport fault → failover), never answer from
        # torn-down state behind a still-open socket
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            # prune finished handlers: a long-lived shard server under a
            # reconnect-happy client must not accumulate dead Thread
            # objects (and stop() must not join thousands of them)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # -- request handling --------------------------------------------------

    def _cached(self, rid: str):
        with self._cache_lock:
            return self._cache.get(rid)

    def _remember(self, rid: str, resp) -> None:
        with self._cache_lock:
            if rid not in self._cache:
                self._cache[rid] = resp
                self._cache_order.append(rid)
                while len(self._cache_order) > self._cache_cap:
                    self._cache.pop(self._cache_order.pop(0), None)
            ev = self._inflight.pop(rid, None)
        if ev is not None:
            ev.set()

    def _claim(self, rid: str):
        """Idempotency admission, atomic with the cache check: returns
        ``("hit", resp)``, ``("mine", None)`` (this thread executes), or
        ``("wait", event)`` (a duplicate of a request STILL RUNNING —
        waiting closes the check-then-execute race where a timeout retry
        lands while the first execution is in flight)."""
        with self._cache_lock:
            hit = self._cache.get(rid)
            if hit is not None:
                return "hit", hit
            ev = self._inflight.get(rid)
            if ev is not None:
                return "wait", ev
            self._inflight[rid] = threading.Event()
            return "mine", None

    def _serve_conn(self, conn: socket.socket) -> None:
        from advanced_scrapper_tpu_torch.obs import trace as _trace

        with self._conns_lock:
            self._conns.add(conn)
        try:
            while not self._stop.is_set():
                conn.settimeout(self.idle_timeout)
                try:
                    frame = recv_frame(
                        conn,
                        max_frame=self.max_frame,
                        frame_deadline=self.frame_deadline,
                    )
                except socket.timeout:
                    _count_frame_drop("deadline")
                    return  # slow-loris / idle peer: cut it loose
                except (FrameTooLarge, RpcError):
                    return  # counted inside recv_frame; stream unusable
                if frame is None:
                    return
                header, arrays = frame
                rid = header.get("id")
                method = header.get("method", "")
                # propagated trace context (popped: handlers never see the
                # transport's trace plumbing in their header dict)
                tctx = _trace.context_from_wire(header.pop("_trace", None))
                if not self._handle_request(
                    conn, header, arrays, rid, method, tctx
                ):
                    return
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _unclaim(self, rid: str) -> None:
        """Withdraw an in-flight claim that will never execute (admission
        refused it): wake any waiting duplicate — it finds no cached
        response, drops its connection, and the NEXT retry claims and
        re-attempts admission fresh."""
        with self._cache_lock:
            ev = self._inflight.pop(rid, None)
        if ev is not None:
            ev.set()

    def _handle_request(self, conn, header, arrays, rid, method, tctx) -> bool:
        """Claim → admit → execute-or-replay → respond for one request.
        Returns False when the connection must be dropped (a
        still-in-flight duplicate outlived the frame budget).

        Order is load-bearing: the idempotency claim comes FIRST, so the
        replay and wait-for-duplicate paths — which run no handler —
        never consume an admission slot (a retried slow insert parked in
        ``val.wait`` must not hold a ``max_inflight`` seat and amplify
        the very storm admission damps); only the "mine" executor pays
        admission, and a refusal withdraws the claim so waiters and
        later retries get a fresh decision."""
        from advanced_scrapper_tpu_torch.obs import trace as _trace

        if rid is not None:
            state, val = self._claim(rid)
            if state == "hit":
                self.replays += 1
                self._m_replays.inc()
                # the retry carried the SAME trace header as the
                # original attempt; record the replay under it so
                # a stitched trace shows the dedup, not a gap
                _trace.record(
                    "event", "rpc.replay",
                    server=self.name, method=method, rid=rid,
                    **({"trace": tctx[0]} if tctx else {}),
                )
                send_frame(conn, val[0], val[1])
                return True
            if state == "wait":
                # a timeout retry of a request whose FIRST
                # execution is still running: executing again
                # would double-apply, so wait for its result and
                # replay; if it outlives the frame budget, drop
                # this connection — the next retry finds the cache
                if val.wait(self.frame_deadline):
                    hit = self._cached(rid)
                    if hit is not None:
                        self.replays += 1
                        self._m_replays.inc()
                        send_frame(conn, hit[0], hit[1])
                        return True
                return False
        gates: list = []  # (controller, priority); per-request gate FIRST
        if self.admission_resolver is not None and method != "__ping__":
            resolved = self.admission_resolver(method, header)
            if resolved is not None:
                gates.append(resolved)
        if (
            self.admission is not None
            and method != "__ping__"
            and (
                self.admission_methods is None
                or method in self.admission_methods
            )
        ):
            from advanced_scrapper_tpu_torch.runtime.admission import (
                PRIORITY_NORMAL,
            )

            gates.append((
                self.admission,
                self.method_priority.get(method, PRIORITY_NORMAL),
            ))
        admitted: list = []  # (controller, decision) already holding slots
        for ctrl, prio in gates:
            adm = ctrl.admit(prio)
            if adm.admitted:
                admitted.append((ctrl, adm))
                continue
            # counted reject + retry-after hint.  Deliberately NOT
            # remembered under rid (claim withdrawn): a later retry
            # of the same request must get a fresh admission
            # decision, never a replayed refusal.  Slots already
            # taken from earlier gates are handed back — a refusal
            # must never leak inflight seats.
            for held_ctrl, held in admitted:
                held_ctrl.release(held)
            if rid is not None:
                self._unclaim(rid)
            self.overload_rejects += 1
            self._overload_counter(method).inc()
            send_frame(
                conn,
                {
                    "id": rid,
                    "error": (
                        f"{self.name}: {method} refused "
                        f"admission ({adm.reason})"
                    ),
                    "etype": "RpcOverloaded",
                    "retry_after": adm.retry_after,
                },
            )
            return True
        try:
            return self._execute_and_respond(
                conn, header, arrays, rid, method, tctx
            )
        finally:
            for ctrl, adm in admitted:
                ctrl.release(adm)

    def _execute_and_respond(
        self, conn, header, arrays, rid, method, tctx
    ) -> bool:
        from advanced_scrapper_tpu_torch.obs import trace as _trace

        resp_h: dict
        resp_a: list = []
        if method == "__ping__":
            resp_h = {"id": rid, "ok": True, "pong": True}
        elif method not in self.handlers:
            resp_h = {
                "id": rid,
                "error": f"no such method {method!r}",
                "etype": "KeyError",
            }
        else:
            # server-side span under the PROPAGATED context: the
            # handler thread has no ambient trace of its own, so a
            # span here carrying the client's trace id proves the
            # id crossed the socket — the stitched-trace half of
            # the observability plane
            t0 = time.perf_counter()
            try:
                with _trace.trace_context(*(tctx or (None, None))):
                    with _trace.span(
                        f"rpc.{method}", server=self.name, rid=rid
                    ):
                        out = self.handlers[method](header, arrays)
                if isinstance(out, tuple):
                    resp_h, resp_a = dict(out[0]), list(out[1])
                else:
                    resp_h, resp_a = dict(out or {}), []
                resp_h.setdefault("ok", True)
                resp_h["id"] = rid
                self.calls += 1
                self._m_calls.inc()
            except Exception as e:  # answered, not fatal
                self._m_errors.inc()
                resp_h = {
                    "id": rid,
                    "error": str(e),
                    "etype": type(e).__name__,
                }
            self._method_seconds(method).observe(
                time.perf_counter() - t0,
                trace=tctx[0] if tctx else None,
            )
        # remember BEFORE sending: a cut mid-response must replay
        # the same bytes, not re-execute the handler
        if rid is not None:
            self._remember(rid, (resp_h, resp_a))
        send_frame(conn, resp_h, resp_a)
        return True


class RpcClient:
    """One connection to one RPC endpoint, with retry + reconnect.

    Thread-safe: one in-flight call at a time (a lock serialises the
    frame exchange); the fleet client holds one ``RpcClient`` per node
    and fans out across nodes with threads, not across one socket.
    """

    _seq_lock = threading.Lock()
    _seq = 0

    def __init__(
        self,
        address: tuple[str, int],
        *,
        timeout: float = 10.0,
        retries: int = 3,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        max_frame: int = DEFAULT_MAX_FRAME,
        connect: Callable | None = None,
        seed: int = 0,
        sleep=time.sleep,
        overload_wait_cap: float = 5.0,
    ):
        self.address = tuple(address)
        self.timeout = timeout
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        #: ceiling on any single retry-after honor: a peer hinting "come
        #: back in 200 s" (a triggered pause, a near-zero insert_rate)
        #: must not park one call() for that long — the client sleeps at
        #: most this, retries, and surfaces RpcOverloaded (hint intact)
        #: if still refused, letting the CALLER's budget discipline rule
        self.overload_wait_cap = float(overload_wait_cap)
        self.max_frame = max_frame
        self.sleep = sleep
        self._connect = connect
        self._seed = seed
        self._sock = None
        self._lock = threading.Lock()
        with RpcClient._seq_lock:
            self._cid = RpcClient._seq
            RpcClient._seq += 1
        # random token: request ids must be unique ACROSS processes — the
        # server's idempotency cache is global per server, and two worker
        # processes both counting from c0-1 would replay each other's
        # cached responses for unrelated requests
        import os as _os

        self._token = _os.urandom(4).hex()
        self._rid = 0
        self._instrument()

    def _instrument(self) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._m_retries = telemetry.counter(
            "astpu_rpc_client_retries_total",
            "call attempts beyond the first (timeouts + connection faults)",
        )
        # always-on: overload behaviour must be auditable in an incident
        # (the loadgen/crashsweep acceptance reads these to prove the
        # client actually honored the server's retry-after hints)
        self._m_overloaded = telemetry.REGISTRY.counter(
            "astpu_rpc_client_overloaded_total",
            "responses refused admission by the peer (RpcOverloaded)",
            always=True,
        )
        self._m_overload_wait = telemetry.REGISTRY.counter(
            "astpu_rpc_overload_backoff_seconds_total",
            "seconds slept honoring peer retry-after hints",
            always=True,
        )

    # -- connection --------------------------------------------------------

    def _dial(self):
        if self._connect is not None:
            return self._connect(self.address)
        return socket.create_connection(self.address, timeout=self.timeout)

    def _ensure_sock(self):
        if self._sock is None:
            self._sock = self._dial()
        return self._sock

    def close(self) -> None:
        with self._lock:
            self._drop_sock()

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- calls -------------------------------------------------------------

    def next_request_id(self) -> str:
        with self._lock:
            self._rid += 1
            return f"c{self._token}.{self._cid}-{self._rid}"

    def call(
        self,
        method: str,
        header: dict | None = None,
        arrays=(),
        *,
        timeout: float | None = None,
        idempotent: bool = True,
        request_id: str | None = None,
    ):
        """One RPC → ``(header, arrays)``.

        Connection faults and deadline misses retry (idempotent calls
        only) under the SAME request id with capped jittered backoff;
        :class:`RpcRemoteError` (handler raised) never retries.  The
        request id may be supplied by the caller — how the fleet's spill
        replay reuses the ORIGINAL id, so a posting spilled after a
        half-delivered insert still cannot double-apply.
        """
        rid = request_id or self.next_request_id()
        budget = self.timeout if timeout is None else timeout
        req = dict(header or {})
        req["id"] = rid
        req["method"] = method
        # trace propagation: the ambient context rides the request header,
        # FIXED across retries (the header is built once) — a retried call
        # replayed from the server cache still belongs to the same trace
        from advanced_scrapper_tpu_torch.obs import trace as _trace

        tctx = _trace.wire_context()
        if tctx is not None:
            req["_trace"] = tctx
        attempts = (self.retries + 1) if idempotent else 1
        delays = backoff_delays(
            attempts - 1,
            base=self.backoff_base,
            cap=self.backoff_cap,
            seed=f"{self._seed}|{rid}",
        )
        # overload backoffs have their own budget (retriable even for
        # non-idempotent calls — the handler never executed) and their
        # own deterministic jitter stream; the peer's retry-after hint is
        # the floor of every wait
        ov_delays = backoff_delays(
            self.retries,
            base=self.backoff_base,
            cap=self.backoff_cap,
            seed=f"{self._seed}|{rid}|overload",
        )
        last: Exception | None = None
        transport_tries = 0
        overload_tries = 0
        while True:
            try:
                with self._lock:
                    sock = self._ensure_sock()
                    sock.settimeout(budget)
                    send_frame(sock, req, arrays)
                    resp = recv_frame(
                        sock, max_frame=self.max_frame, frame_deadline=budget
                    )
                if resp is None:
                    raise ConnectionError("server closed the connection")
                h, a = resp
                if h.get("error") is not None:
                    if h.get("etype") == "RpcOverloaded":
                        raise RpcOverloaded(
                            h["error"], h.get("retry_after", 0.0)
                        )
                    raise RpcRemoteError(h.get("etype", "Error"), h["error"])
                return h, a
            except RpcOverloaded as e:
                # counted reject from the peer: back off at least its
                # retry-after hint and retry under the SAME request id —
                # never a node failure, so never RpcUnavailable
                overload_tries += 1
                self._m_overloaded.inc()
                if overload_tries > self.retries:
                    raise
                wait = min(
                    max(e.retry_after, ov_delays[overload_tries - 1]),
                    self.overload_wait_cap,
                )
                self._m_overload_wait.inc(wait)
                self.sleep(wait)
            except RpcRemoteError:
                raise
            except (ConnectionError, OSError, socket.timeout, RpcError) as e:
                last = e
                with self._lock:
                    self._drop_sock()
                transport_tries += 1
                if transport_tries >= attempts:
                    break
                self._m_retries.inc()
                self.sleep(delays[transport_tries - 1])
        raise RpcUnavailable(
            f"{method} to {self.address} failed after {attempts} attempts: {last}"
        )

    def ping(self, *, timeout: float | None = None) -> bool:
        """Health probe; False on any transport fault, never raises."""
        try:
            h, _ = self.call(
                "__ping__", timeout=timeout if timeout is not None else 2.0
            )
            return bool(h.get("pong"))
        except RpcError:
            return False
