"""Distributed pull-based work leasing over TCP + NDJSON.

The port's copy of the reference's ``net/lease.py``; its frames are the
reference's byte for byte, so a port client works against a reference
server and the other way round:

- newline-delimited JSON protocol: ``request_tasks{num_urls}`` →
  ``task_batch{urls}``, ``result{url, html_content}``, ``heartbeat``,
  ``tasks_completed`` → ``acknowledge_completion``; frames past
  ``max_frame_bytes`` without a newline cut the connection
  (:class:`FrameTooLong`);
- **lease fault tolerance**: every url handed to a client is tracked in
  its assigned set and returned to the queue if the client disconnects
  before reporting it, or stops sending complete frames for ``lease_ttl``
  seconds (the TTL reaper) — pull-based work stealing; results for urls a
  client does not hold are rejected as strays;
- **admission**: a refused ``request_tasks`` gets an empty ``task_batch``
  with ``shed: true`` and a ``retry_after`` hint;
- the client keeps its local queue topped up (``batch_size`` urls whenever
  depth < ``min_queue_length``, rate-capped), heartbeats while busy, and
  dials with capped exponential backoff (``net.rpc.backoff_delays``);
- clients ship raw HTML (or ``ERROR:``-prefixed strings) back; the server
  parses centrally with the extractor plugin on the port's HTML tree
  (``core/soup.py``) and writes the standard success/failed CSVs, handing
  each success to ``on_success`` — e.g. ``TpuBatchBackend.submit``, which
  runs Kernel A once a batch on the card.

Observability: the url queue is a runtime ``Edge`` (``graph="lease"``),
the ``astpu_lease_*`` series, and an optional ``status_port`` serving
``GET /metrics`` and ``GET /status`` (with :meth:`LeaseServer.fleet_status`).
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from typing import Callable

from advanced_scrapper_tpu_torch.config import FeedConfig
from advanced_scrapper_tpu_torch.obs.stats import RateStats
from advanced_scrapper_tpu_torch.runtime import Edge


def _send_json(sock: socket.socket, lock: threading.Lock, obj: dict) -> None:
    data = (json.dumps(obj) + "\n").encode("utf-8")
    with lock:
        sock.sendall(data)


class FrameTooLong(ValueError):
    """A peer exceeded the line-reassembly cap without sending a newline."""


class _LineReader:
    """Reassemble newline-framed JSON from a stream socket (client ``:146-181``).

    ``max_line`` caps the reassembly buffer: a peer that streams bytes
    without ever framing them (malice, corruption, or a runaway payload)
    previously grew ``self.buf`` without bound.  Exceeding the cap counts
    the drop in telemetry and raises :class:`FrameTooLong` — the caller
    must close the connection (the stream position is unrecoverable)."""

    def __init__(self, sock: socket.socket, max_line: int = 16 << 20):
        self.sock = sock
        self.buf = b""
        self.max_line = max_line

    def readline(self) -> dict | None:
        while b"\n" not in self.buf:
            if len(self.buf) > self.max_line:
                from advanced_scrapper_tpu_torch.obs import telemetry

                telemetry.event_counter(
                    "astpu_lease_oversize_frames_total",
                    "connections cut for exceeding the line-frame cap",
                ).inc()
                raise FrameTooLong(
                    f"{len(self.buf)} unframed bytes exceed the "
                    f"{self.max_line} B line cap"
                )
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        if not line.strip():
            return self.readline()
        return json.loads(line.decode("utf-8"))


class LeaseServer:
    """Task server: leases url batches, collects results, survives client loss."""

    def __init__(
        self,
        cfg: FeedConfig,
        urls: list[str],
        *,
        host: str | None = None,
        port: int | None = None,
        status_port: int | None = None,
        admission=None,
    ):
        """``status_port`` mirrors the control plane's observability
        endpoints (``GET /metrics`` + ``GET /status``) on a small HTTP
        server beside the TCP lease socket: 0 = ephemeral port, None =
        only when telemetry is enabled (``ASTPU_TELEMETRY``).

        ``admission`` (an
        :class:`~advanced_scrapper_tpu_torch.runtime.admission.AdmissionController`)
        sheds lease *grants* under pressure: a refused ``request_tasks``
        gets an EMPTY ``task_batch`` carrying ``shed: true`` and a
        ``retry_after`` hint — the client backs its refill loop off
        instead of hammering, results/heartbeats flow untouched, and the
        shed is counted.  Leases already held are never reclaimed by
        admission (that is the TTL reaper's job)."""
        self.cfg = cfg
        self.admission = admission
        self.host = host if host is not None else cfg.host
        self.port = port if port is not None else cfg.port
        self._status_port = status_port
        self.status_server = None
        # the work queue is a runtime Edge: the scheduler's depth/stall
        # telemetry (astpu_edge_*{graph="lease"}) and the crash snapshot
        # see the lease plane's backlog exactly like a local stage's
        self._urls: Edge = Edge("urls", graph="lease")
        # dedup on ingest: a url is one unit of work (the per-client
        # assigned sets — and the stray-result guard built on them — are
        # keyed by url, so a duplicated input row would leave a pending
        # count that can never drain)
        seen: set[str] = set()
        for u in urls:
            if u not in seen:
                seen.add(u)
                self._urls.put(u)
        self._pending = len(seen)
        self._assigned: dict[int, set[str]] = {}
        self._last_seen: dict[int, float] = {}   # cid → monotonic stamp of
        #   the last COMPLETE frame (heartbeats count; dribbled bytes don't)
        self._conns: dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self.results: list[dict] = []
        self.stats = RateStats()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._sock: socket.socket | None = None
        self._next_client = 0
        self._instrument()

    _seq_lock = threading.Lock()
    _seq = 0

    def _instrument(self) -> None:
        """Per-worker fleet gauges + protocol counters.  The per-client
        assigned counts export as ONE expanding callback gauge, so a fleet
        of N workers is N series on ``/metrics`` without per-connect
        registration churn.  An EXPLICIT ``status_port`` forces the lease
        instrumentation live even when ``ASTPU_TELEMETRY`` is off — an
        operator who asked for the mirror must not scrape an empty one.
        Per-instance ``server=`` label: concurrent lease servers in one
        process must not replace each other's series."""
        from advanced_scrapper_tpu_torch.obs import telemetry

        always = self._status_port is not None
        with LeaseServer._seq_lock:
            sid = str(LeaseServer._seq)
            LeaseServer._seq += 1
        self._m_leased = telemetry.REGISTRY.counter(
            "astpu_lease_urls_leased_total", "urls handed to clients",
            always=always, server=sid,
        )
        self._m_results = telemetry.REGISTRY.counter(
            "astpu_lease_results_total", "results accepted from clients",
            always=always, server=sid,
        )
        self._m_stray = telemetry.REGISTRY.counter(
            "astpu_lease_stray_results_total",
            "duplicate/stray results rejected by the assignment guard",
            always=always, server=sid,
        )
        self._m_requeued = telemetry.REGISTRY.counter(
            "astpu_lease_urls_requeued_total",
            "urls returned to the queue by client disconnects",
            always=always, server=sid,
        )
        self._m_ttl_expired = telemetry.REGISTRY.counter(
            "astpu_lease_ttl_expired_total",
            "clients whose leases were reclaimed on heartbeat timeout "
            "(hung-but-connected workers)",
            always=always, server=sid,
        )
        self._m_shed = telemetry.REGISTRY.counter(
            "astpu_lease_shed_grants_total",
            "lease requests refused admission under pressure (answered "
            "empty with a retry-after hint)",
            always=True, server=sid,
        )
        telemetry.gauge_fn(
            "astpu_lease_pending",
            lambda s: s._pending,
            owner=self,
            always=always,
            help="urls not yet successfully resulted",
            server=sid,
        )
        telemetry.gauge_fn(
            "astpu_lease_clients_connected",
            lambda s: len(s._assigned),
            owner=self,
            always=always,
            help="clients with an open assignment ledger",
            server=sid,
        )
        telemetry.gauge_fn(
            "astpu_lease_assigned",
            lambda s: {
                cid: len(urls) for cid, urls in s._assigned_snapshot().items()
            },
            owner=self,
            expand="client",
            always=always,
            help="urls currently leased per client",
            server=sid,
        )
        telemetry.gauge_fn(
            "astpu_lease_request_rate",
            lambda s: s.stats.rates()[0],
            owner=self,
            always=always,
            help="task requests/s over the stats window",
            server=sid,
        )
        telemetry.gauge_fn(
            "astpu_lease_response_rate",
            lambda s: s.stats.rates()[1],
            owner=self,
            always=always,
            help="results/s over the stats window",
            server=sid,
        )

    def _assigned_snapshot(self) -> dict[int, set[str]]:
        with self._lock:
            return {cid: set(urls) for cid, urls in self._assigned.items()}

    def fleet_status(self) -> dict:
        """JSON-able fleet view — merged into the status endpoint's payload
        and directly usable by dashboards."""
        req_rate, resp_rate = self.stats.rates()
        with self._lock:
            return {
                "pending": self._pending,
                "clients": {
                    str(cid): len(urls) for cid, urls in self._assigned.items()
                },
                "results": len(self.results),
                "request_rate": round(req_rate, 2),
                "response_rate": round(resp_rate, 2),
            }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "LeaseServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        if self.port == 0:
            self.port = self._sock.getsockname()[1]
        self._sock.listen(self.cfg.max_clients)
        self._sock.settimeout(0.5)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        if self.cfg.lease_ttl > 0:
            r = threading.Thread(target=self._ttl_reaper, daemon=True)
            r.start()
            self._threads.append(r)
        from advanced_scrapper_tpu_torch.obs import telemetry

        if self._status_port is not None or telemetry.enabled():
            self.status_server = telemetry.StatusServer(
                port=self._status_port or 0,
                name=f"lease-{self.port}",
                extra_status=lambda: {"lease": self.fleet_status()},
            ).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        for t in self._threads:
            t.join(timeout=5)
        if self.status_server is not None:
            self.status_server.stop()
            self.status_server = None

    def done(self) -> bool:
        with self._lock:
            return self._pending <= 0

    def wait_done(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.done():
                return True
            time.sleep(0.05)
        return False

    # -- accept / client handling -----------------------------------------

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                cid = self._next_client
                self._next_client += 1
                self._assigned[cid] = set()
                self._last_seen[cid] = time.monotonic()
                self._conns[cid] = conn
            t = threading.Thread(
                target=self._handle_client, args=(conn, cid), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _lease(self, cid: int, n: int) -> list[str]:
        out = []
        with self._lock:
            # setdefault: a TTL-expired client that wakes up and keeps
            # requesting gets a fresh ledger (its old leases were already
            # requeued; its connection is being torn down, so these new
            # leases flow back via the normal disconnect return)
            ledger = self._assigned.setdefault(cid, set())
            for _ in range(n):
                try:
                    u = self._urls.get_nowait()
                except queue.Empty:
                    break
                out.append(u)
                ledger.add(u)
        self._m_leased.inc(len(out))
        return out

    def _return_unprocessed(self, cid: int) -> None:
        """Lease return on disconnect — the fault-tolerance core (ref :80-84)."""
        returned = 0
        with self._lock:
            for u in self._assigned.pop(cid, ()):
                self._urls.put(u)
                returned += 1
            self._last_seen.pop(cid, None)
            self._conns.pop(cid, None)
        if returned:
            self._m_requeued.inc(returned)
            from advanced_scrapper_tpu_torch.obs import trace

            trace.record(
                "event", "lease.requeue", client=cid, urls=returned
            )

    # -- heartbeat / TTL reclaim -------------------------------------------

    def _ttl_reaper(self) -> None:
        """Requeue leases whose client stopped producing complete frames
        for ``lease_ttl`` seconds — a wedged worker holds a perfectly
        healthy TCP connection, so disconnect-based reclaim (the only
        mechanism before the fleet PR) never fires for it.  Expiry also
        cuts the connection: late results from the zombie are then
        rejected by the assignment guard as strays."""
        ttl = self.cfg.lease_ttl
        tick = max(0.05, min(1.0, ttl / 4))
        while not self._stop.wait(tick):
            now = time.monotonic()
            expired: list[tuple[int, socket.socket | None]] = []
            with self._lock:
                for cid, seen in list(self._last_seen.items()):
                    if now - seen > ttl:
                        self._last_seen.pop(cid, None)
                        expired.append((cid, self._conns.pop(cid, None)))
            for cid, conn in expired:
                self._m_ttl_expired.inc()
                from advanced_scrapper_tpu_torch.obs import trace

                trace.record("event", "lease.ttl_expired", client=cid)
                self._return_unprocessed(cid)
                if conn is not None:
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        conn.close()
                    except OSError:
                        pass

    def _handle_client(self, conn: socket.socket, cid: int) -> None:
        from advanced_scrapper_tpu_torch.obs import trace as _trace

        reader = _LineReader(conn, max_line=self.cfg.max_frame_bytes)
        wlock = threading.Lock()
        try:
            while not self._stop.is_set():
                msg = reader.readline()
                if msg is None:
                    return
                with self._lock:
                    self._last_seen[cid] = time.monotonic()
                kind = msg.get("type")
                # propagated trace context (the client stamps its frames):
                # server-side lease spans stitch into the worker's trace
                tctx = _trace.context_from_wire(msg.pop("_trace", None))
                if kind == "heartbeat":
                    continue  # liveness only; the stamp above is the point
                if kind == "request_tasks":
                    self.stats.record_request()
                    adm = None
                    if self.admission is not None:
                        depth = None
                        if self.admission.max_queue > 0:
                            # only computed when a queue limit will read
                            # it: summing lens under the lock (no set
                            # copies) — the refill path is hot under
                            # exactly the load admission protects
                            with self._lock:
                                depth = sum(
                                    len(u) for u in self._assigned.values()
                                )
                        adm = self.admission.admit(queue_depth=depth)
                        if not adm.admitted:
                            # shed the GRANT, not the client: empty batch
                            # + retry-after, counted; the url queue keeps
                            # its work for whoever is admitted next
                            self._m_shed.inc()
                            _send_json(
                                conn, wlock,
                                {
                                    "type": "task_batch", "urls": [],
                                    "shed": True,
                                    "retry_after": adm.retry_after,
                                },
                            )
                            continue
                    try:
                        with _trace.trace_context(*(tctx or (None, None))):
                            with _trace.span("lease.lease", client=cid):
                                urls = self._lease(
                                    cid, int(msg.get("num_urls", 1))
                                )
                    finally:
                        if adm is not None:
                            self.admission.release(adm)
                    _send_json(conn, wlock, {"type": "task_batch", "urls": urls})
                elif kind == "result":
                    self.stats.record_response()
                    url = msg.get("url")
                    if tctx is not None:
                        _trace.record(
                            "event", "lease.result",
                            client=cid, url=msg.get("url"), trace=tctx[0],
                        )
                    with self._lock:
                        # accept only urls this client actually holds: a
                        # duplicate or stray result (a client racing its
                        # own half-frame death, a reconnect replay) must
                        # neither double-decrement the pending count (it
                        # would end the run with urls still queued) nor
                        # append a second row for a finished url
                        known = url in self._assigned.get(cid, ())
                        if known:
                            self._assigned[cid].discard(url)
                            self._pending -= 1
                    if known:
                        self._m_results.inc()
                        self.results.append(
                            {"url": url, "html_content": msg.get("html_content", "")}
                        )
                    else:
                        self._m_stray.inc()
                elif kind == "tasks_completed":
                    _send_json(conn, wlock, {"type": "acknowledge_completion"})
                    return
        except (ConnectionError, json.JSONDecodeError, OSError, FrameTooLong):
            pass  # FrameTooLong: counted in the reader; teardown requeues
        finally:
            self._return_unprocessed(cid)
            conn.close()

    # -- centralized parsing (ref server1.py:232-309) ----------------------

    def process_results(
        self,
        extractor: Callable,
        success_csv: str,
        failed_csv: str,
        *,
        on_success: Callable[[dict], None] | None = None,
    ) -> tuple[int, int]:
        """Parse every returned HTML with the extractor plugin → CSVs.

        ``ERROR:``-prefixed payloads (the client's fetch-failure sentinel)
        land in the failed CSV verbatim.
        """
        from advanced_scrapper_tpu_torch.core.soup import Soup
        from advanced_scrapper_tpu_torch.extractors import (
            FAILED_FIELDS,
            SUCCESS_FIELDS,
        )
        from advanced_scrapper_tpu_torch.storage.csvio import AppendCsv

        ok = bad = 0
        with AppendCsv(success_csv, SUCCESS_FIELDS) as okc, AppendCsv(
            failed_csv, FAILED_FIELDS
        ) as badc:
            for r in self.results:
                url, html = r["url"], r["html_content"]
                if html.startswith("ERROR:"):
                    badc.write_row({"url": url, "error": html[len("ERROR:") :].strip()})
                    bad += 1
                    continue
                try:
                    data = extractor(Soup(html))
                except Exception as e:
                    badc.write_row({"url": url, "error": str(e)})
                    bad += 1
                    continue
                if not data.get("title"):
                    badc.write_row({"url": url, "error": "Title is empty"})
                    bad += 1
                    continue
                data["url"] = url
                okc.write_row(data)
                ok += 1
                if on_success is not None:
                    on_success(dict(data))
        return ok, bad


class LeaseClient:
    """Worker node: fetch threads fed by a leased local queue (client1.py)."""

    def __init__(
        self,
        cfg: FeedConfig,
        transport_factory: Callable[[], object],
        *,
        host: str | None = None,
        port: int | None = None,
        sleep=time.sleep,
        connect: Callable | None = None,
    ):
        self.cfg = cfg
        self.host = host if host is not None else cfg.host
        self.port = port if port is not None else cfg.port
        self.transport_factory = transport_factory
        self.sleep = sleep
        # injectable dialer (``(host, port) -> socket``): the seam the
        # chaos harness uses to put a ChaosSocket under the whole client
        # without touching protocol code (net/chaos.py)
        self._connect = connect
        # leased-work and result queues as runtime Edges (queue-compat
        # surface): fleet hops ride the same abstraction as local stages
        self._tasks: Edge = Edge("tasks", graph="lease_client")
        self._results: Edge = Edge("results", graph="lease_client")
        self._inflight = 0              # urls popped but not yet resulted
        self._inflight_lock = threading.Lock()
        self._stop = threading.Event()
        self._drained = threading.Event()  # server sent an empty batch
        self._shed_until = 0.0  # monotonic: no lease requests before this
        #   (the server shed our grant and told us when to come back)
        self._sock: socket.socket | None = None
        self._wlock = threading.Lock()
        self._threads: list[threading.Thread] = []

    def _connect_with_backoff(self) -> socket.socket:
        """Dial the server, retrying refused/injected connect failures
        with capped exponential backoff + deterministic jitter — a worker
        that boots a moment before its server (or behind a flaky link)
        must join the fleet, not die on the first ECONNREFUSED."""
        from advanced_scrapper_tpu_torch.net.rpc import backoff_delays

        dial = self._connect or (
            lambda addr: socket.create_connection(addr, timeout=10)
        )
        attempts = max(1, self.cfg.connect_retries + 1)
        delays = backoff_delays(
            attempts - 1,
            base=self.cfg.connect_backoff,
            cap=2.0,
            seed=f"lease-connect|{self.host}:{self.port}",
        )
        last: Exception | None = None
        for attempt in range(attempts):
            if attempt:
                from advanced_scrapper_tpu_torch.obs import telemetry

                telemetry.event_counter(
                    "astpu_lease_connect_retries_total",
                    "lease-client connect attempts beyond the first",
                ).inc()
                self.sleep(delays[attempt - 1])
            try:
                return dial((self.host, self.port))
            except OSError as e:
                last = e
        raise ConnectionError(
            f"lease server {self.host}:{self.port} unreachable after "
            f"{attempts} attempts: {last}"
        ) from last

    def run(self, *, max_seconds: float = 60.0) -> int:
        """Connect, pull leases, fetch, stream results; returns #fetched.

        Stops when the server's queue is drained (an empty ``task_batch``)
        and all local work is done, or after ``max_seconds``.
        """
        from advanced_scrapper_tpu_torch.obs import trace as _trace

        # one trace per client run (inheriting an ambient one if the
        # caller opened it): every frame this worker sends is stamped, so
        # the server's lease/result spans stitch to THIS worker
        ctx = _trace.current_context()
        if ctx is None and _trace.enabled():
            ctx = (_trace.new_trace_id(), _trace.new_span_id())
        tfrag = {"t": ctx[0], "s": ctx[1]} if ctx else None

        def _stamp(obj: dict) -> dict:
            if tfrag is not None:
                obj["_trace"] = tfrag
            return obj

        self._sock = self._connect_with_backoff()
        reader = _LineReader(self._sock, max_line=self.cfg.max_frame_bytes)
        fetched = 0

        def receiver():
            nonlocal fetched
            try:
                while not self._stop.is_set():
                    msg = reader.readline()
                    if msg is None:
                        return
                    if msg.get("type") == "task_batch":
                        urls = msg.get("urls", [])
                        if msg.get("shed"):
                            # an overload shed, NOT a drained queue: honor
                            # the retry-after before the next request (a
                            # shed misread as drained would end the run
                            # with work still queued)
                            self._shed_until = time.monotonic() + float(
                                msg.get("retry_after", 0.0)
                            )
                            from advanced_scrapper_tpu_torch.obs import telemetry

                            telemetry.event_counter(
                                "astpu_lease_shed_honored_total",
                                "shed lease grants whose retry-after the "
                                "client honored",
                            ).inc()
                        elif not urls:
                            self._drained.set()
                        for u in urls:
                            self._tasks.put(u)
                    elif msg.get("type") == "acknowledge_completion":
                        return
            except (
                ConnectionError, OSError, json.JSONDecodeError, FrameTooLong
            ):
                return

        def worker():
            transport = self.transport_factory()
            try:
                while not self._stop.is_set():
                    try:
                        url = self._tasks.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    with self._inflight_lock:
                        self._inflight += 1
                    try:
                        html = transport.fetch(url)
                    except Exception as e:
                        html = f"ERROR: {e}"
                    finally:
                        self._results.put((url, html))
                        with self._inflight_lock:
                            self._inflight -= 1
            finally:
                try:
                    transport.close()
                except Exception:
                    pass

        def sender():
            nonlocal fetched
            while not (self._stop.is_set() and self._results.empty()):
                try:
                    url, html = self._results.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    _send_json(
                        self._sock,
                        self._wlock,
                        _stamp(
                            {"type": "result", "url": url, "html_content": html}
                        ),
                    )
                    fetched += 1
                except (ConnectionError, OSError):
                    return

        threads = [threading.Thread(target=receiver, daemon=True)]
        threads += [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.cfg.client_threads)
        ]
        threads.append(threading.Thread(target=sender, daemon=True))
        for t in threads:
            t.start()
        self._threads = threads

        # monitor loop: low-water refill, rate-capped (client1.py:209-234)
        interval = 1.0 / self.cfg.client_rate
        hb_interval = self.cfg.heartbeat_interval or (
            min(1.0, self.cfg.lease_ttl / 4) if self.cfg.lease_ttl > 0 else 0
        )
        last_frame = time.monotonic()
        deadline = time.monotonic() + max_seconds
        try:
            while time.monotonic() < deadline:
                with self._inflight_lock:
                    inflight = self._inflight
                if (
                    self._drained.is_set()
                    and self._tasks.empty()
                    and self._results.empty()
                    and inflight == 0
                ):
                    break
                if (
                    self._tasks.qsize() < self.cfg.min_queue_length
                    and time.monotonic() >= self._shed_until
                ):
                    try:
                        _send_json(
                            self._sock,
                            self._wlock,
                            _stamp(
                                {
                                    "type": "request_tasks",
                                    "num_urls": self.cfg.batch_size,
                                }
                            ),
                        )
                        last_frame = time.monotonic()
                    except (ConnectionError, OSError):
                        break
                elif (
                    hb_interval
                    and time.monotonic() - last_frame >= hb_interval
                ):
                    # liveness while busy: a full local queue means no
                    # request frames, and slow fetches mean no result
                    # frames — without this the server's TTL reaper
                    # would reclaim leases we are actively working
                    try:
                        _send_json(
                            self._sock, self._wlock, {"type": "heartbeat"}
                        )
                        last_frame = time.monotonic()
                    except (ConnectionError, OSError):
                        break
                self.sleep(interval)
            # graceful completion handshake
            try:
                _send_json(self._sock, self._wlock, {"type": "tasks_completed"})
            except (ConnectionError, OSError):
                pass
            self.sleep(0.1)
        finally:
            self._stop.set()
            for t in threads:
                t.join(timeout=2)
            self._sock.close()
        return fetched
