"""The dedup-as-a-service front door: one RPC gateway, many tenants.

:class:`DedupGateway` serves four verbs over the length-framed RPC plane
(``net/rpc.py``) — ``submit_batch`` (check-and-add a batch of band-key
rows under the caller's doc ids, or allocate ids server-side),
``probe_batch`` (read-only attribution), ``query`` (single-doc point
lookup) and ``tenant_status`` (the ungated control surface) — plus the
offboarding verb ``wipe_tenant``.  Every gated request carries a
``tenant`` header field; the gateway resolves it through the
:class:`~advanced_scrapper_tpu_torch.service.tenancy.TenantRegistry` and
routes it to a per-tenant sibling fleet client
(``ShardedIndexClient.for_space``) over the ``tenant:<id>:bands`` key
space, so cross-tenant collisions are impossible by construction — the
namespace policy table in ``index/remote.py`` auto-provisions the space
shard-side and keeps ``wipe`` prefix-guarded.

**Quota stacking.**  Each tenant gets its own
:class:`~advanced_scrapper_tpu_torch.runtime.admission.AdmissionController`
(token bucket + concurrency cap, named ``tenant:<id>``), wired into the
transport through ``RpcServer``'s per-request ``admission_resolver`` —
NOT raised from handlers, because a handler exception is remembered
under the request id and would replay a stale refusal; the resolver path
answers an uncached, counted ``RpcOverloaded`` carrying the bucket's
retry-after, which ``RpcClient`` honors before retrying under the same
id.  The tenant gate stacks UNDER the gateway's shared controller:
a tenant over quota is stopped at its own bucket (billed to its own
``astpu_admission_pressure{gate="tenant:<id>"}`` series) without
consuming a shared slot.  Critical-priority traffic and the control
surface are never refused.

**Observability.**  The gateway owns the ``astpu_tenant_*`` series
(always-on, like every admission counter): per-tenant/verb request and
latency series, per-tenant reject counts, and a posting-count gauge fed
from budget-guarded fleet stats.  :meth:`DedupGateway.objectives` emits
the per-tenant p99 + reject-ratio objectives the SLO engine
evaluates, and the per-tenant admission pressure feeds
``runtime.autoscaler.admission_pressure()`` automatically — a noisy
tenant raises the fleet-wide pressure max and triggers scale-out (or
walks its own bucket's shed) instead of starving neighbors.

``python -m advanced_scrapper_tpu_torch.service.gateway --shard h:p,h:p …``
serves a gateway standalone (jax-free, fork-cheap, SIGTERM-clean — the
same process contract as the shard server).
"""

from __future__ import annotations

import threading
import time

import numpy as np

import advanced_scrapper_tpu_torch.net.rpc as rpc

from advanced_scrapper_tpu_torch.index.fleet import FleetSpec, ShardedIndexClient
from advanced_scrapper_tpu_torch.runtime.admission import (
    AdmissionController,
    PRIORITY_CRITICAL,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
)
from advanced_scrapper_tpu_torch.service.tenancy import (
    TenantRegistry,
    TenantSpec,
    tenant_space,
)

__all__ = ["DedupGateway", "GATED_VERBS", "serve_main"]

#: verbs that pay admission (the shared gate AND the tenant bucket);
#: ``tenant_status`` / ``wipe_tenant`` / ``__ping__`` stay ungated — an
#: overloaded front door must remain observable and offboardable.
GATED_VERBS = frozenset({"submit_batch", "probe_batch", "query"})


class _Tenant:
    """One provisioned tenant's live state: spec, bucket, fleet client."""

    __slots__ = ("spec", "ctrl", "client")

    def __init__(self, spec: TenantSpec, ctrl, client):
        self.spec = spec
        self.ctrl = ctrl
        self.client = client


class _BoundGate:
    """The per-request admission gate handed to ``RpcServer``: delegates
    to the tenant's controller and bills the refusal to the gateway's
    per-tenant reject/request series (the controller's own
    ``astpu_admission_*`` series fire too — this is the tenant-labeled
    view the SLO objectives match on)."""

    __slots__ = ("gw", "tenant", "verb")

    def __init__(self, gw: "DedupGateway", tenant: _Tenant, verb: str):
        self.gw = gw
        self.tenant = tenant
        self.verb = verb

    def admit(self, priority):
        d = self.tenant.ctrl.admit(priority)
        if not d.admitted:
            tid = self.tenant.spec.tenant
            self.gw._req_counter(tid, self.verb, "rejected").inc()
            self.gw._reject_counter(tid, d.reason or "quota").inc()
        return d

    def release(self, decision) -> None:
        self.tenant.ctrl.release(decision)


class DedupGateway:
    """The multi-tenant front door over one index fleet client."""

    def __init__(
        self,
        client: ShardedIndexClient,
        *,
        registry: TenantRegistry | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        name: str = "gateway",
        admission: AdmissionController | None = None,
        max_frame: int = rpc.DEFAULT_MAX_FRAME,
        frame_deadline: float = 30.0,
        spill_dir: str | None = None,
        status_port: int | None = None,
        stats_interval: float = 30.0,
    ):
        """``client`` is the base fleet client whose TOPOLOGY the gateway
        rides; every tenant gets a ``for_space`` sibling over it (the
        base's own space is never written through the gateway).
        ``admission`` is the optional SHARED gate stacked over every
        tenant bucket; ``spill_dir`` roots per-tenant spill journals
        (``<spill_dir>/<tenant>``; None = spill off, a dark shard sheds
        writes).  ``stats_interval`` budgets the posting-count refresh —
        fleet-wide stats fan-out never runs more than once per interval.
        """
        self._client = client
        self.registry = registry or TenantRegistry()
        self.name = name
        self.admission = admission
        self.spill_dir = spill_dir
        self.stats_interval = float(stats_interval)
        self._status_port = status_port
        self.status_server = None
        self._lock = threading.Lock()
        self._tenants: dict[str, _Tenant] = {}
        self._postings: dict[str, float] = {}
        self._postings_ts = float("-inf")
        self._stats_lock = threading.Lock()
        self._hlock = threading.Lock()
        self._m_req: dict[tuple, object] = {}
        self._m_rej: dict[tuple, object] = {}
        self._m_sec: dict[tuple, object] = {}
        self._gen = None
        self._instrument()
        self.server = rpc.RpcServer(
            {
                "submit_batch": self._h_submit_batch,
                "probe_batch": self._h_probe_batch,
                "query": self._h_query,
                "tenant_status": self._h_tenant_status,
                "wipe_tenant": self._h_wipe_tenant,
            },
            host=host,
            port=port,
            name=name,
            max_frame=max_frame,
            frame_deadline=frame_deadline,
            admission=admission,
            admission_methods=GATED_VERBS,
            admission_resolver=self._resolve_admission,
        )

    # -- instrumentation ---------------------------------------------------

    def _instrument(self) -> None:
        """(Re-)register the gateway-owned series; the admission plane's
        lazy re-instrument pattern guards every handle against a registry
        reset between tests."""
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._m_req.clear()
        self._m_rej.clear()
        self._m_sec.clear()
        self._gen = telemetry.REGISTRY.generation
        # posting counts per tenant key space, from budget-guarded fleet
        # stats (expand: one series per tenant label value)
        telemetry.REGISTRY.gauge_fn(
            "astpu_tenant_postings",
            lambda gw: gw._postings_snapshot(),
            owner=self,
            expand="tenant",
            help="per-tenant key-space posting counts (segments + WAL), "
            "refreshed at most once per stats_interval",
            always=True,
            gateway=self.name,
        )

    def _fresh(self) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        if self._gen != telemetry.REGISTRY.generation:
            with self._hlock:
                if self._gen != telemetry.REGISTRY.generation:
                    self._instrument()

    def _req_counter(self, tenant: str, verb: str, outcome: str):
        self._fresh()
        key = (tenant, verb, outcome)
        c = self._m_req.get(key)
        if c is None:
            from advanced_scrapper_tpu_torch.obs import telemetry

            c = telemetry.REGISTRY.counter(
                "astpu_tenant_requests_total",
                "front-door requests by tenant, verb and outcome "
                "(ok/error/rejected)",
                always=True,
                gateway=self.name,
                tenant=tenant,
                verb=verb,
                outcome=outcome,
            )
            self._m_req[key] = c
        return c

    def _reject_counter(self, tenant: str, reason: str):
        self._fresh()
        key = (tenant, reason)
        c = self._m_rej.get(key)
        if c is None:
            from advanced_scrapper_tpu_torch.obs import telemetry

            c = telemetry.REGISTRY.counter(
                "astpu_tenant_rejected_total",
                "tenant-quota admission refusals by reason (each answered "
                "as a retriable RpcOverloaded with retry-after)",
                always=True,
                gateway=self.name,
                tenant=tenant,
                reason=reason,
            )
            self._m_rej[key] = c
        return c

    def _seconds(self, tenant: str, verb: str):
        self._fresh()
        key = (tenant, verb)
        h = self._m_sec.get(key)
        if h is None:
            from advanced_scrapper_tpu_torch.obs import telemetry

            h = telemetry.REGISTRY.histogram(
                "astpu_tenant_seconds",
                "front-door verb wall clock by tenant (the per-tenant p99 "
                "SLO objective evaluates this series)",
                always=True,
                gateway=self.name,
                tenant=tenant,
                verb=verb,
            )
            self._m_sec[key] = h
        return h

    # -- tenancy -----------------------------------------------------------

    def _ensure(self, tenant: str) -> _Tenant:
        """Resolve (provisioning on first sight when the registry allows)
        one tenant's live state."""
        t = self._tenants.get(tenant)
        if t is not None:
            return t
        spec = self.registry.get(tenant)  # KeyError = unknown/refused
        with self._lock:
            t = self._tenants.get(tenant)
            if t is None:
                ctrl = AdmissionController(
                    rate=spec.rate,
                    burst=spec.burst,
                    max_inflight=spec.max_inflight,
                    name=f"tenant:{tenant}",
                )
                spill = None
                if self.spill_dir:
                    import os

                    spill = os.path.join(self.spill_dir, tenant)
                client = self._client.for_space(
                    tenant_space(tenant), spill_dir=spill
                )
                t = _Tenant(spec, ctrl, client)
                self._tenants[tenant] = t
        return t

    def _tenant_of(self, header: dict) -> _Tenant:
        tid = header.get("tenant")
        if not isinstance(tid, str):
            raise ValueError("request carries no tenant id")
        try:
            return self._ensure(tid)
        except KeyError as e:
            raise ValueError(str(e)) from None

    def _resolve_admission(self, method: str, header: dict):
        """``RpcServer``'s per-request hook: gated verbs resolve to the
        request tenant's own bucket (stacked under the shared gate).
        Malformed/unknown tenants resolve to no gate — the handler
        answers the clean, deterministic error instead of a retriable
        overload."""
        if method not in GATED_VERBS:
            return None
        tid = header.get("tenant")
        if not isinstance(tid, str):
            return None
        try:
            t = self._ensure(tid)
        except (KeyError, ValueError):
            return None
        try:
            prio = int(header.get("priority", PRIORITY_NORMAL))
        except (TypeError, ValueError):
            prio = PRIORITY_NORMAL
        prio = max(PRIORITY_CRITICAL, min(PRIORITY_LOW, prio))
        return _BoundGate(self, t, method), prio

    # -- verbs -------------------------------------------------------------

    def _timed(self, verb: str, header: dict, fn):
        """Shared verb wrapper: resolve tenant, time, count outcome."""
        t = self._tenant_of(header)
        tid = t.spec.tenant
        t0 = time.perf_counter()
        try:
            out = fn(t, header)
            self._req_counter(tid, verb, "ok").inc()
            return out
        except Exception:
            self._req_counter(tid, verb, "error").inc()
            raise
        finally:
            self._seconds(tid, verb).observe(time.perf_counter() - t0)

    def _h_submit_batch(self, header, arrays):
        """Check-and-add one batch of band-key rows for the tenant.
        Arrays: ``[keys (n, bands) u64, ids (n,) u64]`` — or just
        ``[keys]`` with ``allocate: true`` to draw ids from the tenant
        space's durable allocator (returned alongside the attributions).
        Per-row attributions (−1 = first sight) come back as ``int64``;
        verdicts are counted (and, when enabled, journaled with the
        tenant id) through the decision-provenance plane."""

        def run(t: _Tenant, header):
            if len(arrays) == 1 and header.get("allocate"):
                keys = np.ascontiguousarray(arrays[0], np.uint64)
                if keys.ndim != 2:
                    raise ValueError("submit_batch keys must be 2-D")
                ids = t.client.allocate_doc_ids(keys.shape[0])
                allocated = True
            elif len(arrays) == 2:
                keys = np.ascontiguousarray(arrays[0], np.uint64)
                if keys.ndim != 2:
                    raise ValueError("submit_batch keys must be 2-D")
                ids = np.ascontiguousarray(arrays[1], np.uint64).ravel()
                allocated = False
            else:
                raise ValueError(
                    "submit_batch wants [keys, ids] or [keys] + allocate"
                )
            if ids.shape[0] != keys.shape[0]:
                raise ValueError("submit_batch ids/keys length mismatch")
            attr = np.asarray(t.client.check_and_add_batch(keys, ids), np.int64)
            self._record_decisions(t.spec.tenant, ids, attr)
            resp = {"n": int(keys.shape[0]), "allocated": allocated}
            out = [attr]
            if allocated:
                out.append(np.asarray(ids, np.uint64))
            return resp, out

        return self._timed("submit_batch", header, run)

    def _h_probe_batch(self, header, arrays):
        """Read-only attribution of one batch of band-key rows against
        the tenant's space ONLY — a probe under tenant A is structurally
        unable to touch tenant B's postings."""

        def run(t: _Tenant, header):
            (keys,) = arrays
            keys = np.ascontiguousarray(keys, np.uint64)
            if keys.ndim != 2:
                raise ValueError("probe_batch keys must be 2-D")
            attr = t.client.probe_batch(keys)
            return {"n": int(keys.shape[0])}, [np.asarray(attr, np.int64)]

        return self._timed("probe_batch", header, run)

    def _h_query(self, header, arrays):
        """Single-doc point lookup: one row of band keys → the attributed
        doc id (−1 = absent)."""

        def run(t: _Tenant, header):
            (keys,) = arrays
            keys = np.ascontiguousarray(keys, np.uint64).ravel()
            attr = t.client.probe_batch(keys.reshape(1, -1))
            return {"doc": int(np.asarray(attr).ravel()[0])}

        return self._timed("query", header, run)

    def _h_tenant_status(self, header, arrays):
        """The ungated control surface: per-tenant quota/pressure/
        posting-count snapshot (one tenant via the header, or every
        provisioned tenant).  Forces a posting-count refresh inside the
        stats budget."""
        self._refresh_postings()
        tid = header.get("tenant")
        if isinstance(tid, str):
            self._ensure(tid)
        out = {}
        with self._lock:
            items = list(self._tenants.items())
        for name, t in sorted(items):
            if isinstance(tid, str) and name != tid:
                continue
            out[name] = {
                "space": tenant_space(name),
                "rate": t.spec.rate,
                "burst": t.ctrl.burst,
                "max_inflight": t.spec.max_inflight,
                "inflight": t.ctrl.inflight(),
                "pressure": t.ctrl.pressure(),
                "p99_slo_s": t.spec.p99_slo_s,
                "reject_budget": t.spec.reject_budget,
                "postings": self._postings.get(name),
            }
        return {"tenants": out, "declared": list(self.registry.declared())}

    def _h_wipe_tenant(self, header, arrays):
        """Offboarding: drop every posting of the tenant's key space
        fleet-wide (the namespace policy allows wipe under ``tenant:``;
        real spaces stay refused server-side)."""
        t = self._tenant_of(header)
        dropped = t.client.wipe()
        with self._stats_lock:
            self._postings.pop(t.spec.tenant, None)
        return {"dropped": int(dropped)}

    # -- decision provenance ----------------------------------------------

    def _record_decisions(self, tenant: str, ids, attr) -> None:
        """Bill gateway-settled verdicts to the decision plane: the
        fleet's probe→resolve→insert path settles on index evidence, so
        the tier is ``index``; journal rows carry the tenant id (the
        zero-leakage tests join on it)."""
        from advanced_scrapper_tpu_torch.obs import decisions

        rec = decisions.get_recorder()
        a = np.asarray(attr, np.int64)
        dup = int((a >= 0).sum())
        rec.count("index", "dup", dup)
        rec.count("index", "unique", int(a.size - dup))
        if rec.journal is not None and a.size:
            ids = np.asarray(ids, np.uint64)
            rec.journal_rows(
                [
                    {
                        "tier": "index",
                        "verdict": "dup" if int(att) >= 0 else "unique",
                        "doc": int(doc),
                        "attr": int(att),
                        "tenant": tenant,
                    }
                    for doc, att in zip(ids.tolist(), a.tolist())
                ]
            )

    # -- posting counts ----------------------------------------------------

    def _postings_snapshot(self) -> dict[str, float]:
        """The gauge_fn target: last-known per-tenant posting counts.
        Scrapes never block on fleet RPCs — a refresh happens at most
        once per ``stats_interval`` and only when the budget lock is
        free."""
        self._refresh_postings(blocking=False)
        with self._stats_lock:
            return dict(self._postings)

    def _refresh_postings(self, *, blocking: bool = True) -> None:
        now = time.monotonic()
        if now - self._postings_ts < self.stats_interval:
            return
        if not self._stats_lock.acquire(blocking=blocking):
            return
        try:
            if now - self._postings_ts < self.stats_interval:
                return
            self._postings_ts = now
            with self._lock:
                items = list(self._tenants.items())
            for tid, t in items:
                space = tenant_space(tid)
                total = 0
                for st in t.client.stats()["shards"]:
                    sp = (st or {}).get("spaces", {}).get(space)
                    if sp:
                        total += int(sp.get("segment_postings", 0))
                        total += int(sp.get("wal_postings", 0))
                self._postings[tid] = float(total)
        finally:
            self._stats_lock.release()

    # -- SLO + autoscaler feeds -------------------------------------------

    def objectives(self) -> list[dict]:
        """Per-tenant SLO objectives for ``obs/slo.py`` (plain dicts —
        ``SloEngine`` loads them declaratively): a p99 latency ceiling
        over ``astpu_tenant_seconds{tenant=…}`` and a reject-ratio cap of
        ``astpu_tenant_rejected_total`` / ``astpu_tenant_requests_total``,
        each with the tenant's declared error budget."""
        objs = []
        with self._lock:
            items = sorted(self._tenants.items())
        for tid, t in items:
            objs.append(
                {
                    "name": f"tenant_{tid}_p99",
                    "kind": "p99_latency_max",
                    "metric": "astpu_tenant_seconds",
                    "labels": {"tenant": tid},
                    "threshold": t.spec.p99_slo_s,
                    "budget": t.spec.slo_budget,
                }
            )
            objs.append(
                {
                    "name": f"tenant_{tid}_rejects",
                    "kind": "ratio_max",
                    "metric": "astpu_tenant_rejected_total",
                    "denominator": "astpu_tenant_requests_total",
                    "labels": {"tenant": tid},
                    "threshold": t.spec.reject_budget,
                    "budget": t.spec.slo_budget,
                }
            )
        return objs

    def pressure(self) -> float:
        """The gateway's aggregate pressure signal: the max over every
        tenant bucket (each also exports
        ``astpu_admission_pressure{gate="tenant:<id>"}``, which
        ``runtime.autoscaler.admission_pressure()`` folds in fleet-wide
        — this accessor is for direct ``Autoscaler.observe`` wiring)."""
        with self._lock:
            tenants = list(self._tenants.values())
        pressures = [t.ctrl.pressure() for t in tenants]
        if self.admission is not None:
            pressures.append(self.admission.pressure())
        return max(pressures, default=0.0)

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> "DedupGateway":
        from advanced_scrapper_tpu_torch.obs import telemetry

        self.server.start()
        if self._status_port is not None or telemetry.enabled():
            self.status_server = telemetry.StatusServer(
                port=self._status_port or 0,
                name=f"gateway-{self.name}",
                extra_status=lambda: {
                    "gateway": self.name,
                    "tenants": self._h_tenant_status({}, [])["tenants"],
                },
            ).start()
        return self

    def stop(self) -> None:
        """Idempotent.  Per-tenant sibling clients are the gateway's own
        and get closed; the BASE client belongs to the caller."""
        self.server.stop()
        if self.status_server is not None:
            self.status_server.stop()
            self.status_server = None
        with self._lock:
            tenants, self._tenants = dict(self._tenants), {}
        for t in tenants.values():
            t.client.close()


def serve_main(argv=None) -> int:
    """Standalone gateway entry
    (``python -m advanced_scrapper_tpu_torch.service.gateway``).

    ``--shard`` declares one fleet shard per flag as comma-separated
    ``host:port`` replicas; the bound gateway port lands in
    ``--port-file`` ATOMICALLY after listen (the shard-server contract,
    so a parent forking the whole stack waits on files, never races the
    bind).  SIGTERM closes cleanly.
    """
    import argparse
    import signal

    ap = argparse.ArgumentParser(description=serve_main.__doc__)
    ap.add_argument(
        "--shard",
        action="append",
        required=True,
        help="one fleet shard: comma-separated host:port replicas "
        "(repeat per shard)",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", default=None)
    ap.add_argument("--name", default="gateway")
    ap.add_argument(
        "--tenant",
        action="append",
        default=[],
        help="declare one tenant: name[,rate=R][,burst=B][,inflight=N]"
        "[,p99=S][,rejects=F] (repeat per tenant)",
    )
    ap.add_argument(
        "--no-auto-tenants",
        action="store_true",
        help="refuse tenants not declared via --tenant (closed deployment)",
    )
    ap.add_argument(
        "--default-rate", type=float, default=0.0,
        help="token-bucket rate for auto-provisioned tenants (0 = uncapped)",
    )
    ap.add_argument(
        "--default-inflight", type=int, default=16,
        help="concurrency cap for auto-provisioned tenants (0 = uncapped)",
    )
    ap.add_argument(
        "--rate", type=float, default=0.0,
        help="SHARED token-bucket rate over all tenants (0 = none)",
    )
    ap.add_argument(
        "--max-inflight", type=int, default=0,
        help="SHARED concurrency cap over all tenants (0 = none)",
    )
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--retries", type=int, default=3)
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument(
        "--stats-interval", type=float, default=30.0,
        help="minimum seconds between fleet stats fan-outs for the "
        "per-tenant posting-count gauge",
    )
    ap.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve GET /metrics + /status beside the RPC socket "
        "(0 = ephemeral; omit = only under ASTPU_TELEMETRY)",
    )
    ap.add_argument("--metrics-port-file", default=None)
    args = ap.parse_args(argv)

    if args.metrics_port_file is not None and args.metrics_port is None:
        args.metrics_port = 0

    shards = []
    for spec in args.shard:
        nodes = []
        for hp in spec.split(","):
            host, _, port = hp.strip().rpartition(":")
            nodes.append((host, int(port)))
        shards.append(tuple(nodes))
    client = ShardedIndexClient(
        FleetSpec(shards=tuple(shards)),
        space="bands",
        timeout=args.timeout,
        retries=args.retries,
    )
    registry = TenantRegistry(
        [TenantSpec.parse(t) for t in args.tenant],
        default=TenantSpec(
            tenant="default",
            rate=args.default_rate,
            max_inflight=args.default_inflight,
        ),
        auto_provision=not args.no_auto_tenants,
    )
    admission = None
    if args.rate > 0 or args.max_inflight > 0:
        admission = AdmissionController(
            rate=args.rate,
            max_inflight=args.max_inflight,
            name=args.name,
        )
    gw = DedupGateway(
        client,
        registry=registry,
        host=args.host,
        port=args.port,
        name=args.name,
        admission=admission,
        spill_dir=args.spill_dir,
        status_port=args.metrics_port,
        stats_interval=args.stats_interval,
    ).start()
    if args.port_file:
        from advanced_scrapper_tpu_torch.storage.fsio import atomic_replace

        atomic_replace(args.port_file, str(gw.port).encode())
    if args.metrics_port_file and gw.status_server is not None:
        from advanced_scrapper_tpu_torch.storage.fsio import atomic_replace

        atomic_replace(
            args.metrics_port_file, str(gw.status_server.port).encode()
        )

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    signal.signal(signal.SIGINT, lambda *_a: stop.set())

    # standalone deployments get their SLO verdicts from the gateway
    # process itself: re-load objectives whenever a tenant is provisioned
    # (auto-provision grows the set mid-flight) and evaluate on a slow
    # cadence so /status carries astpu_slo_* for every tenant objective
    slo_engine = None
    n_objectives = -1
    next_eval = 0.0
    try:
        while not stop.is_set():
            time.sleep(0.1)
            if gw.status_server is None:
                continue
            now = time.monotonic()
            if now < next_eval:
                continue
            next_eval = now + 5.0
            objectives = gw.objectives()
            if len(objectives) != n_objectives:
                from advanced_scrapper_tpu_torch.obs.slo import SloEngine

                slo_engine = SloEngine(objectives)
                n_objectives = len(objectives)
            if slo_engine is not None:
                slo_engine.evaluate()
    finally:
        gw.stop()
        client.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(serve_main())
