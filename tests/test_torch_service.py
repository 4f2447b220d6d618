"""The port's multi-tenant gateway (``service/``) against the JAX package's.

Every case of the reference's ``tests/test_service.py`` runs against the
port: the namespace policies, tenant declarations, the zero-leakage
acceptance over a live 2×2 fleet (attributions equal a tenant-free oracle,
a tenant's probes never touch another's postings, journal rows billed to
their tenant, offboarding), retriable quota refusals, the SLO objectives
and the pressure feed.  Then one request script through the JAX gateway
over JAX shard servers and through the port's over the port's gives the
same replies, ``tenant_status``, ``astpu_tenant_*`` series (Prometheus
text; the latency histogram by its counts) and decision-journal lines; a
JAX ``RpcClient`` is served by the port's gateway; and ``python -m
advanced_scrapper_tpu_torch.service.gateway`` writes its port file, loads
no torch and stops cleanly on SIGTERM."""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

from advanced_scrapper_tpu.index import fleet as ref_fleet
from advanced_scrapper_tpu.index import remote as ref_remote
from advanced_scrapper_tpu.net import rpc as ref_rpc
from advanced_scrapper_tpu.obs import decisions as ref_decisions
from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu import service as ref_service
from advanced_scrapper_tpu_torch import service
from advanced_scrapper_tpu_torch.index import fleet, remote
from advanced_scrapper_tpu_torch.index.remote import (
    CANARY_SPACE_PREFIX,
    NAMESPACE_POLICIES,
    TENANT_SPACE_PREFIX,
    namespace_policy,
)
from advanced_scrapper_tpu_torch.net import rpc
from advanced_scrapper_tpu_torch.net.rpc import RpcClient, RpcOverloaded, RpcRemoteError
from advanced_scrapper_tpu_torch.obs import decisions, telemetry
from advanced_scrapper_tpu_torch.obs.decisions import DecisionJournal
from advanced_scrapper_tpu_torch.runtime.admission import PRIORITY_CRITICAL
from advanced_scrapper_tpu_torch.service import (
    GATED_VERBS,
    DedupGateway,
    TenantRegistry,
    TenantSpec,
    tenant_space,
)
from test_torch_fleet import stop_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = 8
PKG = {
    "port": dict(remote=remote, fleet=fleet, rpc=rpc, service=service, telemetry=telemetry,
                 decisions=decisions),
    "jax": dict(remote=ref_remote, fleet=ref_fleet, rpc=ref_rpc, service=ref_service,
                telemetry=ref_telemetry, decisions=ref_decisions),
}


@pytest.fixture
def fresh_registry():
    for p in PKG.values():
        p["telemetry"].REGISTRY.reset()
        p["telemetry"].set_enabled(True)
    yield telemetry.REGISTRY
    for p in PKG.values():
        p["telemetry"].REGISTRY.reset()
        p["telemetry"].set_enabled(None)
        p["decisions"].set_recorder(None)


def counter(name, **labels):
    for m in telemetry.REGISTRY.find(name):
        if all(m.labels.get(k) == str(v) for k, v in labels.items()):
            return m.value
    return 0.0


def make_fleet(tmp_path, shards=2, replicas=2, pkg="port", **client_kw):
    servers, parts = [], []
    for s in range(shards):
        nodes = []
        for r in range(replicas):
            srv = PKG[pkg]["remote"].IndexShardServer(
                str(tmp_path / f"s{s}n{r}"), spaces=("bands", "urls"), cut_postings=6 * BANDS,
                compact_segments=4, compact_inline=True, name=f"s{s}n{r}").start()
            servers.append(srv)
            nodes.append(f"127.0.0.1:{srv.port}")
        parts.append("|".join(nodes))
    kw = dict(space="bands", timeout=2.0, retries=1, health_timeout=0.2)
    kw.update(client_kw)
    return servers, PKG[pkg]["fleet"].ShardedIndexClient(";".join(parts), **kw)


def corpus(tenant: str, n: int, bands: int = BANDS) -> np.ndarray:
    """Planted-dup band keys: doc ``i`` with ``i % 7 == 3`` repeats doc
    ``i-3``'s row; a crc32 salt per tenant keeps tenants key-disjoint."""
    salt = zlib.crc32(tenant.encode()) & 0xFFFFFFFF
    rows = np.empty((n, bands), np.uint64)
    lanes = np.arange(bands, dtype=np.uint64)
    for i in range(n):
        src = i - 3 if (i % 7 == 3 and i >= 3) else i
        v = (lanes + np.uint64(src * 4096) + np.uint64(salt * 7 + 29)) \
            * np.uint64(0x9E3779B97F4A7C15)
        rows[i] = v ^ (v >> np.uint64(31))
    return rows


def expected_attr(n: int) -> np.ndarray:
    return np.asarray([i - 3 if (i % 7 == 3 and i >= 3) else -1 for i in range(n)], np.int64)


def space_postings(servers, space: str) -> int:
    total = 0
    for srv in servers:
        idx = srv.indexes.get(space)
        if idx is not None:
            st = idx.stats()
            total += int(st["segment_postings"]) + int(st["wal_postings"])
    return total


# -- namespaces and tenant declarations ----------------------------------------------------


def test_namespace_policy_classes():
    canary = namespace_policy(CANARY_SPACE_PREFIX + "probe")
    assert canary.quota_class == "canary" and canary.auto_provision and canary.wipe_allowed
    tenant = namespace_policy(tenant_space("acme"))
    assert tenant.quota_class == "tenant" and tenant.auto_provision and tenant.wipe_allowed
    for real in ("bands", "urls", ""):
        pol = namespace_policy(real)
        assert pol.quota_class == "system"
        assert not pol.auto_provision and not pol.wipe_allowed


def test_namespace_policy_longest_prefix_and_frozen():
    assert namespace_policy(TENANT_SPACE_PREFIX).quota_class == "tenant"
    assert namespace_policy("tenant").quota_class == "system"
    assert namespace_policy("canary").quota_class == "system"
    with pytest.raises(dataclasses.FrozenInstanceError):
        NAMESPACE_POLICIES[0].wipe_allowed = True  # type: ignore[misc]


def test_tenant_space_shape_and_charset():
    assert tenant_space("acme") == "tenant:acme:bands"
    assert tenant_space("acme", "urls") == "tenant:acme:urls"
    for bad in ("", "a:b", "-lead", "x" * 65, "sp ace"):
        with pytest.raises(ValueError):
            tenant_space(bad)
        with pytest.raises(ValueError):
            ref_service.tenant_space(bad)
    assert namespace_policy(tenant_space("a.b-c_9")).quota_class == "tenant"
    assert service.TENANT_ID_RE.pattern == ref_service.TENANT_ID_RE.pattern


def test_tenant_spec_parse_roundtrip():
    text = "acme,rate=500,burst=50,inflight=8,p99=0.25,rejects=0.1,budget=0.02"
    spec = TenantSpec.parse(text)
    assert spec == TenantSpec(tenant="acme", rate=500.0, burst=50.0, max_inflight=8,
                              p99_slo_s=0.25, reject_budget=0.1, slo_budget=0.02)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_service.TenantSpec.parse(text))
    assert TenantSpec.parse("solo").tenant == "solo"
    for bad in ("", "acme,nope=1", "acme,rate", "a:b"):
        with pytest.raises(ValueError):
            TenantSpec.parse(bad)


def test_tenant_registry_open_vs_closed():
    open_reg = TenantRegistry(default=TenantSpec(tenant="default", rate=9.0))
    stamped = open_reg.get("newco")
    assert stamped.tenant == "newco" and stamped.rate == 9.0
    assert open_reg.get("newco") is stamped
    assert "newco" in open_reg.known() and "newco" not in open_reg.declared()
    closed = TenantRegistry(specs=[TenantSpec(tenant="acme")], auto_provision=False)
    assert closed.declared() == ("acme",) and closed.get("acme").tenant == "acme"
    for stranger in ("stranger", "bad:id"):
        with pytest.raises(KeyError):
            closed.get(stranger)


def test_gated_verbs_cover_the_data_plane():
    assert GATED_VERBS == ref_service.GATED_VERBS == {"submit_batch", "probe_batch", "query"}


# -- the zero-leakage acceptance (live 2×2 fleet) ----------------------------------------


def test_gateway_zero_cross_tenant_leakage(tmp_path, fresh_registry):
    servers, client = make_fleet(tmp_path)
    decisions.configure(str(tmp_path / "journal.jsonl"), sample=1.0)
    gw = rc = None
    try:
        gw = DedupGateway(client, registry=TenantRegistry(), name="leaktest",
                          stats_interval=0.0).start()
        rc = RpcClient(("127.0.0.1", gw.port), timeout=5.0)
        n = 35
        corpora = {t: corpus(t, n) for t in ("alpha", "beta")}
        got: dict[str, list[np.ndarray]] = {"alpha": [], "beta": []}
        for lo in range(0, n, 7):
            for t in ("alpha", "beta"):
                ids = np.arange(lo, lo + 7, dtype=np.uint64)
                resp, arrays = rc.call("submit_batch", {"tenant": t},
                                       [corpora[t][lo:lo + 7], ids])
                assert resp["n"] == 7 and not resp["allocated"]
                got[t].append(np.asarray(arrays[0], np.int64))
        expected = expected_attr(n)
        for t in ("alpha", "beta"):
            assert np.array_equal(np.concatenate(got[t]), expected), t
        oracle = client.for_space(CANARY_SPACE_PREFIX + "oracle")
        try:
            oracle_attr = [np.asarray(oracle.check_and_add_batch(
                corpora["alpha"][lo:lo + 7], np.arange(lo, lo + 7, dtype=np.uint64)), np.int64)
                for lo in range(0, n, 7)]
            assert np.concatenate(oracle_attr).tobytes() == np.concatenate(got["alpha"]).tobytes()
        finally:
            oracle.wipe()
            oracle.close()
        beta_before = space_postings(servers, tenant_space("beta"))
        assert beta_before > 0
        _resp, arrays = rc.call("probe_batch", {"tenant": "alpha"}, [corpora["beta"]])
        assert (np.asarray(arrays[0]) == -1).all(), "beta's keys must be invisible under alpha"
        assert space_postings(servers, tenant_space("beta")) == beta_before
        _resp, arrays = rc.call("probe_batch", {"tenant": "alpha"}, [corpora["alpha"]])
        probe = np.asarray(arrays[0], np.int64)
        dup_rows = expected >= 0
        assert np.array_equal(probe[dup_rows], expected[dup_rows])
        assert (probe[~dup_rows] == np.arange(n, dtype=np.int64)[~dup_rows]).all()
        assert rc.call("query", {"tenant": "beta"}, [corpora["beta"][3]])[0]["doc"] == 0
        rows = DecisionJournal.read(str(tmp_path / "journal.jsonl"))
        by_tenant: dict[str, list[dict]] = {}
        for r in rows:
            if r.get("tier") == "index" and "tenant" in r:
                by_tenant.setdefault(r["tenant"], []).append(r)
        assert set(by_tenant) == {"alpha", "beta"}
        for t in ("alpha", "beta"):
            assert len(by_tenant[t]) == n
            assert sorted(r["doc"] for r in by_tenant[t]) == list(range(n))
            attrs = {r["doc"]: r["attr"] for r in by_tenant[t]}
            assert all(attrs[i] == int(expected[i]) for i in range(n))
        status = rc.call("tenant_status", {})[0]
        assert set(status["tenants"]) >= {"alpha", "beta"}
        for t in ("alpha", "beta"):
            st = status["tenants"][t]
            assert st["space"] == tenant_space(t) and st["postings"] and st["postings"] > 0
        dropped = rc.call("wipe_tenant", {"tenant": "alpha"})[0]["dropped"]
        assert dropped > 0
        assert space_postings(servers, tenant_space("alpha")) == 0
        assert space_postings(servers, tenant_space("beta")) == beta_before
        _resp, arrays = rc.call("probe_batch", {"tenant": "alpha"}, [corpora["alpha"]])
        assert (np.asarray(arrays[0]) == -1).all()
    finally:
        decisions.set_recorder(None)
        if rc is not None:
            rc.close()
        if gw is not None:
            gw.stop()
        client.close()
        stop_all(servers)


# -- quotas ----------------------------------------------------------------------------------


def test_quota_refusal_is_retriable_never_wrong(tmp_path, fresh_registry):
    servers, client = make_fleet(tmp_path, shards=1, replicas=1)
    gw = rc = None
    try:
        gw = DedupGateway(client, registry=TenantRegistry(
            specs=[TenantSpec(tenant="capped", rate=15.0, burst=2.0, max_inflight=2)],
            auto_provision=False), name="quotatest", stats_interval=0.0).start()
        rc = RpcClient(("127.0.0.1", gw.port), timeout=5.0)
        keys = corpus("capped", 40)
        for lo in range(0, 40, 2):
            resp, _arrays = rc.call("submit_batch", {"tenant": "capped"},
                                    [keys[lo:lo + 2], np.arange(lo, lo + 2, dtype=np.uint64)])
            assert resp["n"] == 2
        attr = np.asarray(rc.call("probe_batch", {"tenant": "capped"}, [keys])[1][0], np.int64)
        dup_rows = expected_attr(40) >= 0
        assert np.array_equal(attr[dup_rows], expected_attr(40)[dup_rows])
        rejected = counter("astpu_tenant_rejected_total", tenant="capped", reason="rate")
        assert rejected > 0, "the loop must have overrun the bucket"
        rejected_by_verb = sum(
            m.value for m in telemetry.REGISTRY.find("astpu_tenant_requests_total")
            if m.labels.get("tenant") == "capped" and m.labels.get("outcome") == "rejected")
        assert rejected_by_verb == rejected
        assert counter("astpu_rpc_client_overloaded_total") > 0
        assert counter("astpu_rpc_overload_backoff_seconds_total") > 0
        strict = RpcClient(("127.0.0.1", gw.port), timeout=5.0, retries=0)
        try:
            refused = False
            for i in range(200):
                try:
                    strict.call("query", {"tenant": "capped"}, [keys[i % 40]])
                except RpcOverloaded as e:
                    refused = True
                    assert e.retry_after and e.retry_after > 0
                    break
            assert refused, "a tight no-retry loop must hit the bucket"
            resp = strict.call("query", {"tenant": "capped", "priority": PRIORITY_CRITICAL},
                               [keys[3]])[0]
            assert resp["doc"] == 0
        finally:
            strict.close()
        with pytest.raises(RpcRemoteError, match="stranger"):
            rc.call("query", {"tenant": "stranger"}, [keys[0]])
    finally:
        if rc is not None:
            rc.close()
        if gw is not None:
            gw.stop()
        client.close()
        stop_all(servers)


def test_gateway_objectives_and_pressure(fresh_registry, tmp_path):
    from advanced_scrapper_tpu_torch.obs.slo import SloEngine

    servers, client = make_fleet(tmp_path, shards=1, replicas=1)
    gw = None
    try:
        gw = DedupGateway(client, registry=TenantRegistry(
            specs=[TenantSpec(tenant="acme", rate=100.0, p99_slo_s=0.25, reject_budget=0.1,
                              slo_budget=0.02)], auto_provision=False), stats_interval=0.0)
        gw._ensure("acme")
        objs = {o["name"]: o for o in gw.objectives()}
        p99 = objs["tenant_acme_p99"]
        assert (p99["kind"], p99["metric"], p99["labels"]) == \
            ("p99_latency_max", "astpu_tenant_seconds", {"tenant": "acme"})
        assert p99["threshold"] == 0.25 and p99["budget"] == 0.02
        rej = objs["tenant_acme_rejects"]
        assert (rej["kind"], rej["denominator"], rej["threshold"]) == \
            ("ratio_max", "astpu_tenant_requests_total", 0.1)
        SloEngine(gw.objectives()).evaluate()
        assert gw._tenants["acme"].ctrl.name == "tenant:acme" and gw.pressure() >= 0.0
        assert any(name == "astpu_admission_pressure" and labels.get("gate") == "tenant:acme"
                   for name, labels, _v in SloEngine.registry_samples())
    finally:
        if gw is not None:
            gw.stop()
        client.close()
        stop_all(servers)


# -- one request script through both packages ------------------------------------------


def tenant_series(tel) -> list[str]:
    """The ``astpu_tenant_*`` lines of the Prometheus text, the latency
    histogram by its counts only (its buckets and sum are wall clock)."""
    out = []
    for line in tel.REGISTRY.prometheus_text().splitlines():
        if "astpu_tenant_" not in line:
            continue
        if line.startswith("astpu_tenant_seconds_") and not line.startswith(
                "astpu_tenant_seconds_count"):
            continue
        out.append(line)
    return sorted(out)


def gateway_script(pkg: str, tmp_path) -> dict:
    """Three tenants over one gateway: ``open`` and ``quiet`` provisioned on
    first sight, ``acme`` declared; caller ids and ``allocate``, probes,
    point queries, a malformed request, an unknown tenant, status, a wipe
    and the probes after it; every reply, status, series and journal row."""
    p = PKG[pkg]
    servers, client = make_fleet(tmp_path / pkg, pkg=pkg)
    p["decisions"].configure(str(tmp_path / f"{pkg}.jsonl"), sample=1.0)
    reg = p["service"].TenantRegistry(
        specs=[p["service"].TenantSpec(tenant="acme", rate=0.0, p99_slo_s=0.5)],
        default=p["service"].TenantSpec(tenant="default", max_inflight=4))
    gw = p["service"].DedupGateway(client, registry=reg, name="parity",
                                   stats_interval=0.0).start()
    rc = p["rpc"].RpcClient(("127.0.0.1", gw.port), timeout=5.0, retries=0)
    replies = []

    def call(method, header, arrays=()):
        try:
            resp, out = rc.call(method, header, list(arrays))
            resp = {k: v for k, v in resp.items() if k != "id"}  # the client's request id
            replies.append((method, resp, [np.asarray(a).tolist() for a in out]))
        except p["rpc"].RpcError as e:
            replies.append((method, type(e).__name__, str(e)))

    try:
        n = 28
        data = {t: corpus(t, n) for t in ("acme", "open", "quiet")}
        for lo in range(0, n, 7):
            call("submit_batch", {"tenant": "acme"},
                 [data["acme"][lo:lo + 7], np.arange(lo, lo + 7, dtype=np.uint64)])
            call("submit_batch", {"tenant": "open", "allocate": True}, [data["open"][lo:lo + 7]])
        call("submit_batch", {"tenant": "quiet", "allocate": True}, [data["quiet"][:5]])
        for t in ("acme", "open", "quiet"):
            call("probe_batch", {"tenant": t}, [data["acme"]])
            call("query", {"tenant": t}, [data[t][3]])
        call("submit_batch", {"tenant": "acme"}, [data["acme"][:2]])  # no ids, no allocate
        call("probe_batch", {"tenant": "bad:id"}, [data["acme"][:1]])
        call("query", {}, [data["acme"][0]])
        call("tenant_status", {})
        call("tenant_status", {"tenant": "open"})
        call("wipe_tenant", {"tenant": "open"})
        call("probe_batch", {"tenant": "open"}, [data["open"]])
        call("tenant_status", {})
        status = gw._h_tenant_status({}, [])
        objectives = gw.objectives()
        series = tenant_series(p["telemetry"])
    finally:
        rc.close()
        gw.stop()
        client.close()
        stop_all(servers)
        p["decisions"].set_recorder(None)
    journal = [{k: v for k, v in r.items() if k != "ts"}
               for r in p["decisions"].DecisionJournal.read(str(tmp_path / f"{pkg}.jsonl"))]
    return dict(replies=replies, status=status, objectives=objectives, series=series,
                journal=journal)


def test_request_script_equals_the_jax_gateway(tmp_path, fresh_registry):
    port, ref = gateway_script("port", tmp_path), gateway_script("jax", tmp_path)
    for key in ("replies", "status", "objectives", "series", "journal"):
        assert port[key] == ref[key], key
    assert any("allocated" in str(r[1]) for r in port["replies"])
    assert any(r[1] == "RpcRemoteError" for r in port["replies"])
    assert any(line.startswith("astpu_tenant_requests_total") for line in port["series"])
    assert len(port["journal"]) == 28 * 2 + 5


def test_jax_client_is_served_by_the_port_gateway(tmp_path, fresh_registry):
    servers, client = make_fleet(tmp_path)
    gw = DedupGateway(client, name="mixed", stats_interval=0.0).start()
    rc = ref_rpc.RpcClient(("127.0.0.1", gw.port), timeout=5.0)
    try:
        keys = corpus("mixed", 21)
        resp, arrays = rc.call("submit_batch", {"tenant": "mixed", "allocate": True}, [keys])
        assert (resp["ok"], resp["n"], resp["allocated"]) == (True, 21, True)
        attr, ids = (np.asarray(a) for a in arrays)
        assert (ids == np.arange(21)).all() and np.array_equal(attr, expected_attr(21))
        probe = np.asarray(rc.call("probe_batch", {"tenant": "mixed"}, [keys])[1][0])
        assert (probe[expected_attr(21) < 0] == np.flatnonzero(expected_attr(21) < 0)).all()
        with pytest.raises(ref_rpc.RpcRemoteError, match="tenant"):
            rc.call("query", {}, [keys[0]])
    finally:
        rc.close()
        gw.stop()
        client.close()
        stop_all(servers)


def test_serve_main_port_file_and_clean_sigterm(tmp_path):
    """``python -m advanced_scrapper_tpu_torch.service.gateway``: the port
    file appears once the socket listens, a JAX client is served through a
    declared tenant, the process maps no torch library, and SIGTERM stops
    it with status 0."""
    shard = remote.IndexShardServer(str(tmp_path / "shard"), name="solo").start()
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "advanced_scrapper_tpu_torch.service.gateway",
         "--shard", f"127.0.0.1:{shard.port}", "--port-file", str(port_file),
         "--tenant", "acme,rate=1000", "--no-auto-tenants", "--timeout", "2"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 30
        while not port_file.exists() and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.05)
        port = int(port_file.read_text())
        rc = ref_rpc.RpcClient(("127.0.0.1", port), timeout=5.0)
        try:
            keys = corpus("acme", 14)
            resp, arrays = rc.call("submit_batch", {"tenant": "acme", "allocate": True}, [keys])
            assert resp["n"] == 14 and np.array_equal(np.asarray(arrays[0]), expected_attr(14))
            status = rc.call("tenant_status", {})[0]
            assert status["declared"] == ["acme"] and status["tenants"]["acme"]["postings"] > 0
            with pytest.raises(ref_rpc.RpcRemoteError, match="stranger"):
                rc.call("query", {"tenant": "stranger"}, [keys[0]])
        finally:
            rc.close()
        assert shard.indexes[tenant_space("acme")].posting_count() == 14 * BANDS - 2 * BANDS
        maps = open(f"/proc/{proc.pid}/maps").read()
        assert "libtorch" not in maps and "libc10" not in maps
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc_gw = proc.wait(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()
            stop_all([shard])
    assert rc_gw == 0, proc.stderr.read()
    with socket.socket() as s:  # the port is free again
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
    assert json.loads(json.dumps(status))["tenants"]["acme"]["space"] == "tenant:acme:bands"
