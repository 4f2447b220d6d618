"""The port's fleet collector (``obs/collector.py``) against the JAX
package's.

``parse_endpoint_list`` on a seeded sweep of specs; both collectors over
the same stub endpoints, which serve fixed Prometheus text and folded
profiles, give the same merged ``/metrics``, ``/status`` and ``/profile``
apart from the scrape times; and discovery from an obs dir, staleness
after a node stops and the crash-sidecar harvest on a small live fleet of
the port's shard servers."""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from advanced_scrapper_tpu.obs import collector as ref_collector
from advanced_scrapper_tpu_torch.index.fleet import ShardedIndexClient
from advanced_scrapper_tpu_torch.index.remote import IndexShardServer
from advanced_scrapper_tpu_torch.obs import collector, slo, telemetry, trace

PKGS = {"jax": ref_collector, "port": collector}
#: the collector's own series whose value is a clock reading
CLOCKED = ("astpu_collector_scrape_age_seconds",)

METRICS = [
    """# TYPE astpu_fleet_rpc_seconds histogram
astpu_fleet_rpc_seconds_bucket{method="probe",le="0.01"} 3
astpu_fleet_rpc_seconds_bucket{method="probe",le="+Inf"} 5
astpu_fleet_rpc_seconds_sum{method="probe"} 0.25
astpu_fleet_rpc_seconds_count{method="probe"} 5
# exemplar astpu_fleet_rpc_seconds{method="probe"} trace="t-1" value=0.2 ts=1700000000.5
# TYPE astpu_docs_total counter
astpu_docs_total 12
astpu_quoted{path="a\\"b\\\\c"} 1.5
garbage line without value
astpu_big 1e20
astpu_nan NaN
""",
    """# TYPE astpu_docs_total counter
astpu_docs_total 40
# TYPE astpu_fleet_shards_healthy gauge
astpu_fleet_shards_healthy{fleet="1:bands"} 2
astpu_inf{k="v"} +Inf
""",
]
PROFILES = ["# host profile hz=97\nmain;loop;work 12\nmain;idle 3\n", ""]


class Stub:
    """An HTTP endpoint serving fixed ``/metrics`` and ``/profile``."""

    def __init__(self, metrics: str, profile: str):
        body = {"/metrics": metrics.encode(), "/profile": profile.encode()}

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                data = body.get(self.path)
                self.send_response(200 if data is not None else 404)
                self.send_header("Content-Length", str(len(data or b"")))
                self.end_headers()
                self.wfile.write(data or b"")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def stubs():
    out = [Stub(m, p) for m, p in zip(METRICS, PROFILES)]
    yield out
    for s in out:
        s.stop()


def unclocked(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith(CLOCKED)]


def get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("seed", range(6))
def test_endpoint_lists_equal_reference(seed):
    rng = np.random.RandomState(seed)
    parts = []
    for _ in range(rng.randint(0, 7)):
        host = f"h{rng.randint(9)}:{rng.randint(1, 65536)}"
        form = rng.randint(5)
        part = (host if form == 0 else f"http://{host}/" if form == 1 else
                f"n{rng.randint(9)}={host}" if form == 2 else
                f"n{rng.randint(9)}=https://{host}" if form == 3 else "  ")
        parts.append(part)
    spec = "".join(p + [",", ";", " , "][rng.randint(3)] for p in parts)
    assert collector.parse_endpoint_list(spec) == ref_collector.parse_endpoint_list(spec)


@pytest.mark.parametrize("profiles", [False, True])
def test_merged_views_equal_reference(stubs, profiles):
    """Both collectors scrape the same two stubs and one dead address:
    the same merged Prometheus text, samples, status and profile, the
    scrape times aside."""
    dead = "http://127.0.0.1:9"
    views = {}
    for pkg, mod in PKGS.items():
        fc = mod.FleetCollector([("s0", stubs[0].url), f"s1={stubs[1].url},{dead}"],
                                timeout=2.0, profiles=profiles)
        fc.scrape_once()
        fc.scrape_once()
        samples, types = fc.merged_samples()
        status = fc.status()
        for ep in status["endpoints"]:
            ep.pop("age_s")
            ep["error"] = ep["error"].split(":")[0]
        status = {k: v for k, v in status.items() if k not in ("ts", "pid", "metrics")}
        views[pkg] = (unclocked(fc.prometheus_text()),
                      [(n, l, repr(v)) for n, l, v in samples if n not in CLOCKED],
                      types, status,
                      fc.merged_profile(), fc.harvest_profiles())
    assert views["port"] == views["jax"]
    text, samples, _types, status, profile, _ = views["port"]
    assert [e["ok"] for e in status["endpoints"]] == [True, True, False]
    full = [(n, tuple(sorted(l.items()))) for n, l, _v in samples]
    assert len(full) == len(set(full))
    assert 'astpu_docs_total{instance="s0"} 12' in text and "# exemplar" in "\n".join(text)
    if profiles:  # else no round pulled a profile
        assert profile.splitlines()[1:] == ["s0;main;loop;work 12", "s0;main;idle 3"]
    else:
        assert profile == "\n"


def test_serve_and_stop_equal_reference(stubs):
    """``serve`` answers ``/metrics``, ``/status``, ``/profile`` and a 404
    the same way; ``stop`` closes the port."""
    views = {}
    for pkg, mod in PKGS.items():
        fc = mod.FleetCollector([("s0", stubs[0].url)], profiles=True)
        fc.serve(interval=3600.0)
        base = f"http://{fc.host}:{fc.port}"
        try:
            code_m, metrics = get(base + "/metrics")
            code_s, status = get(base + "/status")
            code_p, profile = get(base + "/profile")
            code_x, missing = get(base + "/nope")
        finally:
            fc.stop()
        with pytest.raises(OSError):
            urllib.request.urlopen(base + "/metrics", timeout=2)
        status = json.loads(status)
        views[pkg] = (code_m, unclocked(metrics), code_s, status["dead_shards"],
                      [e["name"] for e in status["endpoints"]], code_p, profile, code_x, missing)
    assert views["port"] == views["jax"]
    assert views["port"][0] == views["port"][2] == 200 and views["port"][7] == 404


@pytest.fixture()
def live_telemetry(tmp_path, monkeypatch):
    monkeypatch.setenv("ASTPU_OBS_DIR", str(tmp_path / "obs"))
    telemetry.REGISTRY.reset()
    telemetry.set_enabled(True)
    trace.set_enabled(True)
    trace.RECORDER.clear()
    yield tmp_path
    trace.RECORDER.clear()
    trace.RECORDER.set_dump_path(None)
    telemetry.REGISTRY.reset()
    telemetry.set_enabled(None)
    trace.set_enabled(None)


def test_live_fleet_discovery_staleness_and_sidecar(live_telemetry):
    """A 2 × 2 fleet of the port's shard servers under ``ASTPU_OBS_DIR``
    and this process's client: both collectors discover the 4 shard
    endpoints and merge them without a collision; after shard 1's primary
    stops and the client fails over, ``endpoint_up`` reads 0 for it, the
    ``astpu_fleet_shards_healthy`` objective over the merged samples
    fails, and the client's flight-recorder dump names shard 1."""
    tmp = live_telemetry
    servers, parts = [], []
    for s in range(2):
        nodes = []
        for r in range(2):
            srv = IndexShardServer(str(tmp / f"s{s}n{r}"), spaces=("bands",), cut_postings=96,
                                   compact_inline=True, name=f"s{s}n{r}").start()
            servers.append(srv)
            nodes.append(f"127.0.0.1:{srv.port}")
        parts.append("|".join(nodes))
    client = ShardedIndexClient(";".join(parts), space="bands", spill_dir=str(tmp / "spill"),
                                timeout=2.0, retries=1, health_timeout=0.2)
    own = telemetry.StatusServer(name="client").start()
    # the servers share this process's flight recorder: their shard.serve
    # events go, so the dump below holds what the client saw
    trace.RECORDER.clear()
    fcs = {pkg: mod.FleetCollector(obs_dir=str(tmp / "obs"), sidecar_dir=str(tmp / "side"),
                                   timeout=1.0) for pkg, mod in PKGS.items()}
    engine = slo.SloEngine([{"name": "shards_healthy", "kind": "gauge_min",
                             "metric": "astpu_fleet_shards_healthy", "threshold": 2,
                             "agg": "min"}], export=False)
    try:
        keys = np.random.default_rng(3).integers(0, 500, size=(16, 8)).astype(np.uint64)
        client.check_and_add_batch(keys, client.allocate_doc_ids(16))
        names = ["client"] + [f"shard-s{s}n{r}" for s in range(2) for r in range(2)]
        for fc in fcs.values():
            assert fc.discover() == 5 and fc.discover() == 0
            fc.scrape_once()
            samples, _ = fc.merged_samples()
            assert {l.get("instance") for n, l, _v in samples
                    if not n.startswith("astpu_collector_")} == set(names)
            full = [(n, tuple(sorted(l.items()))) for n, l, _v in samples]
            assert len(full) == len(set(full))
        assert engine.evaluate(fcs["port"].merged_samples()[0])["ok"]
        servers[2].stop()  # s1n0: shard 1's write target
        client.probe_batch(keys)  # the read fails over; shard 1 waits for a write
        os.makedirs(tmp / "side")
        trace.RECORDER.dump(str(tmp / "side" / "client.flight.jsonl"), reason="s1n0 stopped")
        views = {}
        for pkg, fc in fcs.items():
            assert all(fc.scrape_once()[n] for n in names if n != "shard-s1n0")
            samples, _ = fc.merged_samples()
            up = {l["instance"]: v for n, l, v in samples if n == "astpu_collector_endpoint_up"}
            views[pkg] = (up, fc.dead_shards(), [
                {k: v for k, v in h.items() if k != "path"} for h in fc.harvest_sidecars()])
        assert views["port"] == views["jax"]
        up, dead, harvested = views["port"]
        assert up["shard-s1n0"] == 0.0 and sum(up.values()) == 4.0
        assert dead == ["1"] and harvested[0]["dumps"] == 1
        verdict = engine.evaluate(fcs["port"].merged_samples()[0])
        assert not verdict["ok"] and verdict["objectives"][0]["value"] == 1.0
    finally:
        own.stop()
        client.close()
        for s in servers:
            s.stop()
