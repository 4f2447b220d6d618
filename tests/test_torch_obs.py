"""The port's obs core (``advanced_scrapper_tpu_torch/obs``: telemetry,
trace, stages, devprof, profiler) against the JAX package's, on the CPU.

For one sequence of metric operations the two registries render the same
Prometheus text and JSON snapshot, byte for byte, with two things left
out: process metrics (``register_process_metrics``, whose values are the
process's own) and timestamps (the snapshot's ``ts`` and the exemplars'
``ts``).  Histogram buckets and quantiles, the no-op handles while
telemetry is off, callback gauges freed with their owner, the flight
recorder's ring and dump, ``stages`` windows, ``dispatch_span`` in both
modes, the stack sampler and the device trace are checked one by one.

The instrumented layers — the engine, the stream backend, the persistent
index, the torn-tail repair, the stage graph and the dispatcher — expose
the JAX package's series names and label keys for the same workload, and
equal values where the work is the same; launch and put counts follow
the port's own launches (one fold a chunk, ``last_chunks``).

Every test starts and ends with both registries reset and their gates
re-read from the environment, and stops every sampler it starts, so the
file passes in any order and beside any other file in a worker."""

from __future__ import annotations

import gc
import json
import os
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.extractors import tpu_batch as ref_tb
from advanced_scrapper_tpu.index import PersistentIndex as RefIndex
from advanced_scrapper_tpu.obs import stages as ref_stages
from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu.obs import trace as ref_trace
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu.runtime import StageGraph as RefGraph
from advanced_scrapper_tpu.storage import csvio as ref_csvio
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.extractors import tpu_batch
from advanced_scrapper_tpu_torch.index import PersistentIndex
from advanced_scrapper_tpu_torch.obs import devprof, profiler, stages, telemetry, trace
from advanced_scrapper_tpu_torch.ops import _build
from advanced_scrapper_tpu_torch.pipeline import dedup, dispatch
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from advanced_scrapper_tpu_torch.runtime import StageGraph, snapshot_all
from advanced_scrapper_tpu_torch.storage import csvio
from test_torch_hashing import adversarial_corpus
from test_torch_stream import run_stream, stream_records

REGISTRIES = (ref_telemetry.REGISTRY, telemetry.REGISTRY)
#: the reference's series the port does not emit on the CPU: the XLA
#: compile sentinel, whose series the port feeds from kernel builds (none
#: on the CPU)
REF_ONLY = {"astpu_jit_compiles_total", "astpu_jit_compile_seconds"}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this module's torch work: the suite runs
    several test processes at once, and each one's thread pool, spinning
    at its barriers, would take the cores the others need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_registries():
    for reg in REGISTRIES:
        reg.set_enabled(None)
        reg.reset()
    yield
    for reg in REGISTRIES:
        reg.set_enabled(None)
        reg.reset()


@pytest.fixture
def telemetry_on():
    for reg in REGISTRIES:
        reg.set_enabled(True)
    yield


def _operate(mod, reg):
    """One sequence of metric operations on ``reg`` (a registry of
    ``mod``)."""
    c = reg.counter("astpu_t_events_total", "events seen", kind="a")
    c.inc()
    c.inc(2.5)
    reg.counter("astpu_t_events_total", "events seen", kind="b").inc(7)
    g = reg.gauge("astpu_t_depth", "queue depth")
    g.set(3)
    g.inc(4)
    g.dec(0.5)
    h = reg.histogram("astpu_t_latency_seconds", "latency", stage="x")
    for v in (0.0, 1e-7, 2.0 ** -20, 3e-6, 0.001, 0.001, 0.25, 0.5, 1.0, 3.0, 70.0, 1e3):
        h.observe(v)
    h.observe(5e3, trace="tr-1")  # a new top bucket: the exemplar
    reg.histogram("astpu_t_empty_seconds", "never observed")
    reg.gauge_fn("astpu_t_cb", lambda: 12.5, help="a callback")

    class Owner:
        depths = {"q1": 3, "q0": 1}

    owner = Owner()
    reg.gauge_fn("astpu_t_fan", lambda o: o.depths, owner=owner, expand="queue",
                 help="fanned out", pool="p")
    reg.counter("astpu_t_unhelped_total").inc()
    return owner


def _no_ts(text: str) -> str:
    return re.sub(r"ts=\S+", "ts=*", text)


def _status_no_ts(status: dict) -> dict:
    status = dict(status)
    status.pop("ts")
    for m in status["metrics"]:
        if "exemplar" in m:
            m["exemplar"] = {k: v for k, v in m["exemplar"].items() if k != "ts"}
    return status


def test_registry_renders_like_the_reference():
    out = []
    for mod in (ref_telemetry, telemetry):
        reg = mod.Registry(enabled=True)
        owner = _operate(mod, reg)
        out.append((_no_ts(reg.prometheus_text()), json.dumps(_status_no_ts(reg.status()))))
        del owner
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    assert "# exemplar astpu_t_latency_seconds" in out[1][0]
    assert 'astpu_t_fan{pool="p",queue="q0"} 1' in out[1][0]


def test_histogram_buckets_and_quantiles():
    values = [0.0, 2.0 ** -21, 2.0 ** -20, 2.0 ** -19, 1.5e-6, 0.003, 0.5, 1.0, 1.0000001,
              63.9, 64.0, 64.1, 1e4]
    for v in values:
        assert telemetry.Histogram._bucket_index(v) == ref_telemetry.Histogram._bucket_index(v)
    assert telemetry.BUCKET_BOUNDS == ref_telemetry.BUCKET_BOUNDS
    rng = np.random.RandomState(3)
    samples = np.exp(rng.uniform(np.log(1e-6), np.log(100.0), size=500)).tolist()
    hs = [mod.Histogram("h", {}) for mod in (ref_telemetry, telemetry)]
    for h in hs:
        for v in samples:
            h.observe(v)
    ref, port = hs
    assert port.state() == ref.state()
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert port.percentile(q) == ref.percentile(q)
    assert port.percentiles_ms() == ref.percentiles_ms()
    assert telemetry.Histogram("e", {}).percentile(0.5) == 0.0


def test_noop_singletons_while_disabled(monkeypatch):
    reg = telemetry.Registry(enabled=False)
    assert reg.counter("a") is telemetry.NOOP
    assert reg.gauge("b") is telemetry.NOOP
    assert reg.histogram("c") is telemetry.NOOP
    telemetry.NOOP.inc()
    telemetry.NOOP.observe(1.0, trace="t")
    assert telemetry.NOOP.value == 0.0 and telemetry.NOOP.exemplar is None
    reg.gauge_fn("d", lambda: 1.0)
    assert reg.counter("e", always=True) is not telemetry.NOOP  # event counters stay
    assert reg.prometheus_text() == "# TYPE e counter\ne 0\n"
    monkeypatch.setenv("ASTPU_TELEMETRY", "1")
    reg.set_enabled(None)
    assert reg.enabled() and reg.counter("a") is not telemetry.NOOP
    monkeypatch.setenv("ASTPU_TELEMETRY", "0")
    telemetry.REGISTRY.set_enabled(None)
    assert telemetry.counter("astpu_x_total") is telemetry.NOOP


def test_callback_gauges_freed_with_their_owner():
    texts = []
    for mod in (ref_telemetry, telemetry):
        reg = mod.Registry(enabled=True)

        class Owner:
            size = 5

        owner = Owner()
        reg.gauge_fn("astpu_t_size", lambda o: o.size, owner=owner, help="size")
        assert "astpu_t_size 5" in reg.prometheus_text()
        del owner
        gc.collect()
        texts.append(reg.prometheus_text())
        assert reg._callbacks == {}
    assert texts[0] == texts[1] == "\n"


def _strip(ev: dict) -> dict:
    return {k: v for k, v in ev.items() if k not in ("ts", "dur_ms", "span", "parent", "pid")}


def test_flight_recorder_ring_and_dump(tmp_path):
    dumps = []
    for name, mod in (("jax", ref_trace), ("port", trace)):
        rec = mod.FlightRecorder(capacity=4)
        rec.set_active(True)
        for i in range(3):
            rec.record("event", "tick", i=i)
        with rec.span("outer", trace="t1", docs=2):
            with rec.span("inner"):
                pass
        with pytest.raises(ValueError):
            with rec.span("failing", trace="t1"):
                raise ValueError("boom")
        snap = rec.snapshot()
        assert len(snap) == 4  # the ring keeps the newest
        assert [e["name"] for e in snap] == ["tick", "inner", "outer", "failing"]
        assert snap[1]["parent"] == snap[2]["span"] and snap[1]["trace"] == "t1"
        path = rec.dump(str(tmp_path / f"{name}.jsonl"), reason="test")
        lines = [json.loads(x) for x in open(path, encoding="utf-8")]
        assert lines[0]["kind"] == "dump" and lines[0]["events"] == 4
        dumps.append([_strip(x) for x in lines])
    assert dumps[0] == dumps[1]
    assert dumps[1][-1]["error"] == "ValueError: boom"
    off = trace.FlightRecorder()
    off.set_active(False)
    off.record("event", "x")
    assert off.snapshot() == [] and off.dump() is None


def test_fault_dump_lands_the_graph_snapshots(tmp_path):
    """The runtime's fault hook puts every live graph's snapshot in the
    ring before the dump; a second fault in one death dumps nothing."""
    rec = trace.RECORDER
    rec.clear()
    rec.set_active(True)
    g = StageGraph("obs.fault")
    g.edge("out", 4)
    g.start()
    try:
        path = str(tmp_path / "fault.jsonl")
        rec.set_dump_path(path)
        assert rec.dump_on_fault("injected") == path
        assert rec.dump_on_fault("again") is None
        lines = [json.loads(x) for x in open(path, encoding="utf-8")]
        names = [(x["kind"], x["name"]) for x in lines]
        assert ("fault", "crash") in names and ("snapshot", "graphs") in names
        graphs = [x for x in lines if x["name"] == "graph"]
        assert any(x["graph"] == "obs.fault" for x in graphs)
        assert any(s["graph"] == "obs.fault" for s in snapshot_all())
    finally:
        g.stop()
        g.join(timeout=5)
        rec.set_dump_path(None)
        rec.set_active(None)
        rec.clear()


def test_stage_windows_equal_reference():
    got = []
    for mod in (ref_stages, stages):
        mod.add("encode", 0.5)
        mod.reset()
        with mod.timed("kernel"):
            pass
        mod.add("encode", 0.25)
        mod.add("h2d", 0.125)
        snap = mod.snapshot_ms()
        assert snap.pop("kernel") < 50
        got.append(snap)
        mod.count_device_put(100, "dedup")
        mod.count_dispatch("dedup", 2)
        got.append((mod.device_counters(), mod.regime_device_counters("dedup")))
    assert got[0] == got[2] == {"encode": 250.0, "h2d": 125.0}
    assert got[1] == got[3]
    # the per-shard half, once a raise naming the mesh slice: the same
    # per-shard totals and put skew in both packages
    views = []
    for mod in (ref_stages, stages):
        base = mod.sharded_device_counters()
        for s, puts in ((0, 3), (1, 3), (2, 1)):
            for _ in range(puts):
                mod.count_device_put(64, "sharded", shard=s)
            mod.count_dispatch("sharded", 2, shard=s)
        after = mod.sharded_device_counters()
        views.append(({s: {k: v - base.get(s, {}).get(k, 0.0) for k, v in d.items()}
                       for s, d in after.items()}, mod.record_sharded_put_skew(base)))
    assert views[0] == views[1]
    assert views[1][0]["0"] == {"device_puts": 3.0, "device_dispatches": 2.0, "h2d_bytes": 192.0}
    assert views[1][1] == 2.0


@pytest.mark.parametrize("mode", ["async", "fenced"])
def test_dispatch_span_modes_on_the_cpu(monkeypatch, mode):
    if mode == "fenced":
        monkeypatch.setenv("ASTPU_DISPATCH_TIMING", "fenced")
    else:
        monkeypatch.delenv("ASTPU_DISPATCH_TIMING", raising=False)
    for _ in range(3):
        with devprof.dispatch_span("dedup_fold_segments", rows=4, width=8, trace="t") as sp:
            sp.out = torch.zeros(4)
    with pytest.raises(RuntimeError):
        with devprof.dispatch_span("dedup_fold_segments", rows=4, width=8):
            raise RuntimeError("a failed launch is not observed")
    (h,) = telemetry.REGISTRY.find(devprof.DISPATCH_HISTOGRAM)
    assert h.labels == {"kernel": "dedup_fold_segments", "shape": "4x8"} and h.count == 3
    (g,) = telemetry.REGISTRY.find("astpu_dispatch_timing_fenced")
    assert g.value == (1.0 if mode == "fenced" else 0.0)
    assert devprof.resolve_timing_mode() == mode


def _spin_target(seconds: float) -> int:
    end = time.perf_counter() + seconds
    n = 0
    while time.perf_counter() < end:
        n += 1
    return n


def test_stack_sampler_folds_a_named_function():
    s = profiler.StackSampler(hz=200)
    worker = threading.Thread(target=_spin_target, args=(0.4,), name="obs-spin")
    try:
        s.start()
        worker.start()
        worker.join()
    finally:
        s.stop()
    assert not s.running and s.samples > 0
    folded = s.folded()
    assert any(line.split(" ")[0].endswith("test_torch_obs:_spin_target")
               for line in folded.splitlines())
    assert s.profile_text().startswith("# astpu-profile hz=200 ")
    assert 0.0 <= s.overhead_ratio() < 1.0
    (samples,) = telemetry.REGISTRY.find("astpu_prof_samples_total")
    assert samples.value == s.samples
    assert profiler.profile_response_text().startswith("# astpu-profile disabled")
    del s
    gc.collect()


def test_status_server_serves_metrics_status_and_profile():
    telemetry.REGISTRY.counter("astpu_t_served_total", "served", always=True).inc(3)
    srv = telemetry.StatusServer(port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        status = json.loads(urllib.request.urlopen(base + "/status", timeout=10).read())
        prof = urllib.request.urlopen(base + "/profile", timeout=10).read().decode()
    finally:
        srv.stop()
    assert "astpu_t_served_total 3" in text and "astpu_process_threads" in text
    assert any(m["name"] == "astpu_t_served_total" for m in status["metrics"])
    assert prof.startswith("# astpu-profile disabled")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiler.device_trace(None) as prof:
        assert prof is None
    with profiler.device_trace(str(tmp_path)) as prof:
        torch.ones(64).add_(1)
    (path,) = list(tmp_path.iterdir())
    assert path.name.startswith(f"trace-{os.getpid()}-")
    assert "aten::add_" in path.read_text()


def test_kernel_build_sentinel_counts_first_loads(monkeypatch):
    """The first load of a CUDA library in a process counts one build on
    the reference's sentinel series; a loaded library counts none."""
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda name: "")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    _build.load("oph")
    _build.load("oph")
    _build.load("minhash")
    assert devprof.jit_compiles_by_kernel() == {"oph": 1.0, "minhash": 1.0}
    assert devprof.jit_compiles_total() == 2.0
    assert devprof.compile_seconds_count()[0] == 2


# -- the instrumented layers against the reference --------------------------------


def _series(reg) -> dict:
    out: dict = {}
    for e in reg.status()["metrics"]:
        out.setdefault(e["name"], set()).add(tuple(sorted(e["labels"])))
    return out


def _values(reg, prefix: str) -> dict:
    out = {}
    for e in reg.status()["metrics"]:
        if e["name"].startswith(prefix):
            key = (e["name"], tuple(sorted(e["labels"].items())))
            out[key] = e.get("value", e.get("count"))
    return out


def _counter(reg, name: str, **labels) -> float:
    return sum(c.value for c in reg.find(name)
               if all(c.labels.get(k) == v for k, v in labels.items()))


@pytest.mark.parametrize(
    "overrides",
    [dict(rerank=False, exact_verify_band=0.72), dict(), dict(backend="oph", rerank=False)],
    ids=["certified", "default", "oph"],
)
def test_engine_series_equal_reference(telemetry_on, monkeypatch, overrides):
    monkeypatch.setattr(dedup, "CHUNK_BYTES", 8192)  # several chunks: the dispatcher runs
    corpus = adversarial_corpus(np.random.RandomState(11), 64)
    ref = RefEngine(RefConfig(**overrides))
    eng = NearDupEngine(DedupConfig(**overrides), device="cpu")
    assert np.array_equal(eng.dedup_reps(corpus), ref.dedup_reps(corpus))
    first = eng.last_chunks
    eng.dedup_reps_async(corpus)
    ref.dedup_reps_async(corpus)
    # the port keeps its last dispatcher (and with it the graph's edges and
    # their scrape-time gauges) for its stage times; the reference drops it
    eng.last_dispatcher = None
    gc.collect()
    want, got = _series(ref_telemetry.REGISTRY), _series(telemetry.REGISTRY)
    assert set(got) <= set(want) and set(want) - set(got) <= REF_ONLY
    assert {k: v for k, v in want.items() if k not in REF_ONLY} == got
    assert _values(telemetry.REGISTRY, "astpu_dedup_") .keys() == _values(
        ref_telemetry.REGISTRY, "astpu_dedup_").keys()
    for name in ("astpu_dedup_docs_total", "astpu_dedup_dups_total", "astpu_dedup_ratio",
                 "astpu_dedup_candidate_pairs_total", "astpu_dedup_borderline_edges_total",
                 "astpu_dedup_exact_checks_total"):
        want_v = _values(ref_telemetry.REGISTRY, name)
        assert _values(telemetry.REGISTRY, name) == want_v, name
    # the port's own launch ledger: one fold a chunk, one densify a corpus
    # under OPH, one put a chunk plus the corpus's valid mask (and with the
    # tier the rewritten candidate matrix)
    chunks = first + eng.last_chunks
    assert first > 1 and eng.last_chunks == first
    oph = overrides.get("backend") == "oph"
    assert _counter(telemetry.REGISTRY, "astpu_device_dispatches_total",
                    regime="dedup") == chunks + (2 if oph else 0)
    hooked = overrides.get("rerank", True)
    assert _counter(telemetry.REGISTRY, "astpu_device_puts_total",
                    regime="dedup") == chunks + 2 + (2 if hooked else 0)
    assert _counter(telemetry.REGISTRY, "astpu_dedup_batches_total") == chunks
    (lag,) = telemetry.REGISTRY.find(devprof.QUEUE_LAG_HISTOGRAM)
    assert lag.count == chunks
    folds = telemetry.REGISTRY.find(devprof.DISPATCH_HISTOGRAM)  # a series a chunk shape
    assert {h.labels["kernel"] for h in folds} == {"dedup_fold_segments"}
    assert sum(h.count for h in folds) == chunks
    assert eng.step_summary()["steps"] == chunks
    if hooked:
        assert _counter(telemetry.REGISTRY, "astpu_device_dispatches_total",
                        regime="rerank") == 2
        assert any(h.labels["stage"] == "rerank_settle" for h in telemetry.stage_histograms())


def test_engine_spans_and_probe(monkeypatch):
    monkeypatch.setattr(dedup, "CHUNK_BYTES", 8192)
    rec = trace.RECORDER
    rec.clear()
    rec.set_active(True)
    try:
        eng = NearDupEngine(DedupConfig(rerank=False), device="cpu")
        seen = []
        eng.dispatch_probe = seen.append
        eng.dedup_reps(adversarial_corpus(np.random.RandomState(2), 32))
        names = [e["name"] for e in rec.snapshot()]
    finally:
        rec.set_active(None)
        rec.clear()
    assert {"dedup.candidates", "dedup.resolve", "dedup.dispatch"} <= set(names)
    assert len(seen) == eng.last_chunks and seen[0]["tile"] == 0
    assert set(seen[0]) == {"tile", "rows", "width", "h2d_bytes", "put_ms", "dispatch_ms"}


def test_stream_backend_series_equal_reference(telemetry_on, tmp_path):
    records = stream_records(29, n=192)
    over = dict(batch_size=64)
    ref = ref_tb.TpuBatchBackend(RefConfig(**over))
    port = tpu_batch.TpuBatchBackend(DedupConfig(**over), device="cpu")
    assert run_stream(port, records) == run_stream(ref, records)
    want, got = _series(ref_telemetry.REGISTRY), _series(telemetry.REGISTRY)
    assert {k: v for k, v in got.items() if k.startswith("astpu_stream_")} == {
        k: v for k, v in want.items() if k.startswith("astpu_stream_")}

    def stream_values(reg):
        return {k[0]: v for k, v in _values(reg, "astpu_stream_").items()}

    assert stream_values(telemetry.REGISTRY) == stream_values(ref_telemetry.REGISTRY)
    assert stream_values(telemetry.REGISTRY)["astpu_stream_kept"] > 0
    for name, b in (("jax", ref), ("port", port)):
        path = str(tmp_path / f"{name}.npz")
        port.save_index(path)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        assert b.load_index_if_valid(path) is False
    for reg in REGISTRIES:
        assert _counter(reg, "astpu_quarantine_total", kind="stream_index") == 1


def test_index_series_equal_reference(telemetry_on, tmp_path):
    got, indexes = [], []  # both stay referenced: their gauges live with them
    for name, make in (("jax", RefIndex), ("port", PersistentIndex)):
        idx = make(str(tmp_path / name), cut_postings=16, compact_segments=3,
                   compact_inline=True)
        indexes.append(idx)
        rng = np.random.RandomState(5)
        for _ in range(7):
            keys = rng.randint(0, 1 << 60, size=16).astype(np.uint64)
            idx.insert_batch(keys, np.repeat(idx.allocate_doc_ids(4), 4))
            idx.probe_batch(keys[:5])
        idx.scrub()
        rotted = idx._segments[-1].path
        with open(rotted, "r+b") as fh:
            fh.seek(os.path.getsize(rotted) - 1)
            b = fh.read(1)[0]
            fh.seek(os.path.getsize(rotted) - 1)
            fh.write(bytes([b ^ 2]))
        idx.scrub()
        idx.close()
    for reg in REGISTRIES:
        vals = {}
        for (n, labels), v in _values(reg, "astpu_").items():
            if n.startswith(("astpu_index_", "astpu_scrub_", "astpu_quarantine")):
                labels = tuple((k, v2) for k, v2 in labels if k != "index")
                vals[(n, labels)] = vals.get((n, labels), 0) + v
        got.append(vals)
    assert got[0] == got[1]
    assert got[1][("astpu_index_segment_cuts_total", ())] == 7
    assert got[1][("astpu_quarantine_total", (("kind", "segment"),))] == 1
    assert _series(telemetry.REGISTRY)["astpu_index_segments"] == {("index",)}


def test_torn_csv_tail_quarantine_equal_reference(tmp_path):
    rec = trace.RECORDER
    rec.clear()
    rec.set_active(True)
    try:
        for name, mod in (("jax", ref_csvio), ("port", csvio)):
            path = tmp_path / f"{name}.csv"
            path.write_bytes(b"url,title\nhttps://a,one\nhttps://b,tw")
            assert mod.repair_torn_tail(str(path)) == len(b"https://b,tw")
        events = [e for e in rec.snapshot() if e["name"] == "quarantine.csv_torn_tail"]
    finally:
        rec.set_active(None)
        rec.clear()
    for reg in REGISTRIES:
        assert _counter(reg, "astpu_quarantine_total", kind="csv_torn_tail") == 1
        assert _counter(reg, "astpu_quarantine_bytes_total", kind="csv_torn_tail") == 12
    assert events and events[0]["bytes"] == 12


def test_stage_graph_series_equal_reference(telemetry_on):
    out, graphs = [], []  # the graphs stay referenced: their gauges live with them
    for make in (RefGraph, StageGraph):
        g = make("obs.t")
        graphs.append(g)
        mid, done = g.edge("mid", 2), g.edge("done")
        g.stage("gen", source_iter=iter(range(10)), out_edge=mid)
        g.stage("double", fn=lambda x: 2 * x, in_edge=mid, out_edge=done)
        g.start()
        assert sum(done) == 90
        g.join(timeout=10)
    for reg in REGISTRIES:
        vals = {}
        for (n, labels), v in _values(reg, "astpu_").items():
            if n.endswith("_seconds_total"):
                continue  # wall time
            vals[(n, tuple(kv for kv in labels if kv[0] != "g"))] = v
        out.append(vals)
    assert out[0] == out[1]
    assert out[1][("astpu_stage_items_total", (("graph", "obs.t"), ("stage", "double")))] == 10


def test_dispatcher_watchdog_counts_and_dumps(tmp_path, monkeypatch):
    rec = trace.RECORDER
    rec.clear()
    rec.set_active(True)
    path = str(tmp_path / "watchdog.jsonl")
    rec.set_dump_path(path)
    release = threading.Event()

    def hung_put(item):
        if item == 2:
            release.wait(10)
        return item

    pipe = dispatch.PipelinedDispatcher(range(5), pack=lambda x: x, put=hung_put,
                                        watchdog_s=0.2)
    try:
        with pytest.raises(dispatch.DispatchTimeout):
            list(pipe)
    finally:
        release.set()
        pipe.close()
        rec.set_dump_path(None)
        rec.set_active(None)
        rec.clear()
    assert pipe.watchdog_trips == 1
    assert _counter(telemetry.REGISTRY, "astpu_dispatch_watchdog_trips_total") == 1
    lines = [json.loads(x) for x in open(path, encoding="utf-8")]
    assert lines[0]["reason"].startswith("dispatch watchdog")
    assert any(x["name"] == "dispatch.watchdog" for x in lines)


def test_oom_backoff_counts_halvings_and_injections(monkeypatch):
    monkeypatch.setenv("ASTPU_CHAOS_DISPATCH_OOM", "3")
    dispatch.reset_chaos_oom()
    try:
        out = dispatch.dispatch_with_oom_backoff(
            lambda acc, item: acc + sum(item), 0, list(range(16)),
            split=lambda item: [item[: len(item) // 2], item[len(item) // 2:]],
            rows_of=len, floor=1,
        )
    finally:
        monkeypatch.delenv("ASTPU_CHAOS_DISPATCH_OOM")
        dispatch.reset_chaos_oom()
    assert out == sum(range(16))
    assert _counter(telemetry.REGISTRY, "astpu_dispatch_oom_backoff_total", plane="dedup") == 3
    assert _counter(telemetry.REGISTRY, "astpu_fault_injected_total", kind="oom") == 3


# -- the matcher's series, spans and probe --------------------------------------


@pytest.fixture
def matcher_indexes():
    from advanced_scrapper_tpu.pipeline import matcher as ref_matcher
    from advanced_scrapper_tpu_torch.pipeline import matcher
    from test_match_dispatch import _entities

    ents = _entities(12)
    return (ref_matcher.EntityIndex(ref_matcher.process_json_data(ents)),
            matcher.EntityIndex(matcher.process_json_data(ents)))


@pytest.mark.parametrize("packed", [True, False], ids=["one_buffer", "legacy"])
@pytest.mark.parametrize("frame", ["chunk", "overlong"])
def test_matcher_series_equal_reference(telemetry_on, matcher_indexes, packed, frame):
    """``match_chunk`` emits the reference's ``astpu_matcher_*`` values
    (articles, matches, overlong), its stage timers and spans, one dispatch
    a launch, and one probe record a screen launch."""
    from advanced_scrapper_tpu.pipeline import matcher as ref_matcher
    from advanced_scrapper_tpu_torch.pipeline import matcher
    from test_match_dispatch import _chunk, _norm, _overlong_frame

    ref_ix, ix = matcher_indexes
    df, kw = _chunk(150, seed=11, pad_every=13), dict(use_refine=True)
    if frame == "overlong":
        df, kw = _overlong_frame(), dict(screen_block=4096, use_refine=True)
    probe = []
    ix.dispatch_probe = probe.append
    rec = trace.RECORDER
    rec.clear()
    rec.set_active(True)
    try:
        before = stages.regime_device_counters("matcher")
        got = matcher.match_chunk(df, ix, device="cpu", packed=packed, **kw)
        after = stages.regime_device_counters("matcher")
        names = {e["name"] for e in rec.snapshot()}
    finally:
        rec.set_active(None)
        rec.clear()
        ix.dispatch_probe = None
    want = ref_matcher.match_chunk(df, ref_ix, packed=packed, **kw)
    assert _norm(got) == _norm(want)
    values = {k: v for k, v in _values(telemetry.REGISTRY, "astpu_matcher_").items()}
    assert values == _values(ref_telemetry.REGISTRY, "astpu_matcher_")
    assert values[("astpu_matcher_articles_total", ())] == len(df)
    assert (("astpu_matcher_overlong_total", ()) in values) == (frame == "overlong")
    assert {"matcher.screen", "matcher.verify"} <= names
    stage_names = {h.labels["stage"] for h in telemetry.REGISTRY.find("astpu_stage_seconds")}
    assert {"matcher_build", "matcher_screen", "h2d", "matcher_verify"} <= stage_names
    overlong = values.get(("astpu_matcher_overlong_total", ()), 0)
    screens = 1 if packed else -(-len(df) // 128)  # every batch here has a short row
    assert len(probe) == screens and [p["tile"] for p in probe] == list(range(screens))
    assert set(probe[0]) == {"tile", "rows", "width", "h2d_bytes", "put_ms", "dispatch_ms"}
    assert sum(p["rows"] for p in probe) == len(df) - overlong
    spans = {h.labels["kernel"] for h in telemetry.REGISTRY.find(devprof.DISPATCH_HISTOGRAM)}
    launches = after["device_dispatches"] - before["device_dispatches"]
    if packed:
        assert spans == {"matcher_screen_chunk", "matcher_bound_chunk"} and launches == 2
        assert after["device_puts"] - before["device_puts"] == 1
    else:
        assert "matcher_screen_legacy" in spans and launches >= screens


def test_run_matcher_series_equal_reference(telemetry_on, tmp_path):
    from advanced_scrapper_tpu.config import MatchConfig as RefMatchConfig
    from advanced_scrapper_tpu.pipeline import matcher as ref_matcher
    from advanced_scrapper_tpu_torch.config import MatchConfig
    from advanced_scrapper_tpu_torch.pipeline import matcher
    from test_match_dispatch import _entities
    from test_torch_matcher import adversarial_csv

    info = tmp_path / "info"
    info.mkdir()
    (info / "a.json").write_text(json.dumps(_entities(6)))
    adversarial_csv(str(tmp_path / "articles.csv"), np.random.RandomState(5))
    for name, cfg_cls, mod, kw in (("ref", RefMatchConfig, ref_matcher, {}),
                                   ("port", MatchConfig, matcher, {"device": "cpu"})):
        cfg = cfg_cls(source_name=str(tmp_path / name), info_dir=str(info), chunk_size=16,
                      verify_workers=1)
        assert mod.run_matcher(cfg, articles_csv=str(tmp_path / "articles.csv"),
                               use_refine=True, **kw) == 0
    got = _values(telemetry.REGISTRY, "astpu_matcher_")
    assert got == _values(ref_telemetry.REGISTRY, "astpu_matcher_")
    assert got[("astpu_matcher_matches_total", ())] > 0
