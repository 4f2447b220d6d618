"""The port's SLO engine (``obs/slo.py``) and Prometheus text parser
(``obs/collector.py``) against the JAX package's: the same objectives fed
the same sample sequence at fixed times give the same verdict dicts and
export the same ``astpu_slo_*`` series, over every kind; the parser reads
the same samples, types and exemplars from a registry's text."""

from __future__ import annotations

import math

import pytest

from advanced_scrapper_tpu.obs import collector as ref_collector
from advanced_scrapper_tpu.obs import slo as ref_slo
from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu_torch.obs import collector, slo, telemetry

OBJECTIVES = [
    {"name": "lat", "kind": "p99_latency_max", "metric": "astpu_rpc_seconds",
     "threshold": 0.5, "labels": {"op": "probe"}, "fast_window": 30, "slow_window": 120},
    {"name": "thr", "kind": "rate_min", "metric": "astpu_docs_total", "threshold": 10.0},
    {"name": "compiles", "kind": "rate_max", "metric": "astpu_jit_compiles_total",
     "threshold": 0.0, "budget": 0.5},
    {"name": "errs", "kind": "ratio_max", "metric": "astpu_err_total",
     "denominator": "astpu_req_total", "threshold": 0.1},
    {"name": "healthy", "kind": "gauge_min", "metric": "astpu_up", "threshold": 2, "agg": "sum"},
    {"name": "depth", "kind": "gauge_max", "metric": "astpu_depth", "threshold": 5, "agg": "max"},
    {"name": "typo", "kind": "gauge_min", "metric": "astpu_no_such_series", "threshold": 1},
]


def hist_samples(name: str, labels: dict, counts: list[float]) -> list:
    """Cumulative ``_bucket`` samples over bounds 0.1, 0.5, 1, +Inf."""
    out = []
    for le, c in zip(("0.1", "0.5", "1", "+Inf"), counts):
        out.append((f"{name}_bucket", {**labels, "le": le}, c))
    return out


def round_samples(step: int) -> list:
    """One evaluation's flat samples; the series move step by step so that
    each objective is met in some rounds and violated in others."""
    lat = [[0, 0, 0, 0], [10, 99, 100, 100], [10, 99, 100, 100],
           [10, 100, 150, 200], [10, 300, 300, 300]][step]
    return [
        *hist_samples("astpu_rpc_seconds", {"op": "probe", "instance": "a"}, lat),
        *hist_samples("astpu_rpc_seconds", {"op": "other"}, [5, 5, 5, 5]),
        ("astpu_docs_total", {"instance": "a"}, [0, 500, 700, 701, 2000][step]),
        ("astpu_docs_total", {"instance": "b"}, [0, 100, 100, 100, 100][step]),
        ("astpu_jit_compiles_total", {}, [3, 3, 4, 4, 4][step]),
        ("astpu_err_total", {}, [0, 1, 30, 30, 31][step]),
        ("astpu_req_total", {}, [10, 100, 120, 120, 500][step]),
        ("astpu_up", {"shard": "0"}, 1.0),
        ("astpu_up", {"shard": "1"}, [1.0, 1.0, 0.0, 1.0, 1.0][step]),
        ("astpu_depth", {"q": "x"}, [1.0, 9.0, 2.0, 2.0, math.inf][step]),
    ]


def test_constants_equal_reference():
    assert slo.KINDS == ref_slo.KINDS


@pytest.mark.parametrize("export", [True, False])
def test_engine_verdicts_and_series_equal_reference(export):
    reg, ref_reg = telemetry.Registry(enabled=True), ref_telemetry.Registry(enabled=True)
    eng = slo.SloEngine(OBJECTIVES, registry=reg, export=export)
    ref = ref_slo.SloEngine(OBJECTIVES, registry=ref_reg, export=export)
    assert [o.to_dict() for o in eng.objectives] == [o.to_dict() for o in ref.objectives]
    seen = set()
    for step, now in enumerate((1000.0, 1010.0, 1020.0, 1025.0, 1200.0)):
        got = eng.evaluate(round_samples(step), now=now)
        want = ref.evaluate(round_samples(step), now=now)
        assert got == want
        assert eng.last_verdict == want
        assert reg.prometheus_text() == ref_reg.prometheus_text()
        seen |= {(o["name"], o["ok"]) for o in got["objectives"]}
        seen |= {("alerting", name) for name in got["alerting"]}
    # every kind was met and violated at least once; a missing series is no data
    for o in OBJECTIVES[:-1]:
        assert {(o["name"], True), (o["name"], False)} <= seen, o["name"]
    assert ("typo", None) in seen and ("typo", True) not in seen
    assert any(k == "alerting" for k, _ in seen)
    if export:
        (c,) = [m for m in reg.find("astpu_slo_compliant") if m.labels["objective"] == "typo"]
        assert c.value == -1.0, "a missing series must never read as green"


def test_load_objectives_and_percentiles_equal_reference():
    for bad in ([{"name": "x", "kind": "nope", "metric": "m", "threshold": 1}],
                [{"name": "x", "kind": "ratio_max", "metric": "m", "threshold": 1}],
                [{"name": "x", "kind": "rate_min", "metric": "m", "threshold": 1,
                  "budget": 0}],
                [OBJECTIVES[0], OBJECTIVES[0]]):
        with pytest.raises(ValueError) as got:
            slo.load_objectives(bad)
        with pytest.raises(ValueError) as want:
            ref_slo.load_objectives(bad)
        assert str(got.value) == str(want.value)
    ready = slo.SloObjective.from_dict(OBJECTIVES[1])
    assert slo.load_objectives([ready]) == [ready]
    for buckets in ([], [(0.1, 0)], [(0.1, 5), (0.5, 5), (math.inf, 1)],
                    [(0.1, 0), (math.inf, 3)], [(math.inf, 2)], [(1.0, 0), (2.0, 0)]):
        for q in (0.0, 0.5, 0.99, 1.0):
            assert slo.percentile_from_buckets(buckets, q) == \
                ref_slo.percentile_from_buckets(buckets, q)


def exercise(tel):
    """The same metric operations on a registry of ``tel``'s package."""
    reg = tel.Registry(enabled=True)
    reg.counter("astpu_req_total", "requests", route="/a").inc(3)
    reg.counter("astpu_req_total", "requests", route="/b").inc()
    reg.gauge("astpu_up", "up").set(1)
    h = reg.histogram("astpu_rpc_seconds", "latency", op="probe")
    for v in (0.001, 0.02, 0.3, 70.0):
        h.observe(v, trace="t-1")
    return reg


def test_registry_samples_and_parser_equal_reference():
    reg, ref_reg = exercise(telemetry), exercise(ref_telemetry)
    text = reg.prometheus_text()
    ref_text = ref_reg.prometheus_text()
    got = collector.parse_prometheus_text(text)
    assert got == ref_collector.parse_prometheus_text(text)
    assert collector.parse_prometheus_text(ref_text) == ref_collector.parse_prometheus_text(
        ref_text)
    samples, types, exemplars = got
    assert types["astpu_rpc_seconds"] == "histogram"
    assert ("astpu_req_total", {"route": "/b"}, 1.0) in samples
    assert slo.SloEngine.registry_samples(reg) == samples
    assert ref_slo.SloEngine.registry_samples(ref_reg) == ref_collector.parse_prometheus_text(
        ref_text)[0]
    odd = "junk line\n# TYPE x counter\nx{a=\"1\"} notanumber\nx 2\n\n# other\n"
    assert collector.parse_prometheus_text(odd) == ref_collector.parse_prometheus_text(odd)
    for v in ("plain", 'q"uote', "back\\slash"):
        assert collector._escape_label(v) == ref_collector._escape_label(v)
        assert collector._parse_labels(f'k="{collector._escape_label(v)}"') == {"k": v}
    assert exemplars == ref_collector.parse_prometheus_text(text)[2]
