"""The port's autoscaler (``runtime/autoscaler.py``) against the JAX
package's.

Every case of the reference's ``tests/test_autoscaler.py`` runs against the
port on a fake clock: hysteresis, dwell, cooldown, shard bounds, the SLO
gate, a failing callback.  Then one seeded ``observe()`` script goes
through both packages and gives the same transitions, callbacks,
``status()`` and always-on series at every step."""

from __future__ import annotations

import numpy as np
import pytest

from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu.runtime import autoscaler as ref_autoscaler
from advanced_scrapper_tpu_torch.obs import telemetry
from advanced_scrapper_tpu_torch.runtime import Autoscaler, admission_pressure, autoscaler

PACKAGES = {"port": (autoscaler, telemetry), "jax": (ref_autoscaler, ref_telemetry)}


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def fresh_registries():
    for _mod, tel in PACKAGES.values():
        tel.REGISTRY.reset()
    yield
    for _mod, tel in PACKAGES.values():
        tel.REGISTRY.reset()


def make_scaler(shards: int = 2, mod=autoscaler, **kw):
    """An autoscaler with recording callbacks and the default thresholds
    (out: arm ≥0.7 hold >0.4; in: arm ≤0.15 hold <0.3; dwell 30 s,
    cooldown 300 s)."""
    calls: list[tuple[str, int]] = []
    clock = Clock()
    kw.setdefault("max_shards", 8)
    sc = mod.Autoscaler(shards, scale_out=lambda t: calls.append(("out", t)),
                        scale_in=lambda t: calls.append(("in", t)), clock=clock, **kw)
    return sc, clock, calls


# -- the reference's cases, against the port ------------------------------------------


def test_runtime_exports_the_autoscaler():
    assert Autoscaler is autoscaler.Autoscaler
    assert admission_pressure is autoscaler.admission_pressure


@pytest.mark.parametrize("kw,match", [
    (dict(out_at=0.4, out_exit=0.7), "thresholds"),
    (dict(in_at=0.5, in_exit=0.3), "thresholds"),
    (dict(in_exit=0.5, out_exit=0.5), "thresholds"),
    (dict(shards=2, min_shards=4), "min_shards"),
])
def test_threshold_ordering_is_validated(kw, match):
    for mod, _tel in PACKAGES.values():
        with pytest.raises(ValueError, match=match):
            make_scaler(mod=mod, **kw)


def test_admission_pressure_reads_the_max_gate():
    samples = [("astpu_admission_pressure", {"gate": "a"}, 0.3),
               ("astpu_other_gauge", {}, 9.0),
               ("astpu_admission_pressure", {"gate": "b"}, 0.7)]
    assert admission_pressure(samples) == 0.7
    assert admission_pressure([]) == 0.0


def test_admission_pressure_reads_the_live_registry():
    """With no samples given it reads the port's own registry through the
    SLO engine: an admission gate's pressure gauge is the signal."""
    from advanced_scrapper_tpu_torch.runtime.admission import AdmissionController

    telemetry.set_enabled(True)
    try:
        ctrl = AdmissionController(max_inflight=4, name="scaler-feed")
        held = [ctrl.admit() for _ in range(3)]
        assert all(d.admitted for d in held)
        assert admission_pressure() == pytest.approx(ctrl.pressure()) and ctrl.pressure() > 0
    finally:
        telemetry.set_enabled(None)


def test_oscillating_pressure_never_transitions():
    sc, _clock, calls = make_scaler()
    for t in range(0, 600, 20):
        p = 0.9 if (t // 20) % 2 == 0 else 0.35  # 0.35: the middle band
        assert sc.observe(p, now=float(t)) == "none"
    assert calls == [] and sc.shards == 2
    assert sc._m_trans["out"].value == 0 and sc._m_trans["in"].value == 0


def test_sustained_pressure_fires_exactly_one_scale_out():
    sc, _clock, calls = make_scaler()
    assert sc.observe(0.9, now=0.0) == "none"
    assert sc.observe(0.9, now=15.0) == "none"
    assert sc.observe(0.9, now=31.0) == "out"
    assert calls == [("out", 4)] and sc.shards == 4
    assert sc._m_trans["out"].value == 1


def test_hold_band_keeps_the_timer_armed():
    sc, _clock, calls = make_scaler()
    sc.observe(0.9, now=0.0)
    assert sc.observe(0.45, now=10.0) == "none"
    assert sc.observe(0.9, now=31.0) == "out"
    assert calls == [("out", 4)]


def test_middle_band_resets_the_timer():
    sc, _clock, _calls = make_scaler()
    sc.observe(0.9, now=0.0)
    sc.observe(0.35, now=10.0)
    sc.observe(0.9, now=20.0)
    assert sc.observe(0.9, now=45.0) == "none"
    assert sc.observe(0.9, now=51.0) == "out"


def test_cooldown_vetoes_back_to_back_reshards():
    sc, _clock, calls = make_scaler()
    sc.observe(0.9, now=0.0)
    assert sc.observe(0.9, now=31.0) == "out"
    sc.observe(0.9, now=40.0)
    assert sc.observe(0.9, now=75.0) == "none"
    assert sc._m_blocked["cooldown"].value >= 1
    assert sc.observe(0.9, now=340.0) == "out"
    assert calls == [("out", 4), ("out", 8)] and sc.shards == 8


def test_bounds_block_both_directions():
    sc, _clock, calls = make_scaler(shards=4, max_shards=4, min_shards=4)
    sc.observe(0.9, now=0.0)
    assert sc.observe(0.9, now=31.0) == "none"
    sc.observe(0.05, now=40.0)
    assert sc.observe(0.05, now=71.0) == "none"
    assert calls == [] and sc._m_blocked["bounds"].value == 2


def test_slo_gate_blocks_capacity_removal_only():
    sc, _clock, calls = make_scaler(shards=4)
    sc.observe(0.05, now=0.0)
    assert sc.observe(0.05, now=31.0, slo_ok=False) == "none"
    assert sc._m_blocked["slo"].value == 1
    assert sc.observe(0.05, now=32.0, slo_ok=True) == "in"
    assert calls == [("in", 2)] and sc.shards == 2 and sc._m_trans["in"].value == 1
    sc2, _c2, calls2 = make_scaler()
    sc2.observe(0.9, now=0.0)
    assert sc2.observe(0.9, now=31.0, slo_ok=False) == "out"
    assert calls2 == [("out", 4)]


class FakeSlo:
    def __init__(self, verdicts):
        self.verdicts = list(verdicts)

    def evaluate(self):
        v = self.verdicts.pop(0)
        if isinstance(v, Exception):
            raise v
        return {"ok": v}


def test_wired_slo_engine_gates_removal_and_an_unreadable_one_blocks():
    """``slo_engine=`` stands in for ``slo_ok``: a violated or unreadable
    SLO plane vetoes scale-in, a healthy one lets the armed dwell fire."""
    slo = FakeSlo([False, RuntimeError("scrape failed"), True])
    sc, _clock, calls = make_scaler(shards=4, slo_engine=slo)
    sc.observe(0.05, now=0.0)
    assert sc.observe(0.05, now=31.0) == "none"
    assert sc.observe(0.05, now=32.0) == "none"
    assert sc._m_blocked["slo"].value == 2
    assert sc.observe(0.05, now=33.0) == "in" and calls == [("in", 2)]


def test_failed_callback_keeps_the_timers_armed():
    clock = Clock()
    attempts: list[int] = []

    def flaky_out(target: int):
        attempts.append(target)
        if len(attempts) == 1:
            raise RuntimeError("migration transport died")

    sc = Autoscaler(2, scale_out=flaky_out, scale_in=lambda t: None, clock=clock)
    sc.observe(0.9, now=0.0)
    with pytest.raises(RuntimeError, match="transport died"):
        sc.observe(0.9, now=31.0)
    assert sc.shards == 2 and sc._m_trans["out"].value == 0
    assert sc.observe(0.9, now=32.0) == "out"
    assert attempts == [4, 4] and sc.shards == 4


def test_status_reports_armed_timers_and_cooldown():
    sc, clock, _calls = make_scaler()
    clock.t = 10.0
    sc.observe(0.9, now=10.0)
    clock.t = 25.0
    st = sc.status()
    assert st["shards"] == 2 and st["pressure"] == 0.9
    assert st["out_armed_s"] == pytest.approx(15.0)
    assert st["in_armed_s"] is None and st["cooldown_s"] == 0.0
    clock.t = 41.0
    assert sc.observe(0.9, now=41.0) == "out"
    st = sc.status()
    assert st["out_armed_s"] is None and st["cooldown_s"] == pytest.approx(300.0)


def test_transitions_are_traced():
    from advanced_scrapper_tpu_torch.obs import trace

    trace.set_enabled(True)
    trace.RECORDER.clear()
    try:
        sc, _clock, _calls = make_scaler(name="traced")
        sc.observe(0.9, now=0.0)
        sc.observe(0.9, now=31.0)
        events = [e for e in trace.RECORDER.snapshot() if e.get("name") == "autoscale.transition"]
        assert [(e["scaler"], e["dir"], e["shards"]) for e in events] == [("traced", "out", 4)]
    finally:
        trace.set_enabled(None)


# -- one script through both packages ---------------------------------------------------


def series(tel, scaler: str) -> dict:
    out = {}
    for e in tel.REGISTRY.status()["metrics"]:
        if e["name"].startswith("astpu_autoscale_") and e["labels"].get("scaler") == scaler:
            out[(e["name"], tuple(sorted(e["labels"].items())))] = e.get("value")
    return out


def run_script(pkg: str, seed: int, enabled: bool) -> list:
    """A seeded ``observe()`` script on a fake clock: pressures drawn from
    every band, ``slo_ok`` now and then false, a scale-out callback that
    fails once; every step's return (or raise), callbacks, status and
    series."""
    mod, tel = PACKAGES[pkg]
    tel.set_enabled(enabled)
    rng = np.random.RandomState(seed)
    calls: list = []
    fails = [int(rng.randint(1, 4))]

    def out(target):
        fails[0] -= 1
        if fails[0] == 0:
            raise RuntimeError("reshard failed")
        calls.append(("out", target))

    clock = Clock(100.0)
    sc = mod.Autoscaler(int(rng.choice([1, 2, 4])), scale_out=out,
                        scale_in=lambda t: calls.append(("in", t)), dwell_s=20.0,
                        cooldown_s=float(rng.choice([0.0, 60.0])), min_shards=1,
                        max_shards=16, clock=clock, name=f"parity{seed}")
    trail = []
    regimes = {"high": [0.75, 0.95, 0.95, 0.45], "low": [0.05, 0.1, 0.1, 0.2],
               "osc": [0.9, 0.35], "mid": [0.2, 0.35, 0.45]}
    steps = [(name, i) for name in rng.permutation(["high", "low", "osc", "mid", "high", "low"])
             for i in range(24)]
    for name, i in steps:
        clock.t += float(rng.choice([1.0, 5.0, 12.0]))
        levels = regimes[name]
        p = levels[i % 2] if name == "osc" else levels[rng.randint(len(levels))]
        slo = None if rng.rand() < 0.6 else bool(rng.rand() < 0.7)
        try:
            got = sc.observe(p, now=clock.t, slo_ok=slo)
        except RuntimeError as e:
            got = f"raised: {e}"
        trail.append((got, list(calls), sc.status(), series(tel, sc.name)))
    tel.set_enabled(None)
    return trail


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
@pytest.mark.parametrize("enabled", [True, False])
def test_scripted_observations_equal_the_reference(seed, enabled):
    port, ref = run_script("port", seed, enabled), run_script("jax", seed, enabled)
    assert port == ref
    assert any(step[0] == "out" for step in port) and any(step[0] == "in" for step in port)
