"""The port's overload plane (``runtime/admission.py``, ``runtime/pause.py``)
against the JAX package's, and the brownout ladder in the port's engine.

With a fake clock, scripted traffic through both packages'
``DegradationLadder`` and ``AdmissionController`` gives the same levels,
decisions, retry-after hints, pressures and counted series.  In the
engine (on the CPU): under ``skip_rerank`` the default engine's
representatives equal the hookless engine's; ``shrink_window`` halves the
dispatcher's window on a corpus of several chunks; ``fewer_bands`` gives
``dedup_against_index`` the JAX engine's attributions; each application
is counted."""

from __future__ import annotations

import numpy as np
import pytest

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.index import PersistentIndex as RefIndex
from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu.obs import trace as ref_trace
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu.runtime import admission as ref_admission
from advanced_scrapper_tpu.runtime import pause as ref_pause
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.cpu.oracle import build_certification_corpus
from advanced_scrapper_tpu_torch.index import PersistentIndex
from advanced_scrapper_tpu_torch.obs import telemetry, trace
from advanced_scrapper_tpu_torch.pipeline import dedup
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from advanced_scrapper_tpu_torch.runtime import admission, pause

PACKAGES = ((admission, pause, telemetry, trace),
            (ref_admission, ref_pause, ref_telemetry, ref_trace))


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def fresh_state():
    for _adm, _p, tel, tr in PACKAGES:
        tel.REGISTRY.reset()
        tel.set_enabled(True)
        tr.set_enabled(True)
        tr.RECORDER.clear()
    yield
    for _adm, _p, tel, tr in PACKAGES:
        tel.REGISTRY.reset()
        tel.set_enabled(None)
        tr.set_enabled(None)


def series(tel, *prefixes: str) -> dict:
    out = {}
    for e in tel.REGISTRY.status()["metrics"]:
        if e["name"].startswith(prefixes):
            out[(e["name"], tuple(sorted(e["labels"].items())))] = e.get(
                "value", (e.get("count"), e.get("sum")))
    return out


def degrade_events(tr) -> list[tuple]:
    return [(e["name"], e.get("step"), e.get("level")) for e in tr.RECORDER.snapshot()
            if e.get("name", "").startswith("degrade.")]


def admission_script(adm, pause_mod, tel, tr) -> list:
    """Scripted traffic through a controller feeding a ladder, on a fake
    clock: every admission's outcome, hint and pressure, the ladder's level
    after it, releases, a pause, the shed step and its recovery."""
    clock = FakeClock()
    ladder = adm.DegradationLadder(
        [adm.LadderStep("shrink_window", 0.6, 0.3), adm.LadderStep("shed_low", 0.9, 0.5)],
        dwell_s=0.5, clock=clock, name="lad")
    ctrl = adm.AdmissionController(rate=4.0, burst=3, max_inflight=3, max_queue=5,
                                   ladder=ladder, clock=clock, name="gate")
    log = []
    held = []
    pattern = [adm.PRIORITY_NORMAL, adm.PRIORITY_LOW, adm.PRIORITY_HIGH,
               adm.PRIORITY_CRITICAL, adm.PRIORITY_LOW, 7]
    for i in range(60):
        prio = pattern[i % len(pattern)]
        d = ctrl.admit(prio, queue_depth=(i * 3) % 7 if i % 4 else None)
        log.append((i, bool(d), d.reason, d.retry_after, d.priority, d.slot,
                    round(ctrl.pressure(), 6), ladder.level(), ladder.active_steps(),
                    ctrl.inflight()))
        if d.slot:
            held.append(d)
        if i % 5 == 4 and held:
            ctrl.release(held.pop(0))
        if i == 30:
            ctrl.trigger(0.7)
            log.append(("paused", ctrl.remaining(), ctrl.trips))
        clock.advance(0.13 if i < 40 else 0.4)
    ctrl.release(adm.AdmissionDecision(True, slot=False))
    ctrl.release()
    while held:
        ctrl.release(held.pop())
    for i in range(12):  # calm traffic, each request done before the next
        d = ctrl.admit(adm.PRIORITY_NORMAL, queue_depth=0)
        log.append(("calm", bool(d), d.reason, round(ctrl.pressure(), 6), ladder.level()))
        ctrl.release(d)
        clock.advance(0.5)
    log.append(("end", ctrl.admitted, ctrl.rejected, ctrl.inflight(), ladder.status()))
    ladder.count_effect("shrink_window", 3)
    # a rate limit alone: the bucket's burst, then rejects until it refills
    rated = adm.AdmissionController(rate=2.0, burst=1, clock=clock, name="rated")
    for _ in range(4):
        d = rated.admit()
        log.append(("rated", bool(d), d.reason, d.retry_after))
        clock.advance(0.2)
    gate = pause_mod.PauseGate(clock=clock)
    gate.trigger(5)
    gate.trigger(2)
    slept = []
    gate.wait(sleep=lambda s: (slept.append(s), clock.advance(s)), tick=1.5)
    log.append(("gate", gate.remaining(), gate.trips, slept))
    return log


def test_admission_and_ladder_sequences_equal_reference():
    got = admission_script(*PACKAGES[0])
    want = admission_script(*PACKAGES[1])
    assert got == want
    reasons = {e[2] for e in got if isinstance(e[0], int) or e[0] == "rated"}
    assert {"", "rate", "concurrency", "queue", "paused", "shed"} <= reasons
    assert max(e[7] for e in got if isinstance(e[0], int)) == 2
    prefixes = ("astpu_admission_", "astpu_degraded_", "astpu_rate_limit_trips_total")
    assert series(telemetry, *prefixes) == series(ref_telemetry, *prefixes)
    assert degrade_events(trace) == degrade_events(ref_trace)
    assert ("degrade.enter", "shed_low", 2) in degrade_events(trace)
    assert ("degrade.exit", "shed_low", 1) in degrade_events(trace)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladder_levels_equal_reference_under_noisy_pressure(seed):
    """Random pressure on a fake clock: the same level after every sample,
    the same transitions counted, no flapping inside the dwell."""
    out = []
    for adm, _p, tel, _tr in PACKAGES:
        rng = np.random.RandomState(seed)
        clock = FakeClock()
        ladder = adm.DegradationLadder(dwell_s=0.3, clock=clock, name="noisy")
        levels = []
        for _ in range(400):
            levels.append(ladder.observe(float(rng.uniform(0.0, 1.1)), now=clock()))
            clock.advance(float(rng.uniform(0.0, 0.2)))
        out.append((levels, series(tel, "astpu_degraded_")))
    assert out[0] == out[1]
    assert len(set(out[0][0])) > 1


def test_ladder_declarations_and_defaults_equal_reference():
    assert admission.DEFAULT_LADDER_STEPS == tuple(
        admission.LadderStep(s.name, s.enter_at, s.exit_at)
        for s in ref_admission.DEFAULT_LADDER_STEPS)
    for steps in ([], [admission.LadderStep("a", 0.5, 0.6)],
                  [admission.LadderStep("a", 0.9, 0.5), admission.LadderStep("b", 0.8, 0.1)]):
        ref_steps = [ref_admission.LadderStep(s.name, s.enter_at, s.exit_at) for s in steps]
        with pytest.raises(ValueError) as got:
            admission.DegradationLadder(steps)
        with pytest.raises(ValueError) as want:
            ref_admission.DegradationLadder(ref_steps)
        assert str(got.value) == str(want.value)


def forced_ladder(*steps: str):
    """A port ladder over ``steps`` (in that order), all armed."""
    ladder = admission.DegradationLadder(
        [admission.LadderStep(n, 0.1 * (i + 1), 0.05 * (i + 1)) for i, n in enumerate(steps)],
        dwell_s=0.0)
    while ladder.level() < len(steps):
        ladder.observe(1.0)
    return ladder


def effects(ladder, step: str) -> float:
    return sum(c.value for c in telemetry.REGISTRY.find("astpu_degraded_effects_total")
               if c.labels["ladder"] == ladder.name and c.labels["step"] == step)


def corpus(seed: int = 31) -> list[bytes]:
    return build_certification_corpus(np.random.RandomState(seed), 24, n_long=2)


def test_skip_rerank_equals_the_hookless_engine():
    """The reference's brownout test on the port: under the armed step the
    default engine's representatives equal the hookless engine's (and the
    JAX engine's under the same step), the bypass is counted, and without
    the ladder the tier settles the next corpus again."""
    texts = corpus()
    want = NearDupEngine(DedupConfig(rerank=False), device="cpu").dedup_reps(texts)
    eng = NearDupEngine(DedupConfig(), device="cpu")
    eng.ladder = ladder = forced_ladder("skip_rerank")
    launches = eng.rerank_tier.stats.get("launches", 0)
    got = eng.dedup_reps(texts)
    assert np.array_equal(got, want)
    assert not eng._rerank_applied and effects(ladder, "skip_rerank") == 1
    assert eng.rerank_tier.stats.get("launches", 0) == launches, "the tier ran"
    ref = RefEngine(RefConfig())
    ref.ladder = ref_admission.DegradationLadder(
        [ref_admission.LadderStep("skip_rerank", 0.1, 0.05)], dwell_s=0.0)
    ref.ladder.observe(1.0)
    ref.ladder.observe(1.0)  # the second sample arms the step (dwell 0)
    assert np.array_equal(got, np.asarray(ref.dedup_reps(texts)))
    async_rep = eng.dedup_reps_async(texts)[: len(texts)].numpy()
    assert np.array_equal(async_rep, np.asarray(ref.dedup_reps_async(texts))[: len(texts)])
    assert effects(ladder, "skip_rerank") == 2
    eng.ladder = None
    eng.dedup_reps(texts)
    assert eng._rerank_applied and eng.rerank_tier.stats["pairs"] > 0


def test_shrink_window_halves_the_dispatcher_window(monkeypatch):
    monkeypatch.setattr(dedup, "CHUNK_BYTES", 64 << 10)  # several chunks
    texts = corpus(7)
    for window, put_workers, want in ((0, 1, 1), (8, 1, 4), (0, 4, 2), (1, 1, 1)):
        eng = NearDupEngine(DedupConfig(dispatch_window=window, put_workers=put_workers,
                                        rerank=False), device="cpu")
        base = eng.dedup_reps(texts)
        full = eng.last_dispatcher.window
        eng.ladder = ladder = forced_ladder("shrink_window")
        assert np.array_equal(eng.dedup_reps(texts), base), "the window changes no result"
        assert eng.last_chunks > 1 and eng.last_dispatcher.window == want == max(1, full // 2)
        assert effects(ladder, "shrink_window") == 1
        eng.dedup_reps_async(texts)
        assert effects(ladder, "shrink_window") == 2
    # a corpus of one chunk has no dispatcher, so nothing to shrink
    eng.dedup_reps([b"a short text", b"another short text"])
    assert eng.last_dispatcher is None and effects(ladder, "shrink_window") == 2


def test_fewer_bands_equals_the_reference_index_path(tmp_path):
    texts = corpus(11)
    eng, ref = NearDupEngine(DedupConfig(), device="cpu"), RefEngine(RefConfig())
    ref.ladder = ref_admission.DegradationLadder(
        [ref_admission.LadderStep("fewer_bands", 0.1, 0.05)], dwell_s=0.0)
    ref.ladder.observe(1.0)
    ref.ladder.observe(1.0)  # the second sample arms the step (dwell 0)
    eng.ladder = ladder = forced_ladder("fewer_bands")
    got_ix, want_ix = PersistentIndex(str(tmp_path / "p")), RefIndex(str(tmp_path / "j"))
    try:
        for part in (texts[:40], texts[40:]):
            got = eng.dedup_against_index(part, got_ix)
            assert np.array_equal(got, ref.dedup_against_index(part, want_ix))
        assert (got >= 0).any()
        keys, _docs = got_ix.dump_postings()
        fresh = int((eng.dedup_against_index(["a fresh text, not seen before"], got_ix) < 0).sum())
        keys2, _ = got_ix.dump_postings()
        assert fresh == 1 and len(keys2) - len(keys) == eng.params.num_bands // 2
        assert effects(ladder, "fewer_bands") == len(texts) + 1, "counted per row"
    finally:
        got_ix.close()
        want_ix.close()
