"""The port's canary prober (``obs/canary.py``) against the JAX package's:
rounds over the port's CPU engine and the JAX engine give the same SLIs
(latency aside) and series; the wipe runs when ``resolve`` raises, and a
failing wipe is contained.  Then the acceptance configuration of the
reference's canary test, without the fleet: the rerank tier carries knee
recall, so forcing ``skip_rerank`` through the ladder drops the canary's
recall under its floor and flips ``astpu_slo_compliant{objective=
"canary_recall"}`` to 0, and leaving the step flips it back, with the
JAX package's recall values at each step."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.obs import canary as ref_canary
from advanced_scrapper_tpu.obs import slo as ref_slo
from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu.runtime.admission import DegradationLadder as RefLadder
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.obs import canary, slo, telemetry
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from advanced_scrapper_tpu_torch.runtime.admission import DegradationLadder


@pytest.fixture(autouse=True)
def fresh_registries():
    for reg in (telemetry.REGISTRY, ref_telemetry.REGISTRY):
        reg.reset()
    yield
    for reg in (telemetry.REGISTRY, ref_telemetry.REGISTRY):
        reg.reset()


def gauge(reg, name: str, **labels):
    for m in reg.find(name):
        if all(m.labels.get(k) == str(v) for k, v in labels.items()):
            return m.value
    return None


def no_latency(sli: dict) -> dict:
    return {k: v for k, v in sli.items() if k != "latency_seconds"}


def test_constants_equal_reference():
    assert canary.CANARY_SPACE_PREFIX == ref_canary.CANARY_SPACE_PREFIX


@pytest.mark.parametrize("overrides", [dict(), dict(rerank=False)], ids=["default", "certified"])
def test_rounds_over_the_engines_equal_reference(overrides):
    eng = NearDupEngine(DedupConfig(**overrides), device="cpu")
    ref = RefEngine(RefConfig(**overrides))
    prober = canary.CanaryProber(eng.dedup_reps, seed=3)
    ref_prober = ref_canary.CanaryProber(lambda t: np.asarray(ref.dedup_reps(t)), seed=3)
    for rid in (None, None, 7):
        got, want = prober.run_round(rid), ref_prober.run_round(rid)
        assert no_latency(got) == no_latency(want)
        assert got["latency_seconds"] > 0 and got["oracle_pairs"] > 0
        assert got["index_dups"] == -1 and got["wiped"] == 0
    assert prober.rounds == ref_prober.rounds == 8
    assert prober.last_sli == got
    for name in ("astpu_canary_recall", "astpu_canary_precision", "astpu_canary_rounds_total"):
        assert gauge(telemetry.REGISTRY, name) == gauge(ref_telemetry.REGISTRY, name)
    (h,) = telemetry.REGISTRY.find("astpu_canary_latency_seconds")
    assert h.count == 3
    assert [o.to_dict() for o in prober.objectives(recall_min=0.8)] == \
        [o.to_dict() for o in ref_prober.objectives(recall_min=0.8)]


def test_index_run_and_wipe_are_scored_and_counted():
    wiped = []

    def index_run(texts):
        return np.where(np.arange(len(texts)) % 3 == 0, 0, -1)

    prober = canary.CanaryProber(lambda t: np.arange(len(t)), index_run=index_run,
                                 wipe=lambda: wiped.append(1) or 5, seed=1)
    sli = prober.run_round()
    assert sli["wiped"] == 5 and wiped == [1] and sli["index_dups"] > 0
    assert sli["recall"] == 0.0 and sli["precision"] == 1.0 and sli["predicted_pairs"] == 0
    (c,) = telemetry.REGISTRY.find("astpu_canary_postings_wiped_total")
    assert c.value == 5


def test_wipe_runs_when_resolve_raises_and_its_failure_is_contained():
    wiped = []

    def boom(_texts):
        raise RuntimeError("resolve failed")

    prober = canary.CanaryProber(boom, wipe=lambda: wiped.append(1) or 3)
    with pytest.raises(RuntimeError, match="resolve failed"):
        prober.run_round()
    assert wiped == [1], "the wipe runs whether the round raised or not"

    def bad_wipe():
        raise OSError("wipe failed")

    sli = canary.CanaryProber(lambda t: np.arange(len(t)), wipe=bad_wipe).run_round()
    assert sli["wiped"] == -1


def acceptance_config(cls):
    """The reference canary test's knee engineering: no exact rescue past
    the cap, knee families on fine-only edges."""
    return dataclasses.replace(cls(rerank=True), sim_threshold=0.6, exact_verify_cap=0,
                               fine_margin=0.06)


def test_skip_rerank_flips_the_canary_slo_and_recovers():
    """The reference's acceptance spine without the fleet, on the port's
    CPU engine beside the JAX engine: healthy round compliant, the round
    under ``skip_rerank`` violated, the round after the step exits
    compliant again with the healthy recall."""
    sides = []
    for eng, ladder, slo_mod, canary_mod, reg in (
            (NearDupEngine(acceptance_config(DedupConfig), device="cpu"),
             DegradationLadder(dwell_s=0.0), slo, canary, telemetry.REGISTRY),
            (RefEngine(acceptance_config(RefConfig)), RefLadder(dwell_s=0.0), ref_slo,
             ref_canary, ref_telemetry.REGISTRY)):
        eng.ladder = ladder
        prober = canary_mod.CanaryProber(lambda t, e=eng: np.asarray(e.dedup_reps(t)), seed=0,
                                         threshold=0.6)
        engine = slo_mod.SloEngine(prober.objectives(recall_min=0.93, precision_min=0.5))
        sides.append((eng, ladder, prober, engine, reg))

    def step(side):
        eng, ladder, prober, engine, reg = side
        sli = prober.run_round(round_id=0)
        verdict = {o["name"]: o for o in engine.evaluate()["objectives"]}
        compliant = gauge(reg, "astpu_slo_compliant", objective="canary_recall")
        return sli, verdict["canary_recall"]["ok"], compliant, eng._rerank_applied

    got = {}
    for phase, pressure in (("healthy", None), ("brownout", 1.0), ("recovered", 0.0)):
        outs = []
        for side in sides:
            ladder = side[1]
            if pressure is not None:
                for _ in range(4):
                    ladder.observe(pressure)
            outs.append(step(side))
        (sli, ok, compliant, applied), (ref_sli, ref_ok, ref_compliant, ref_applied) = outs
        assert no_latency(sli) == no_latency(ref_sli), phase
        assert (ok, compliant, applied) == (ref_ok, ref_compliant, ref_applied), phase
        got[phase] = (sli, ok, compliant, applied)
    healthy, brownout, recovered = got["healthy"], got["brownout"], got["recovered"]
    assert healthy[0]["recall"] >= 0.93 and healthy[1:] == (True, 1.0, True)
    assert sides[0][1].active("skip_rerank") is False
    assert brownout[0]["recall"] < 0.93 and brownout[1:] == (False, 0.0, False)
    assert recovered[0]["recall"] == healthy[0]["recall"] and recovered[1:] == (True, 1.0, True)
    (effects,) = [c for c in telemetry.REGISTRY.find("astpu_degraded_effects_total")
                  if c.labels["step"] == "skip_rerank"]
    assert effects.value == 1, "the bypassed round is counted"


# -- the canary: key space on a live port fleet ------------------------------------


def test_canary_space_isolation_and_fleet_wipe(tmp_path):
    """The reference's case over a 1×2 port fleet: the canary space
    auto-provisions on first touch, re-sent rows attribute as dups there,
    the real space never sees them, a wipe of a real space is refused by
    the client and by the server, the canary wipe expires every replica's
    copy, and the allocator's high water survives it."""
    from advanced_scrapper_tpu_torch.index.fleet import ShardedIndexClient
    from advanced_scrapper_tpu_torch.index.remote import IndexShardServer, RemoteIndex
    from advanced_scrapper_tpu_torch.net.rpc import RpcRemoteError

    servers = [IndexShardServer(str(tmp_path / f"n{r}"), cut_postings=96, compact_segments=4,
                                compact_inline=True, name=f"n{r}").start() for r in range(2)]
    client = ShardedIndexClient("|".join(f"127.0.0.1:{s.port}" for s in servers),
                                spill_dir=str(tmp_path / "spill"), timeout=2.0, retries=1,
                                health_timeout=0.2)
    canary_client = None
    try:
        canary_client = client.for_space(canary.CANARY_SPACE_PREFIX + "probe")
        keys = np.arange(1, 65, dtype=np.uint64).reshape(8, 8)
        ids = canary_client.allocate_doc_ids(8)
        assert (canary_client.check_and_add_batch(keys, ids) == -1).all()
        again = canary_client.check_and_add_batch(keys, canary_client.allocate_doc_ids(8))
        assert (again == ids).all(), "re-sent rows attribute to their first posting"
        assert (np.asarray(client.probe_batch(keys)) == -1).all()
        with pytest.raises(ValueError, match="wipe"):
            client.wipe()
        real = RemoteIndex(("127.0.0.1", servers[0].port), space="bands", timeout=2.0)
        try:
            with pytest.raises(RpcRemoteError, match="wipe"):
                real.wipe()
        finally:
            real.close()
        assert canary_client.wipe() == 64 * 2, "every replica's copy must be expired"
        assert (np.asarray(canary_client.probe_batch(keys)) == -1).all()
        assert canary_client.wipe() == 0, "a re-wipe of an empty space is idempotent"
        assert int(canary_client.allocate_doc_ids(4).min()) > int(ids.max())
        for srv in servers:
            for sp, idx in srv.indexes.items():
                st = idx.stats()
                assert int(st["segment_postings"]) + int(st["wal_postings"]) == 0, sp
            assert canary.CANARY_SPACE_PREFIX + "probe" in srv.indexes
    finally:
        if canary_client is not None:
            canary_client.close()
        client.close()
        for srv in servers:
            srv.stop()
