"""Per-stage wall-clock counters for the host→device path.

The port's copy of the reference's ``obs/stages.py``.  Hot paths wrap
their stage work in :func:`timed` (or call :func:`add`); a reader calls
:func:`reset` before a window and :func:`snapshot_ms` after it.
Attribution is by call site: the pipelines overlap stages on purpose, so
the per-stage sums can exceed the end-to-end wall clock, and the
``kernel`` stage is the time the host spent waiting on device results
(launches are asynchronous; a hidden kernel contributes ~0).

Every :func:`add` lands in the always-on ``astpu_stage_seconds``
histogram (``obs/telemetry.py``), so a windowed ``stage_ms`` and the live
``/metrics`` stage series are the same numbers.  The histograms are
cumulative; :func:`reset` snapshots per-stage baselines and
:func:`snapshot_ms` reports the delta since (two concurrent windowed
readers would see each other's time).

The device-traffic counters (:func:`count_device_put`,
:func:`count_dispatch`) count the port's explicit copies to the card and
its kernel launches; the mesh's planes label them per shard
(:func:`sharded_device_counters`, the ``astpu_sharded_put_skew`` gauge
of :func:`record_sharded_put_skew`).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from advanced_scrapper_tpu_torch.obs import telemetry

_lock = threading.Lock()
_hists: dict[str, telemetry.Histogram] = {}
_baseline: dict[str, float] = {}  # per-stage cumulative sum at last reset()

#: canonical stage names (call sites may add others; these are the bench's)
STAGES = (
    "encode",
    "h2d",
    "kernel",
    "resolve",
    "matcher_build",
    "matcher_screen",
    "matcher_verify",
)


def _hist(stage: str) -> telemetry.Histogram:
    # local cache so the per-batch path skips the registry lock/lookup
    h = _hists.get(stage)
    if h is None:
        h = telemetry.stage_histogram(stage)
        with _lock:
            _hists[stage] = h
    return h


def add(stage: str, seconds: float) -> None:
    _hist(stage).observe(seconds)


@contextmanager
def timed(stage: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(stage, time.perf_counter() - t0)


def reset() -> None:
    """Start a measurement window: nothing is cleared (the live series
    stays cumulative); per-stage baselines are snapshotted instead."""
    with _lock:
        _baseline.clear()
        for h in telemetry.stage_histograms():
            _baseline[h.labels["stage"]] = h.sum


def snapshot_ms() -> dict[str, float]:
    """Cumulative per-stage milliseconds since the last :func:`reset`."""
    out: dict[str, float] = {}
    with _lock:
        for h in telemetry.stage_histograms():
            stage = h.labels["stage"]
            out[stage] = round((h.sum - _baseline.get(stage, 0.0)) * 1e3, 1)
    return dict(sorted(out.items()))


# -- device-traffic counters ---------------------------------------------
#
# Always-on (like the stage histograms): launch counts are checked
# numerically (one copy and one launch a chunk on the engine's main
# path), so the counters exist whether or not telemetry is enabled.  The
# ``regime`` label names the instrumented plane ("dedup" = the
# NearDupEngine, "feed" = DeviceFeed staging, "rerank" = the rerank
# tier).  Only explicit traffic is counted: a ``Tensor.to(card)`` of host
# data, and a launch of a hand-written kernel.

_dev_counters: dict[tuple[str, str, str | None], telemetry.Counter] = {}


def _dev(name: str, regime: str, shard: str | None = None) -> telemetry.Counter:
    c = _dev_counters.get((name, regime, shard))
    if c is None:
        labels = {"regime": regime}
        if shard is not None:
            # the mesh's planes label traffic per shard, so the per-shard
            # one-copy, one-launch contract is a ledger fact
            labels["shard"] = shard
        c = telemetry.event_counter(
            name,
            {
                "astpu_device_puts_total": "explicit copies of host data to the card",
                "astpu_device_dispatches_total": "hand-written kernel launches",
                "astpu_h2d_bytes_total": "host→device bytes shipped by puts",
            }[name],
            **labels,
        )
        with _lock:
            _dev_counters[(name, regime, shard)] = c
    return c


def count_device_put(
    nbytes: int, regime: str = "dedup", *, shard: int | str | None = None
) -> None:
    """Record one explicit copy of ``nbytes`` to the card (``shard``: the
    mesh shard the copy landed on, for the sharded planes)."""
    shard = None if shard is None else str(shard)
    _dev("astpu_device_puts_total", regime, shard).inc()
    _dev("astpu_h2d_bytes_total", regime, shard).inc(nbytes)


def count_dispatch(
    regime: str = "dedup", n: int = 1, *, shard: int | str | None = None
) -> None:
    """Record ``n`` kernel launches (``shard``: the mesh shard that ran
    them; a step over the mesh counts once per shard)."""
    _dev(
        "astpu_device_dispatches_total", regime,
        None if shard is None else str(shard),
    ).inc(n)


def device_counters() -> dict[str, float]:
    """Cumulative device-traffic totals, summed across ``regime`` labels:
    ``{"device_puts", "device_dispatches", "h2d_bytes"}``.  Subtract two
    snapshots to window a regime (the bench does)."""
    out = {"device_puts": 0.0, "device_dispatches": 0.0, "h2d_bytes": 0.0}
    short = {
        "astpu_device_puts_total": "device_puts",
        "astpu_device_dispatches_total": "device_dispatches",
        "astpu_h2d_bytes_total": "h2d_bytes",
    }
    for name, key in short.items():
        for c in telemetry.REGISTRY.find(name):
            out[key] += c.value
    return out


def regime_device_counters(regime: str) -> dict[str, float]:
    """Cumulative device-traffic totals for ONE regime label:
    ``{"device_puts", "device_dispatches", "h2d_bytes"}`` — the
    per-regime twin of :func:`device_counters`.  The rerank launch-count
    gate windows this (subtract two snapshots) to assert a settled
    corpus cost exactly ``tiles + 1`` puts and ``tiles + 1`` dispatches
    on the ``"rerank"`` plane regardless of what the dedup plane did in
    between."""
    short = {
        "astpu_device_puts_total": "device_puts",
        "astpu_device_dispatches_total": "device_dispatches",
        "astpu_h2d_bytes_total": "h2d_bytes",
    }
    out = {"device_puts": 0.0, "device_dispatches": 0.0, "h2d_bytes": 0.0}
    for name, key in short.items():
        for c in telemetry.REGISTRY.find(name):
            if c.labels.get("regime") == regime:
                out[key] += c.value
    return out


def sharded_device_counters(regime: str = "sharded") -> dict[str, dict[str, float]]:
    """Per-shard cumulative device-traffic totals of one regime: ``{shard:
    {"device_puts", "device_dispatches", "h2d_bytes"}}``; only
    shard-labelled series count.  Subtract two snapshots to window a
    corpus (every shard's delta is tiles + 1 / tiles + 1)."""
    short = {
        "astpu_device_puts_total": "device_puts",
        "astpu_device_dispatches_total": "device_dispatches",
        "astpu_h2d_bytes_total": "h2d_bytes",
    }
    out: dict[str, dict[str, float]] = {}
    for name, key in short.items():
        for c in telemetry.REGISTRY.find(name):
            shard = c.labels.get("shard")
            if shard is None or c.labels.get("regime") != regime:
                continue
            per = out.setdefault(
                shard, {"device_puts": 0.0, "device_dispatches": 0.0, "h2d_bytes": 0.0}
            )
            per[key] += c.value
    return out


def record_sharded_put_skew(baseline: dict | None = None, regime: str = "sharded") -> float:
    """Max − min per-shard put count, set on the always-on
    ``astpu_sharded_put_skew`` gauge: 0 for a balanced plane.
    ``baseline`` (an earlier :func:`sharded_device_counters`) windows it to
    the work since, and only the shards active in the window count, so
    corpora on meshes of different shard counts read no false skew."""
    per = sharded_device_counters(regime)
    base = baseline or {}
    puts = [
        v["device_puts"] - base.get(s, {}).get("device_puts", 0.0)
        for s, v in per.items()
    ]
    puts = [p for p in puts if p > 0]  # shards active in the window
    skew = (max(puts) - min(puts)) if puts else 0.0
    telemetry.REGISTRY.gauge(
        "astpu_sharded_put_skew",
        "max-min per-shard device_put count (0 = balanced sharded ledger)",
        always=True,
    ).set(skew)
    return skew


def _clear_for_tests() -> None:
    """Drop the handle cache and baselines after a registry reset, or
    cached handles would keep feeding histograms (and device counters)
    the registry no longer exports.  Runs AUTOMATICALLY on every
    ``telemetry.REGISTRY.reset()`` via the reset hook below — the manual
    call-it-yourself contract was a real test-ordering trap (an early
    test's reset silently zeroed every later test's device-ledger
    deltas)."""
    with _lock:
        _hists.clear()
        _baseline.clear()
        _dev_counters.clear()


telemetry.REGISTRY.add_reset_hook(_clear_for_tests)
