"""Declarative SLO engine: objectives as data, evaluated over metrics.

The port's copy of the reference's ``obs/slo.py``, with its kinds,
windows, verdict dicts and exported series.  The telemetry plane answers
"what is the p99"; this module answers "is it acceptable, and how fast is
the error budget burning".  Objectives are plain dicts (JSON-able) and
are evaluated over *flat Prometheus samples* ``(name, labels, value)``:
a registry's exposition text parsed by ``obs/collector.py``
(:meth:`SloEngine.registry_samples`), or any caller's samples.

Objective kinds:

- ``p99_latency_max``: p99 of a histogram <= ``threshold`` seconds, over
  the *window delta* of the cumulative buckets between evaluations (a
  latency regression that recovers reads as recovered);
- ``rate_min`` / ``rate_max``: a counter's per-second rate at least /
  at most ``threshold`` (``threshold: 0`` on ``astpu_jit_compiles_total``
  is the recompile alarm);
- ``ratio_max``: delta(``metric``) / delta(``denominator``) <=
  ``threshold`` (error-ratio budgets);
- ``gauge_min`` / ``gauge_max``: an aggregated gauge against a floor or
  a ceiling (the canary's recall and precision floors).

**Burn rate**, in the multi-window idiom: each objective keeps a history
of its verdicts; ``burn = violating fraction of the window / budget`` for
a fast and a slow window, and the objective is *alerting* only when both
exceed 1.

Every evaluation exports ``astpu_slo_compliant`` / ``astpu_slo_value`` /
``astpu_slo_burn_rate{window=fast|slow}`` / ``astpu_slo_violations_total``
(``objective=<name>`` labels) into a registry, and returns a
machine-readable verdict dict.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = [
    "SloObjective",
    "SloEngine",
    "load_objectives",
    "percentile_from_buckets",
]

KINDS = (
    "p99_latency_max", "rate_min", "rate_max", "ratio_max",
    "gauge_min", "gauge_max",
)


@dataclass
class SloObjective:
    """One objective, declared as data.

    ``labels`` is a subset match: a sample counts when every (k, v) here
    appears in its labels — so one objective can span every ``instance``
    of a merged series, or pin one with
    ``labels={"instance": "s0n0"}``.
    """

    name: str
    kind: str                  # one of KINDS
    metric: str                # base metric name (histograms: WITHOUT _bucket)
    threshold: float
    labels: dict = field(default_factory=dict)
    denominator: str | None = None   # ratio_max only: the total-series name
    agg: str = "sum"           # gauge aggregation across matches: sum|min|max
    budget: float = 0.05       # allowed violating fraction of a window
    fast_window: float = 30.0  # seconds
    slow_window: float = 300.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"objective {self.name!r}: unknown kind {self.kind!r}")
        if self.kind == "ratio_max" and not self.denominator:
            raise ValueError(
                f"objective {self.name!r}: ratio_max needs a denominator"
            )
        if self.budget <= 0:
            raise ValueError(f"objective {self.name!r}: budget must be > 0")

    @classmethod
    def from_dict(cls, d: dict) -> "SloObjective":
        return cls(**{k: v for k, v in d.items()})

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "metric": self.metric,
            "threshold": self.threshold,
            "labels": dict(self.labels),
            "denominator": self.denominator,
            "agg": self.agg,
            "budget": self.budget,
            "fast_window": self.fast_window,
            "slow_window": self.slow_window,
        }


def load_objectives(data) -> list[SloObjective]:
    """A list of dicts (or ready objectives) → objectives; the declarative
    entry point a JSON file feeds."""
    out = []
    for d in data:
        out.append(d if isinstance(d, SloObjective) else SloObjective.from_dict(d))
    names = [o.name for o in out]
    if len(names) != len(set(names)):
        raise ValueError(f"duplicate objective names in {names}")
    return out


def percentile_from_buckets(buckets: list[tuple[float, float]], q: float) -> float:
    """q-quantile from ``[(le_bound_seconds, count_in_bucket)]`` (NON-
    cumulative counts, sorted by bound; +Inf allowed as ``math.inf``);
    linear interpolation inside the containing bucket, 0.0 when empty."""
    total = sum(n for _b, n in buckets)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    lo = 0.0
    for bound, n in buckets:
        if n > 0 and cum + n >= target:
            hi = bound if not math.isinf(bound) else lo * 2 or 1.0
            return lo + (hi - lo) * ((target - cum) / n)
        cum += n
        lo = bound if not math.isinf(bound) else lo
    return lo


def _matches(labels: dict, want: dict) -> bool:
    return all(labels.get(k) == str(v) or labels.get(k) == v for k, v in want.items())


class _ObjState:
    __slots__ = ("prev_counters", "prev_buckets", "history", "violations")

    def __init__(self):
        self.prev_counters: dict | None = None  # series key → value
        self.prev_buckets: dict | None = None   # le → cumulative count
        self.history: deque = deque()           # (ts, violated bool)
        self.violations = 0


class SloEngine:
    """Evaluate declared objectives over flat samples; export + verdict."""

    def __init__(self, objectives, *, registry=None, export: bool = True):
        """``registry``: where the ``astpu_slo_*`` series land (default:
        the process registry — always-on, like event counters: an engine
        only exists because an operator declared objectives).  ``export=
        False`` keeps the engine side-effect free (pure verdicts for
        tests and embedded snapshots)."""
        from advanced_scrapper_tpu_torch.obs import telemetry

        self.objectives = load_objectives(objectives)
        self._state = {o.name: _ObjState() for o in self.objectives}
        self._prev_ts: float | None = None
        self.last_verdict: dict | None = None
        self._export = export
        self._reg = registry or telemetry.REGISTRY
        self._m: dict[tuple, object] = {}
        if export:
            for o in self.objectives:
                self._m[("compliant", o.name)] = self._reg.gauge(
                    "astpu_slo_compliant",
                    "1 = objective met at last evaluation, 0 = violated, "
                    "-1 = no data (the selected series do not exist — a "
                    "typo'd metric must never read as green)",
                    always=True, objective=o.name,
                )
                self._m[("value", o.name)] = self._reg.gauge(
                    "astpu_slo_value",
                    "the measured value the objective compares",
                    always=True, objective=o.name,
                )
                self._m[("viol", o.name)] = self._reg.counter(
                    "astpu_slo_violations_total",
                    "evaluations that found the objective violated",
                    always=True, objective=o.name,
                )
                for w in ("fast", "slow"):
                    self._m[(f"burn_{w}", o.name)] = self._reg.gauge(
                        "astpu_slo_burn_rate",
                        "violating window fraction / error budget "
                        "(>1 in BOTH windows = alerting)",
                        always=True, objective=o.name, window=w,
                    )

    # -- sample sources ----------------------------------------------------

    @staticmethod
    def registry_samples(registry=None):
        """Flatten a live :class:`~.telemetry.Registry` into the SAME flat
        samples the collector serves — one code path for both sources."""
        from advanced_scrapper_tpu_torch.obs import collector, telemetry

        reg = registry or telemetry.REGISTRY
        samples, _types, _ex = collector.parse_prometheus_text(
            reg.prometheus_text()
        )
        return samples

    # -- evaluation --------------------------------------------------------

    def _eval_p99(self, o: SloObjective, st: _ObjState, samples):
        # aggregate cumulative bucket counts per `le` across every
        # matching series (every instance of a merged histogram)
        cum: dict[float, float] = {}
        for name, labels, v in samples:
            if name != f"{o.metric}_bucket":
                continue
            le = labels.get("le")
            if le is None or not _matches(
                {k: v2 for k, v2 in labels.items() if k != "le"}, o.labels
            ):
                continue
            bound = math.inf if le == "+Inf" else float(le)
            cum[bound] = cum.get(bound, 0.0) + v
        if not cum:
            return None, None  # no data
        prev = st.prev_buckets or {}
        st.prev_buckets = dict(cum)
        bounds = sorted(cum)
        # window delta (cumulative-within-series AND cumulative-across-
        # bounds): de-cumulate across bounds first, then subtract the
        # previous window's de-cumulated counts
        def decum(c: dict) -> list[tuple[float, float]]:
            out, last = [], 0.0
            for b in sorted(c):
                out.append((b, max(0.0, c[b] - last)))
                last = c[b]
            return out

        cur_counts = dict(decum(cum))
        prev_counts = dict(decum(prev)) if prev else {}
        window = [
            (b, max(0.0, cur_counts.get(b, 0.0) - prev_counts.get(b, 0.0)))
            for b in bounds
        ]
        if sum(n for _b, n in window) <= 0:
            # nothing happened this window: an idle service is compliant,
            # not violating (and not "no data" — the series exists)
            return 0.0, False
        p99 = percentile_from_buckets(window, 0.99)
        return p99, p99 > o.threshold

    def _eval_counter_sum(self, o, samples, name):
        total = 0.0
        found = False
        for n, labels, v in samples:
            if n == name and _matches(labels, o.labels):
                total += v
                found = True
        return total if found else None

    def _eval_rate(self, o: SloObjective, st: _ObjState, samples, dt):
        cur = self._eval_counter_sum(o, samples, o.metric)
        if cur is None:
            return None, None
        prev = (st.prev_counters or {}).get("rate")
        st.prev_counters = {"rate": cur}
        if prev is None or dt is None or dt <= 0:
            return None, None  # first sight: no rate yet
        rate = max(0.0, cur - prev) / dt
        if o.kind == "rate_max":
            return rate, rate > o.threshold
        return rate, rate < o.threshold

    def _eval_ratio(self, o: SloObjective, st: _ObjState, samples):
        num = self._eval_counter_sum(o, samples, o.metric)
        den = self._eval_counter_sum(o, samples, o.denominator)
        if num is None and den is None:
            return None, None
        num = num or 0.0
        den = den or 0.0
        prev = st.prev_counters or {}
        st.prev_counters = {"num": num, "den": den}
        dnum = max(0.0, num - prev.get("num", 0.0)) if prev else num
        dden = max(0.0, den - prev.get("den", 0.0)) if prev else den
        ratio = (dnum / dden) if dden > 0 else (math.inf if dnum > 0 else 0.0)
        return ratio, ratio > o.threshold

    def _eval_gauge(self, o: SloObjective, samples):
        vals = [
            v
            for n, labels, v in samples
            if n == o.metric and _matches(labels, o.labels)
        ]
        if not vals:
            return None, None
        agg = {"sum": sum, "min": min, "max": max}[o.agg](vals)
        if o.kind == "gauge_min":
            return agg, agg < o.threshold
        return agg, agg > o.threshold

    def evaluate(self, samples=None, *, now: float | None = None) -> dict:
        """One evaluation round → the machine-readable verdict.

        ``samples``: flat ``[(name, labels, value)]`` (e.g.
        :meth:`registry_samples`); default = the process registry.
        """
        if samples is None:
            samples = self.registry_samples()
        now = time.time() if now is None else now
        dt = (now - self._prev_ts) if self._prev_ts is not None else None
        self._prev_ts = now
        objectives = []
        all_ok = True
        alerting = []
        for o in self.objectives:
            st = self._state[o.name]
            if o.kind == "p99_latency_max":
                value, violated = self._eval_p99(o, st, samples)
            elif o.kind in ("rate_min", "rate_max"):
                value, violated = self._eval_rate(o, st, samples, dt)
            elif o.kind == "ratio_max":
                value, violated = self._eval_ratio(o, st, samples)
            else:
                value, violated = self._eval_gauge(o, samples)
            if violated is not None:
                st.history.append((now, bool(violated)))
                if violated:
                    st.violations += 1
                    if self._export:
                        self._m[("viol", o.name)].inc()
            horizon = now - max(o.fast_window, o.slow_window)
            while st.history and st.history[0][0] < horizon:
                st.history.popleft()

            def frac(window: float) -> float:
                cut = now - window
                pts = [v for ts, v in st.history if ts >= cut]
                return (sum(pts) / len(pts)) if pts else 0.0

            burn_fast = frac(o.fast_window) / o.budget
            burn_slow = frac(o.slow_window) / o.budget
            ok = (violated is False) if violated is not None else None
            if violated:
                all_ok = False
            is_alerting = burn_fast > 1.0 and burn_slow > 1.0
            if is_alerting:
                alerting.append(o.name)
            if self._export:
                self._m[("compliant", o.name)].set(
                    -1.0 if violated is None else (0.0 if violated else 1.0)
                )
                if value is not None and not math.isinf(value):
                    self._m[("value", o.name)].set(float(value))
                self._m[("burn_fast", o.name)].set(burn_fast)
                self._m[("burn_slow", o.name)].set(burn_slow)
            objectives.append(
                {
                    "name": o.name,
                    "kind": o.kind,
                    "metric": o.metric,
                    "threshold": o.threshold,
                    "value": (
                        None if value is None
                        else (float(value) if not math.isinf(value) else "inf")
                    ),
                    "ok": ok,
                    "violations": st.violations,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "alerting": is_alerting,
                }
            )
        self.last_verdict = {
            "ts": now,
            "ok": all_ok,
            "alerting": alerting,
            "objectives": objectives,
        }
        return self.last_verdict
