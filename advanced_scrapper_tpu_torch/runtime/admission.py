"""Admission control and declared graceful degradation: the overload plane.

The port's copy of the reference's ``runtime/admission.py``; two
runtime-level primitives that import nothing of ``pipeline`` or ``index``.

:class:`AdmissionController` makes an admission decision per request: a
token-bucket **rate** limit, a **concurrency** (in-flight) limit and a
caller-reported **queue-depth** limit, under a **priority class**
(:data:`PRIORITY_CRITICAL` is never refused; the lowest class is shed
first).  Every refusal is a counted reject carrying a retry-after hint.
It embeds a :class:`~.pause.PauseGate` (``trigger``/``remaining``/``wait``
with its telemetry names): an active pause rejects every non-critical
request with the pause's remaining time as the hint.

:class:`DegradationLadder` maps **sustained** pressure to declared
brownout steps (shrink the dispatch window, skip the rerank tier, probe
fewer LSH bands, shed lowest-priority work), each a counted, reversible
transition.  Steps arm in order with enter/exit hysteresis (distinct
thresholds plus a dwell time), so oscillating load cannot flap a step;
consumers ask ``ladder.active("skip_rerank")`` at their decision point and
count the shed work with :meth:`DegradationLadder.count_effect`.  The
engine (``pipeline/dedup.py``) honours the first three steps; the
``shed_low`` step is honoured here, by :meth:`AdmissionController.admit`.

Telemetry (all always-on):
``astpu_admission_requests_total{gate,outcome,class}``,
``astpu_admission_rejected_total{gate,reason}``,
``astpu_admission_retry_after_seconds{gate}``,
``astpu_admission_inflight{gate}``, ``astpu_admission_pressure{gate}``,
``astpu_degraded_step{ladder}``,
``astpu_degraded_transitions_total{ladder,step,dir}``,
``astpu_degraded_effects_total{ladder,step}``, and ``degrade.enter`` /
``degrade.exit`` events on the flight recorder.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from advanced_scrapper_tpu_torch.runtime.pause import PauseGate

__all__ = [
    "PRIORITY_CRITICAL",
    "PRIORITY_HIGH",
    "PRIORITY_LOW",
    "PRIORITY_NORMAL",
    "AdmissionController",
    "AdmissionDecision",
    "DEFAULT_LADDER_STEPS",
    "DegradationLadder",
    "LadderStep",
]

#: priority classes: smaller = more important.  CRITICAL (health pings,
#: promotion probes) is never refused — the one class overload must keep
#: answering, or overload becomes indistinguishable from death.
PRIORITY_CRITICAL = 0
PRIORITY_HIGH = 1
PRIORITY_NORMAL = 2
PRIORITY_LOW = 3

_CLASS_NAMES = {0: "critical", 1: "high", 2: "normal", 3: "low"}


def _class_name(priority: int) -> str:
    return _CLASS_NAMES.get(int(priority), str(int(priority)))


def _fresh_handles(obj) -> None:
    """Lazily re-instrument after a ``Registry.reset()`` (tests) —
    controllers and ladders cache metric HANDLES at construction, and a
    reset would otherwise orphan them: later rejects/transitions would
    increment counters the registry no longer exports (the same trap
    ``obs/stages.py`` retired with its reset hook).  Lazy — checked at
    each use site — so a dormant object never re-pollutes a freshly
    reset registry; only ones still actively deciding re-register."""
    from advanced_scrapper_tpu_torch.obs import telemetry

    if obj._gen != telemetry.REGISTRY.generation:
        obj._instrument()


@dataclass(frozen=True)
class AdmissionDecision:
    """One admission verdict.  Truthy iff admitted; a reject carries the
    machine-readable ``reason`` and a ``retry_after`` hint (seconds) the
    caller is expected to honor before retrying."""

    admitted: bool
    reason: str = ""
    retry_after: float = 0.0
    priority: int = PRIORITY_NORMAL
    #: True when this decision consumed an in-flight slot — the caller
    #: must hand the decision back via :meth:`AdmissionController.release`
    slot: bool = False

    def __bool__(self) -> bool:
        return self.admitted


class AdmissionController:
    """Token-bucket + concurrency + queue-depth admission with priority
    classes, counted rejects and retry-after hints.

    ``rate``/``burst`` bound sustained request throughput (0 = no rate
    limit); ``max_inflight`` bounds concurrently admitted work (0 = no
    limit; callers MUST :meth:`release` every admitted decision);
    ``max_queue`` rejects when the caller-reported queue depth reaches it
    (0 = no limit).  ``ladder`` (optional) receives a pressure
    observation per decision and, once its ``shed_step`` is active,
    requests with ``priority >= shed_at`` are refused outright.

    The PauseGate compatibility surface: :meth:`trigger`,
    :meth:`remaining` and :meth:`wait` delegate to an embedded
    :class:`PauseGate` constructed with the SAME default telemetry names
    (``astpu_rate_limit_trips_total`` / ``scraper.rate_limit_trip``), and
    an active pause rejects every non-critical request with the pause's
    remaining time as the retry-after hint.
    """

    _seq_lock = threading.Lock()
    _seq = 0

    def __init__(
        self,
        *,
        rate: float = 0.0,
        burst: float | None = None,
        max_inflight: int = 0,
        max_queue: int = 0,
        base_retry_after: float = 0.05,
        ladder: "DegradationLadder | None" = None,
        shed_at: int = PRIORITY_LOW,
        shed_step: str = "shed_low",
        name: str = "",
        clock=time.monotonic,
        pause_counter: str = "astpu_rate_limit_trips_total",
        pause_counter_help: str = "rate-limit circuit-breaker trips",
        pause_event: str = "scraper.rate_limit_trip",
    ):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, self.rate))
        self.max_inflight = int(max_inflight)
        self.max_queue = int(max_queue)
        self.base_retry_after = float(base_retry_after)
        self.ladder = ladder
        self.shed_at = int(shed_at)
        self.shed_step = shed_step
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._refill_at = clock()
        self._inflight = 0
        self._pressure = 0.0
        self.admitted = 0
        self.rejected = 0
        # the embedded circuit breaker — PauseGate semantics byte-stable
        # (trigger extends, never shortens; telemetry names preserved)
        self.gate = PauseGate(
            clock=clock,
            counter=pause_counter,
            counter_help=pause_counter_help,
            event=pause_event,
        )
        with AdmissionController._seq_lock:
            if not name:
                name = f"adm{AdmissionController._seq}"
            AdmissionController._seq += 1
        self.name = name
        self._instrument()

    # -- telemetry ---------------------------------------------------------

    def _instrument(self) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._gen = telemetry.REGISTRY.generation
        g = self.name
        self._m_req = {}  # (outcome, class) → always-on counter
        for outcome in ("admitted", "rejected"):
            for cls in _CLASS_NAMES.values():
                self._m_req[(outcome, cls)] = telemetry.REGISTRY.counter(
                    "astpu_admission_requests_total",
                    "admission decisions, by outcome and priority class",
                    always=True, gate=g, outcome=outcome, **{"class": cls},
                )
        self._m_rej = {}  # reason → always-on counter (lazy: 4 reasons max)
        # every admission series is always-on (the module contract): an
        # incident with ASTPU_TELEMETRY off must still show the hint
        # distribution and the live pressure, not just the reject counts
        self._m_retry_after = telemetry.REGISTRY.histogram(
            "astpu_admission_retry_after_seconds",
            "retry-after hints handed to rejected requests",
            always=True, gate=g,
        )
        telemetry.REGISTRY.gauge_fn(
            "astpu_admission_inflight",
            lambda s: s._inflight,
            owner=self, always=True, gate=g,
            help="admitted requests currently in flight",
        )
        telemetry.REGISTRY.gauge_fn(
            "astpu_admission_pressure",
            lambda s: round(s._pressure, 4),
            owner=self, always=True, gate=g,
            help="most recent pressure observation (0..1+)",
        )

    def _count_reject(self, reason: str) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        c = self._m_rej.get(reason)
        if c is None:
            c = telemetry.REGISTRY.counter(
                "astpu_admission_rejected_total",
                "admission rejects, by reason",
                always=True, gate=self.name, reason=reason,
            )
            self._m_rej[reason] = c
        c.inc()

    # -- PauseGate compatibility surface -----------------------------------

    def trigger(self, duration: float) -> None:
        """Trip the circuit breaker (PauseGate semantics: the deadline
        only ever extends)."""
        self.gate.trigger(duration)

    def remaining(self) -> float:
        return self.gate.remaining()

    def wait(self, sleep=time.sleep, tick: float = 1.0, should_stop=lambda: False) -> None:
        self.gate.wait(sleep=sleep, tick=tick, should_stop=should_stop)

    @property
    def trips(self) -> int:
        return self.gate.trips

    # -- the decision ------------------------------------------------------

    def admit(
        self,
        priority: int = PRIORITY_NORMAL,
        *,
        queue_depth: int | None = None,
    ) -> AdmissionDecision:
        """One admission decision.  Critical requests are always admitted
        (and never consume a token or an in-flight slot — a health probe
        must stay answerable at any depth of overload).  Admitted
        decisions with ``slot=True`` MUST be handed back via
        :meth:`release` when the work completes."""
        _fresh_handles(self)
        now = self._clock()
        priority = int(priority)
        if priority <= PRIORITY_CRITICAL:
            d = AdmissionDecision(True, priority=priority)
            # pressure=None: a critical bypass carries NO load signal —
            # feeding the ladder a synthetic 0.0 here would read as
            # "calm" and reset the dwell timers mid-storm (health pings
            # arrive faster than the dwell, so brownout steps could
            # never arm while the system saturates)
            self._account(d, None)
            return d
        reason = ""
        retry_after = 0.0
        with self._lock:
            # token refill first: pressure reads below see current tokens
            if self.rate > 0:
                self._tokens = min(
                    self.burst,
                    self._tokens + (now - self._refill_at) * self.rate,
                )
                self._refill_at = now
            paused = self.gate.remaining()
            if paused > 0:
                reason, retry_after = "paused", paused
            elif (
                self.ladder is not None
                and priority >= self.shed_at
                and self.ladder.active(self.shed_step)
            ):
                reason, retry_after = "shed", 4 * self.base_retry_after
            elif self.max_inflight > 0 and self._inflight >= self.max_inflight:
                reason = "concurrency"
                retry_after = self.base_retry_after * (
                    1 + self._inflight - self.max_inflight
                )
            elif (
                self.max_queue > 0
                and queue_depth is not None
                and queue_depth >= self.max_queue
            ):
                reason, retry_after = "queue", 2 * self.base_retry_after
            elif self.rate > 0 and self._tokens < 1.0:
                reason = "rate"
                retry_after = (1.0 - self._tokens) / self.rate
            admitted = not reason
            if admitted:
                if self.rate > 0:
                    self._tokens -= 1.0
                self._inflight += 1
            # a SHED reject is the ladder's own output — feeding it back
            # as pressure 1.0 would hold the shed step armed for as long
            # as refused clients keep retrying (a livelock: the step
            # could never exit).  Capacity rejects DO read as full
            # pressure; shed rejects read the raw utilization, which
            # falls as the bucket refills and lets the step disarm.
            pressure = self._pressure_locked(
                queue_depth, rejected=bool(reason) and reason != "shed"
            )
            self._pressure = pressure
        d = AdmissionDecision(
            admitted,
            reason=reason,
            retry_after=round(retry_after, 6),
            priority=priority,
            slot=admitted,
        )
        self._account(d, pressure)
        return d

    def _pressure_locked(self, queue_depth, *, rejected: bool) -> float:
        """Scalar load signal in [0, 1+]: the max utilization across the
        declared limits; a reject reads as full pressure (1.0) so the
        ladder sees sustained refusal even when no single limit exposes
        a smooth utilization."""
        parts = [0.0]
        if self.max_inflight > 0:
            parts.append(self._inflight / self.max_inflight)
        if self.max_queue > 0 and queue_depth is not None:
            parts.append(queue_depth / self.max_queue)
        if self.rate > 0 and self.burst > 0:
            parts.append(1.0 - self._tokens / self.burst)
        if rejected:
            parts.append(1.0)
        return max(parts)

    def _account(self, d: AdmissionDecision, pressure: float) -> None:
        outcome = "admitted" if d.admitted else "rejected"
        cls = _class_name(d.priority)
        c = self._m_req.get((outcome, cls))
        if c is None:  # numeric class outside the named four
            from advanced_scrapper_tpu_torch.obs import telemetry

            c = telemetry.REGISTRY.counter(
                "astpu_admission_requests_total",
                "admission decisions, by outcome and priority class",
                always=True, gate=self.name, outcome=outcome,
                **{"class": cls},
            )
            self._m_req[(outcome, cls)] = c
        c.inc()
        if d.admitted:
            self.admitted += 1
        else:
            self.rejected += 1
            self._count_reject(d.reason)
            self._m_retry_after.observe(d.retry_after)
        if self.ladder is not None and pressure is not None:
            self.ladder.observe(pressure, now=self._clock())

    def release(self, decision: AdmissionDecision | None = None) -> None:
        """Hand back an admitted in-flight slot.  Accepts the decision
        (preferred: critical admissions hold no slot) or nothing (legacy
        call sites that know they were admitted non-critically)."""
        if decision is not None and not decision.slot:
            return
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def pressure(self) -> float:
        with self._lock:
            return self._pressure


# -- the brownout ladder ------------------------------------------------------


@dataclass(frozen=True)
class LadderStep:
    """One declared brownout step: arms when pressure holds at or above
    ``enter_at``, disarms when it holds at or below ``exit_at`` (the gap
    is the hysteresis band; the ladder's dwell time is the other half)."""

    name: str
    enter_at: float
    exit_at: float


#: the default brownout sequence, cheapest reversible degradation first:
#: shrink the dispatch window (less in-flight device memory), skip the
#: rerank tier (precision brownout), probe fewer LSH bands (recall
#: brownout), shed lowest-priority work outright.
DEFAULT_LADDER_STEPS = (
    LadderStep("shrink_window", 0.70, 0.45),
    LadderStep("skip_rerank", 0.85, 0.55),
    LadderStep("fewer_bands", 0.93, 0.65),
    LadderStep("shed_low", 0.98, 0.75),
)


class DegradationLadder:
    """Sustained pressure → ordered, counted, reversible brownout steps.

    ``observe(pressure)`` drives a small state machine: the NEXT step arms
    only after pressure has held at/above its ``enter_at`` for ``dwell_s``
    continuous seconds, and the CURRENT step disarms only after pressure
    has held at/below its ``exit_at`` for ``dwell_s`` — so a load signal
    oscillating faster than the dwell can never flap a step (each
    crossing into the middle band resets both timers).  Steps arm and
    disarm strictly in declaration order: ``level() == k`` means exactly
    ``steps[:k]`` are active.
    """

    _seq_lock = threading.Lock()
    _seq = 0

    def __init__(
        self,
        steps=DEFAULT_LADDER_STEPS,
        *,
        dwell_s: float = 1.0,
        clock=time.monotonic,
        name: str = "",
    ):
        steps = tuple(steps)
        if not steps:
            raise ValueError("a ladder needs at least one step")
        for st in steps:
            if st.exit_at >= st.enter_at:
                raise ValueError(
                    f"step {st.name!r}: exit_at {st.exit_at} must sit BELOW "
                    f"enter_at {st.enter_at} (the hysteresis band)"
                )
        for a, b in zip(steps, steps[1:]):
            if b.enter_at < a.enter_at:
                raise ValueError(
                    f"steps must escalate: {b.name!r} enters at {b.enter_at} "
                    f"below {a.name!r}'s {a.enter_at}"
                )
        self.steps = steps
        self.dwell_s = float(dwell_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0
        self._arm_since: float | None = None   # pressure ≥ next enter_at since
        self._calm_since: float | None = None  # pressure ≤ current exit_at since
        with DegradationLadder._seq_lock:
            if not name:
                name = f"ladder{DegradationLadder._seq}"
            DegradationLadder._seq += 1
        self.name = name
        self._instrument()

    def _instrument(self) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._gen = telemetry.REGISTRY.generation
        telemetry.REGISTRY.gauge_fn(
            "astpu_degraded_step",
            lambda s: s._level,
            owner=self, always=True, ladder=self.name,
            help="active brownout steps (0 = full service)",
        )
        self._m_trans: dict[tuple[str, str], object] = {}
        self._m_effects: dict[str, object] = {}

    def _count_transition(self, step: str, direction: str) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry, trace

        key = (step, direction)
        c = self._m_trans.get(key)
        if c is None:
            c = telemetry.REGISTRY.counter(
                "astpu_degraded_transitions_total",
                "brownout step transitions, by step and direction",
                always=True, ladder=self.name, step=step, dir=direction,
            )
            self._m_trans[key] = c
        c.inc()
        trace.record(
            "event", f"degrade.{direction}", ladder=self.name, step=step,
            level=self._level,
        )

    def count_effect(self, step: str, n: int = 1) -> None:
        """Count work actually degraded under an active step — the
        consumer-side half of the ledger (transitions say the step armed;
        effects say it changed real work)."""
        _fresh_handles(self)
        from advanced_scrapper_tpu_torch.obs import telemetry

        c = self._m_effects.get(step)
        if c is None:
            c = telemetry.REGISTRY.counter(
                "astpu_degraded_effects_total",
                "work items degraded under an active brownout step",
                always=True, ladder=self.name, step=step,
            )
            self._m_effects[step] = c
        c.inc(n)

    # -- state machine -----------------------------------------------------

    def observe(self, pressure: float, now: float | None = None) -> int:
        """Feed one pressure sample; returns the (possibly new) level.
        At most one transition per call — a pressure spike cannot slam
        the ladder to the top in one observation."""
        _fresh_handles(self)
        if now is None:
            now = self._clock()
        entered = exited = None
        with self._lock:
            lvl = self._level
            climbing = (
                lvl < len(self.steps)
                and pressure >= self.steps[lvl].enter_at
            )
            calming = lvl > 0 and pressure <= self.steps[lvl - 1].exit_at
            if climbing:
                self._calm_since = None
                if self._arm_since is None:
                    self._arm_since = now
                elif now - self._arm_since >= self.dwell_s:
                    self._level += 1
                    entered = self.steps[lvl].name
                    self._arm_since = None
            elif calming:
                self._arm_since = None
                if self._calm_since is None:
                    self._calm_since = now
                elif now - self._calm_since >= self.dwell_s:
                    self._level -= 1
                    exited = self.steps[lvl - 1].name
                    self._calm_since = None
            else:
                # the middle band: neither threshold holds — reset both
                # dwell timers (this is what makes oscillation flap-free)
                self._arm_since = None
                self._calm_since = None
            out = self._level
        if entered is not None:
            self._count_transition(entered, "enter")
        if exited is not None:
            self._count_transition(exited, "exit")
        return out

    def level(self) -> int:
        with self._lock:
            return self._level

    def active(self, step_name: str) -> bool:
        """Is the named step currently armed?"""
        with self._lock:
            for i, st in enumerate(self.steps):
                if st.name == step_name:
                    return i < self._level
        return False

    def active_steps(self) -> list[str]:
        with self._lock:
            return [st.name for st in self.steps[: self._level]]

    def status(self) -> dict:
        with self._lock:
            return {
                "ladder": self.name,
                "level": self._level,
                "active": [st.name for st in self.steps[: self._level]],
                "steps": [
                    {"name": st.name, "enter_at": st.enter_at, "exit_at": st.exit_at}
                    for st in self.steps
                ],
            }
