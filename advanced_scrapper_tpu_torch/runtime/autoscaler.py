"""Pressure-driven fleet autoscaler — the policy half of elastic resharding.

:class:`Autoscaler` watches the admission plane's pressure signal (the
same 0..1 number the :class:`~.admission.DegradationLadder` brownouts
on, readable fleet-wide via :func:`admission_pressure` over the SLO
engine's registry view) and decides WHEN the fleet should change shard
count; the mechanism — the live N→M cutover — belongs to
``index/fleet.py``'s ``reshard_to`` and is injected as callbacks, so
this module stays a pure, clock-driven state machine (trivially testable
with a fake clock, usable against any resharder).

Flap resistance is the whole design, borrowed step-for-step from the
``DegradationLadder``:

- **enter/exit hysteresis** — scale-out arms at ``out_at`` and the armed
  timer survives dips down to ``out_exit``; scale-in arms at ``in_at``
  and survives rises up to ``in_exit``.  Between the two hold bands sits
  the middle band, which resets BOTH timers — an oscillating load that
  keeps re-crossing a threshold never accumulates dwell.
- **dwell** — a threshold must hold (within its band) for ``dwell_s``
  continuous seconds before a transition fires; at most one transition
  per observation.
- **cooldown** — after ANY transition, ``cooldown_s`` must elapse before
  the next one; a reshard is minutes of background streaming and the
  signal it changes lags, so back-to-back topology changes are noise.
- **SLO gate** — scale-in (capacity REMOVAL) additionally requires the
  SLO engine (when wired) to report healthy; violating SLOs while under
  the low-pressure threshold means something else is wrong, and taking
  capacity away is the one move guaranteed to make it worse.

Layering: runtime sits above ``obs`` only — no index/, net/, tools/
imports (held by ``tests/test_torch_boundary.py``).  The fleet hands its
``reshard_to`` in as a closure; this module never sees a socket.
"""

from __future__ import annotations

import threading
import time

__all__ = [
    "Autoscaler",
    "admission_pressure",
]


def admission_pressure(samples=None) -> float:
    """Fleet-wide pressure signal: the max ``astpu_admission_pressure``
    gauge across every admission gate currently exporting (the fullest
    gate is the one a scale-out must relieve).  ``samples`` is an
    iterable of ``(name, labels, value)`` — pass
    ``SloEngine.registry_samples()`` output, or None to read the live
    registry directly.  0.0 when no gate exports (nothing to react to).
    """
    if samples is None:
        from advanced_scrapper_tpu_torch.obs.slo import SloEngine

        samples = SloEngine.registry_samples()
    best = 0.0
    for name, _labels, value in samples:
        if name == "astpu_admission_pressure":
            best = max(best, float(value))
    return best


def _fresh_handles(obj) -> None:
    from advanced_scrapper_tpu_torch.obs import telemetry

    if obj._gen != telemetry.REGISTRY.generation:
        obj._instrument()


class Autoscaler:
    """Hysteretic scale-out/scale-in decider over a pressure signal.

    ``scale_out(target)`` / ``scale_in(target)`` perform the topology
    change to ``target`` shards (for the fleet: build the new spec and
    call ``reshard_to``); a callback raising propagates to the
    ``observe`` caller and the transition is NOT recorded — the next
    dwell re-attempts.  Targets double going out and halve coming in
    (clamped to ``[min_shards, max_shards]``): ring math makes any N→M
    legal, but power-of-two steps keep successive reshards moving
    disjoint arc sets.

    Thresholds must satisfy
    ``in_at ≤ in_exit < out_exit ≤ out_at`` — two hold bands separated
    by a dead middle band.
    """

    _seq_lock = threading.Lock()
    _seq = 0

    def __init__(
        self,
        shards: int,
        *,
        scale_out,
        scale_in,
        out_at: float = 0.7,
        out_exit: float = 0.4,
        in_at: float = 0.15,
        in_exit: float = 0.3,
        dwell_s: float = 30.0,
        cooldown_s: float = 300.0,
        min_shards: int = 1,
        max_shards: int = 64,
        slo_engine=None,
        clock=time.monotonic,
        name: str | None = None,
    ):
        if not (in_at <= in_exit < out_exit <= out_at):
            raise ValueError(
                f"autoscaler thresholds must order in_at ≤ in_exit < "
                f"out_exit ≤ out_at, got {in_at}/{in_exit}/{out_exit}/{out_at}"
            )
        if not (1 <= min_shards <= shards <= max_shards):
            raise ValueError(
                f"need 1 ≤ min_shards ≤ shards ≤ max_shards, got "
                f"{min_shards}/{shards}/{max_shards}"
            )
        self.shards = int(shards)
        self._scale_out = scale_out
        self._scale_in = scale_in
        self.out_at = float(out_at)
        self.out_exit = float(out_exit)
        self.in_at = float(in_at)
        self.in_exit = float(in_exit)
        self.dwell_s = float(dwell_s)
        self.cooldown_s = float(cooldown_s)
        self.min_shards = int(min_shards)
        self.max_shards = int(max_shards)
        self.slo_engine = slo_engine
        self._clock = clock
        self._lock = threading.Lock()
        self._out_since: float | None = None  # pressure in the out band since
        self._in_since: float | None = None   # pressure in the in band since
        self._cooldown_until: float | None = None
        self._last_pressure = 0.0
        with Autoscaler._seq_lock:
            if not name:
                name = f"autoscaler{Autoscaler._seq}"
            Autoscaler._seq += 1
        self.name = name
        self._instrument()

    # -- telemetry ---------------------------------------------------------

    def _instrument(self) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._gen = telemetry.REGISTRY.generation
        # always-on: topology changes are exactly what an operator audits
        self._m_trans = {
            d: telemetry.REGISTRY.counter(
                "astpu_autoscale_transitions_total",
                "fleet topology changes the autoscaler committed",
                always=True, scaler=self.name, dir=d,
            )
            for d in ("out", "in")
        }
        self._m_blocked = {}
        telemetry.REGISTRY.gauge_fn(
            "astpu_autoscale_pressure",
            lambda s: s._last_pressure,
            owner=self, scaler=self.name,
            help="last pressure sample the autoscaler observed",
        )
        telemetry.REGISTRY.gauge_fn(
            "astpu_autoscale_target_shards",
            lambda s: s.shards,
            owner=self, always=True, scaler=self.name,
            help="shard count the autoscaler currently stands behind",
        )

    def _count_blocked(self, reason: str) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        c = self._m_blocked.get(reason)
        if c is None:
            c = telemetry.REGISTRY.counter(
                "astpu_autoscale_blocked_total",
                "dwell-complete transitions vetoed (cooldown active, SLO "
                "unhealthy, or shard bounds reached)",
                always=True, scaler=self.name, reason=reason,
            )
            self._m_blocked[reason] = c
        c.inc()

    # -- state machine -----------------------------------------------------

    def _slo_healthy(self, slo_ok) -> bool:
        if slo_ok is not None:
            return bool(slo_ok)
        if self.slo_engine is None:
            return True
        try:
            return bool(self.slo_engine.evaluate().get("ok", True))
        except Exception:
            return False  # an unreadable SLO plane never green-lights removal

    def observe(
        self, pressure: float, *, now: float | None = None, slo_ok=None
    ) -> str:
        """Feed one pressure sample; returns ``"out"``, ``"in"``, or
        ``"none"``.  At most one transition per call; a transition's
        callback runs synchronously under the decision (the reshard it
        triggers IS the slow part — callers wanting it off-thread wrap
        the callback)."""
        _fresh_handles(self)
        if now is None:
            now = self._clock()
        pressure = float(pressure)
        fire = None
        blocked = None
        target = self.shards
        with self._lock:
            self._last_pressure = pressure
            if pressure >= self.out_at:
                # the out band: arm (the timer survives dips to out_exit)
                self._in_since = None
                if self._out_since is None:
                    self._out_since = now
            elif pressure <= self.in_at:
                self._out_since = None
                if self._in_since is None:
                    self._in_since = now
            else:
                # hold bands keep an armed timer alive; the middle band
                # resets both — oscillation never accumulates dwell
                if pressure <= self.out_exit:
                    self._out_since = None
                if pressure >= self.in_exit:
                    self._in_since = None
            cooling = (
                self._cooldown_until is not None
                and now < self._cooldown_until
            )
            if (
                self._out_since is not None
                and now - self._out_since >= self.dwell_s
            ):
                if self.shards >= self.max_shards:
                    blocked = "bounds"
                    self._out_since = None
                elif cooling:
                    blocked = "cooldown"
                else:
                    fire = "out"
                    target = min(self.max_shards, self.shards * 2)
            elif (
                self._in_since is not None
                and now - self._in_since >= self.dwell_s
            ):
                if self.shards <= self.min_shards:
                    blocked = "bounds"
                    self._in_since = None
                elif cooling:
                    blocked = "cooldown"
                elif not self._slo_healthy(slo_ok):
                    # capacity removal under an unhealthy SLO is the one
                    # move guaranteed to make the violation worse
                    blocked = "slo"
                else:
                    fire = "in"
                    target = max(self.min_shards, self.shards // 2)
        if blocked is not None:
            self._count_blocked(blocked)
            return "none"
        if fire is None:
            return "none"
        # the callback runs OUTSIDE the lock (it may be minutes of
        # migration); a raise propagates with the timers still armed, so
        # the next dwell re-attempts
        if fire == "out":
            self._scale_out(target)
        else:
            self._scale_in(target)
        with self._lock:
            self.shards = target
            self._out_since = None
            self._in_since = None
            self._cooldown_until = now + self.cooldown_s
        self._m_trans[fire].inc()
        from advanced_scrapper_tpu_torch.obs import trace

        trace.record(
            "event", "autoscale.transition", scaler=self.name,
            dir=fire, shards=target,
        )
        return fire

    def status(self) -> dict:
        """JSON-able view for ``/status`` dashboards."""
        with self._lock:
            now = self._clock()
            return {
                "scaler": self.name,
                "shards": self.shards,
                "pressure": self._last_pressure,
                "out_armed_s": (
                    now - self._out_since
                    if self._out_since is not None else None
                ),
                "in_armed_s": (
                    now - self._in_since
                    if self._in_since is not None else None
                ),
                "cooldown_s": (
                    max(0.0, self._cooldown_until - now)
                    if self._cooldown_until is not None else 0.0
                ),
            }
