"""Deadline-based global pause: the runtime's pause/resume primitive.

The port's copy of the reference's ``runtime/pause.py``.  A
:class:`PauseGate` owns a monotonic deadline behind a lock; a trigger
extends it, never shortens it, and every stage that declared itself
``pausable`` (``runtime/graph.py``) honours it between popping an item and
working on it.  Its default telemetry names are the reference scraper's
rate-limit breaker's; a graph can rename the event and the counter.
"""

from __future__ import annotations

import threading
import time

__all__ = ["PauseGate"]


class PauseGate:
    """Deadline-based global pause: ``trigger`` extends the deadline,
    ``wait`` sleeps it out."""

    def __init__(
        self,
        clock=time.monotonic,
        *,
        counter: str = "astpu_rate_limit_trips_total",
        counter_help: str = "rate-limit circuit-breaker trips",
        event: str = "scraper.rate_limit_trip",
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._until = 0.0
        self.trips = 0
        self._counter_name = counter
        self._counter_help = counter_help
        self._event_name = event

    def trigger(self, duration: float) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry, trace

        with self._lock:
            self._until = max(self._until, self._clock() + duration)
            self.trips += 1
        # a circuit-breaker trip is exactly the rare event the telemetry
        # plane exists for: always counted, and on the flight recorder so
        # a crash dump shows whether the process died paused
        telemetry.event_counter(self._counter_name, self._counter_help).inc()
        trace.record("event", self._event_name, wait_s=duration)

    def remaining(self) -> float:
        with self._lock:
            return max(0.0, self._until - self._clock())

    def wait(
        self, sleep=time.sleep, tick: float = 1.0, should_stop=lambda: False
    ) -> None:
        while not should_stop():
            r = self.remaining()
            if r <= 0:
                return
            sleep(min(tick, r))
