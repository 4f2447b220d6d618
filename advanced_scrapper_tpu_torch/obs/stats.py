"""Sliding-window throughput statistics.

Same observable surface as the reference's ``StatsTracker``
(``constant_rate_scrapper.py:44-104``): success/fail counts over a rolling
window, actual request rate, cumulative totals.  Implementation differs —
timestamps live in ``deque``\\ s pruned from the left (the reference rebuilds
whole lists on every read) and the window length is injected instead of read
from a module global.  The server-side request/response variant
(``server1.py:26-52``) is :class:`RateStats`.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class StatsTracker:
    def __init__(self, window: float = 10.0, clock=time.time):
        self._window = window
        self._clock = clock
        self._lock = threading.Lock()
        self._success: deque[float] = deque()
        self._fail: deque[float] = deque()
        self._requests: deque[float] = deque()
        self.cumulative_success = 0
        self.cumulative_fail = 0

    def _prune(self, now: float) -> None:
        cutoff = now - self._window
        for dq in (self._success, self._fail, self._requests):
            while dq and dq[0] < cutoff:
                dq.popleft()

    def record_success(self) -> None:
        with self._lock:
            now = self._clock()
            self._success.append(now)
            self._requests.append(now)
            self.cumulative_success += 1

    def record_fail(self) -> None:
        with self._lock:
            now = self._clock()
            self._fail.append(now)
            self._requests.append(now)
            self.cumulative_fail += 1

    def get_stats(self) -> tuple[int, int]:
        """(successes, failures) inside the window."""
        with self._lock:
            self._prune(self._clock())
            return len(self._success), len(self._fail)

    def get_actual_rate(self) -> float:
        """Requests/second over the window (0.0 when idle) — same definition
        as the reference (count / span since oldest request, :85-100)."""
        with self._lock:
            now = self._clock()
            self._prune(now)
            if not self._requests:
                return 0.0
            span = now - self._requests[0]
            return len(self._requests) / span if span > 0 else float(len(self._requests))

    def get_cumulative_stats(self) -> tuple[int, int]:
        with self._lock:
            return self.cumulative_success, self.cumulative_fail


class RateStats:
    """Request/response rate pair (successor of ``server1.py:26-52``)."""

    def __init__(self, window: float = 10.0, clock=time.time):
        self.requests = StatsTracker(window, clock)
        self.responses = StatsTracker(window, clock)

    def record_request(self) -> None:
        self.requests.record_success()

    def record_response(self) -> None:
        self.responses.record_success()

    def rates(self) -> tuple[float, float]:
        return self.requests.get_actual_rate(), self.responses.get_actual_rate()
