"""Elastic rate control: proportional and asymmetric-PID worker scaling.

The reference explored three admission-control designs before settling on
fixed-rate feeding (SURVEY.md §2.4): a P-controller on thread count
(``experiental/local_dynamic.py:196-233``, ``delta = int(0.5·error)`` every
0.5 s) and a full PID with asymmetric accel/decel gains
(``experiental/local_pid.py:42-89,246-279``, accel ``Kp=0.5`` vs decel
``Kp=1.0``, wall-clock integral, 0.8 s cadence, floor 1 / cap MAX_THREADS).
Both are reproduced here as controllers plus an :class:`ElasticWorkerPool`
that grows/shrinks a thread pool toward a target request rate — the same
elastic-scaling capability, usable with any worker body.

The PID keeps the reference's quirk of switching gain sets on the *sign of
the error* (push hard when over target, gently when under), which is the
part that made it the repo's most sophisticated rate design.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

from advanced_scrapper_tpu_torch.obs.stats import StatsTracker


class PController:
    """Proportional thread-count controller (ref local_dynamic.py:196-201)."""

    def __init__(self, setpoint: float, kp: float = 0.5):
        self.setpoint = setpoint
        self.kp = kp

    def compute(self, actual_rate: float) -> float:
        return self.kp * (self.setpoint - actual_rate)


class PIDController:
    """Asymmetric-gain PID (ref local_pid.py:42-89).

    Positive error (below target) uses the accel gains; negative error uses
    the decel gains.  The integral accumulates error·wall-time; the
    derivative is Δerror/Δt.
    """

    def __init__(
        self,
        setpoint: float,
        kp_accel: float = 0.5,
        ki_accel: float = 0.0,
        kd_accel: float = 0.0,
        kp_decel: float = 1.0,
        ki_decel: float = 0.0,
        kd_decel: float = 0.0,
        clock=time.time,
    ):
        self.setpoint = setpoint
        self.kp_accel, self.ki_accel, self.kd_accel = kp_accel, ki_accel, kd_accel
        self.kp_decel, self.ki_decel, self.kd_decel = kp_decel, ki_decel, kd_decel
        self._clock = clock
        self._lock = threading.Lock()
        self._last_time: float | None = None
        self._last_error = 0.0
        self._integral = 0.0

    def compute(self, actual_rate: float) -> float:
        with self._lock:
            now = self._clock()
            error = self.setpoint - actual_rate
            dt = now - self._last_time if self._last_time is not None else 0.0
            de = error - self._last_error
            if error >= 0:
                kp, ki, kd = self.kp_accel, self.ki_accel, self.kd_accel
            else:
                kp, ki, kd = self.kp_decel, self.ki_decel, self.kd_decel
            derivative = de / dt if dt > 0 else 0.0
            self._integral += error * dt
            self._last_time = now
            self._last_error = error
            return kp * error + ki * self._integral + kd * derivative


@dataclass
class PoolLimits:
    min_threads: int = 1    # ref local_pid.py:256 floor
    max_threads: int = 12   # ref local_pid.py:22


class ElasticWorkerPool:
    """Grow/shrink a worker-thread pool toward a target rate.

    ``worker_body(stop_event)`` is the per-thread loop (the engine passes a
    closure over its queues).  The monitor applies the controller output as
    a thread-count delta every ``interval`` seconds, clamped to limits
    (ref local_dynamic.py:203-233 / local_pid.py:246-279).
    """

    def __init__(
        self,
        controller,
        stats: StatsTracker,
        worker_body: Callable[[threading.Event], None],
        *,
        limits: PoolLimits | None = None,
        interval: float = 0.8,  # ref local_pid.py:279
        sleep=time.sleep,
    ):
        self.controller = controller
        self.stats = stats
        self.worker_body = worker_body
        self.limits = limits or PoolLimits()
        self.interval = interval
        self.sleep = sleep
        self._lock = threading.Lock()
        self._workers: list[tuple[threading.Thread, threading.Event]] = []
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self.adjustments: list[int] = []  # observed deltas (for tests/obs)

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._workers)

    def _spawn(self) -> None:
        ev = threading.Event()
        t = threading.Thread(target=self.worker_body, args=(ev,), daemon=True)
        t.start()
        self._workers.append((t, ev))

    def _reap(self) -> None:
        t, ev = self._workers.pop()
        ev.set()
        t.join(timeout=5)

    def step(self) -> int:
        """One control step; returns the applied thread delta."""
        output = self.controller.compute(self.stats.get_actual_rate())
        reaped: list[tuple[threading.Thread, threading.Event]] = []
        with self._lock:
            current = len(self._workers)
            desired = max(
                self.limits.min_threads,
                min(current + int(output), self.limits.max_threads),
            )
            delta = desired - current
            for _ in range(max(0, delta)):
                self._spawn()
            for _ in range(max(0, -delta)):
                reaped.append(self._workers.pop())
        # stop + join outside the lock: a mid-fetch worker must not stall the
        # monitor, size, or stop for up to 5 s per reaped thread
        for _, ev in reaped:
            ev.set()
        for t, _ in reaped:
            t.join(timeout=5)
        self.adjustments.append(delta)
        return delta

    def start(self, initial_threads: int = 1) -> "ElasticWorkerPool":
        with self._lock:
            for _ in range(max(self.limits.min_threads, initial_threads)):
                self._spawn()

        def monitor():
            while not self._stop.is_set():
                self.step()
                self.sleep(self.interval)

        self._monitor = threading.Thread(target=monitor, daemon=True)
        self._monitor.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        with self._lock:
            while self._workers:
                self._reap()
