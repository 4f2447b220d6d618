"""Per-stage times of one corpus, on the host clock and on the card's.

The engine and the rerank tier each keep a :class:`StageClock` of their
last corpus (``last_clock``): its ``seconds`` are the host-clock seconds
of each stage, and on a CUDA device each stage boundary also records an
event on the device's current stream, so :meth:`StageClock.device_ms`
gives the device-clock time between a stage's two boundaries (its device
work, and any time the stream waited on the host).  Reading the device
times waits for the last boundary; recording costs one event per stage.
"""

from __future__ import annotations

import time

import torch

from advanced_scrapper_tpu_torch.obs import stages


class StageClock:
    """``lap(name)`` ends stage ``name`` where the last lap, or the clock's
    start, ended; a name lapped twice adds up.  With ``stage_prefix`` each
    lap's host seconds also land in the always-on stage histogram
    ``astpu_stage_seconds{stage=<prefix><name>}`` (``obs.stages.add``)."""

    def __init__(self, device: torch.device, stage_prefix: str | None = None):
        self.seconds: dict[str, float] = {}
        self._prefix = stage_prefix
        self._t = time.perf_counter()
        self._device = device
        self._events: list[tuple[str, torch.cuda.Event]] = []
        if device.type == "cuda":
            self._record("")

    def _record(self, name: str) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        self._events.append((name, event))

    def lap(self, name: str) -> None:
        t = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + t - self._t
        if self._prefix is not None:
            stages.add(self._prefix + name, t - self._t)
        self._t = t
        if self._events:
            self._record(name)

    def device_ms(self) -> dict[str, float]:
        """Device-clock ms per stage; empty off the card."""
        if not self._events:
            return {}
        self._events[-1][1].synchronize()
        out: dict[str, float] = {}
        for (_, start), (name, end) in zip(self._events, self._events[1:]):
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out
