"""The runtime: the stage graph, the pause gate and the overload plane.

- :class:`StageGraph` / :class:`Edge` (``runtime/graph.py``): one scheduler
  owning the queues of the pipelined dispatcher (``pipeline/dispatch.py``)
  and the device feed (``pipeline/feed.py``); ``pausable`` stages honour a
  :class:`PauseGate` (``runtime/pause.py``).
- :class:`AdmissionController` / :class:`DegradationLadder`
  (``runtime/admission.py``): counted admission decisions with retry-after
  hints, and the brownout ladder the dedup engine honours (``ladder``).
- :class:`Autoscaler` (``runtime/autoscaler.py``): the elastic fleet's
  policy head; it decides from the admission pressure when the shard count
  changes (hysteresis, dwell, cooldown, an SLO gate) and calls the reshard
  it is handed.
- :class:`FanoutPool` (``runtime/graph.py``): a tiny Edge-fed executor for
  bounded parallel fan-out (the index fleet's per-shard RPCs).

Copies of the reference's modules.  Pure Python, no torch: the matcher's
verify-pool workers may import it.
"""

from advanced_scrapper_tpu_torch.runtime.admission import (
    DEFAULT_LADDER_STEPS,
    PRIORITY_CRITICAL,
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    AdmissionController,
    AdmissionDecision,
    DegradationLadder,
    LadderStep,
)
from advanced_scrapper_tpu_torch.runtime.autoscaler import (
    Autoscaler,
    admission_pressure,
)
from advanced_scrapper_tpu_torch.runtime.graph import (
    DONE,
    RETRY,
    Edge,
    EdgeClosed,
    FanoutPool,
    Stage,
    StageGraph,
    live_graphs,
    snapshot_all,
)
from advanced_scrapper_tpu_torch.runtime.pause import PauseGate

__all__ = [
    "DEFAULT_LADDER_STEPS", "DONE", "PRIORITY_CRITICAL", "PRIORITY_HIGH", "PRIORITY_LOW",
    "PRIORITY_NORMAL", "RETRY", "AdmissionController", "AdmissionDecision", "Autoscaler",
    "DegradationLadder", "Edge", "EdgeClosed", "FanoutPool", "LadderStep", "PauseGate", "Stage",
    "StageGraph", "admission_pressure", "live_graphs", "snapshot_all",
]
