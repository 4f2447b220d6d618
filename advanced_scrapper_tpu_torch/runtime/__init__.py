"""The stage-graph runtime: one scheduler owning the queues of the
pipelined dispatcher (``pipeline/dispatch.py``) and the device feed
(``pipeline/feed.py``).  A copy of the reference's ``runtime/graph.py``;
its admission, autoscaler and pause gate come with ROADMAP item 18."""

from advanced_scrapper_tpu_torch.runtime.graph import (
    DONE,
    RETRY,
    Edge,
    EdgeClosed,
    Stage,
    StageGraph,
    live_graphs,
    snapshot_all,
)

__all__ = [
    "DONE", "RETRY", "Edge", "EdgeClosed", "Stage", "StageGraph", "live_graphs",
    "snapshot_all",
]
