"""Observability: the reference's ``obs`` core — the metrics registry
(``telemetry``), spans and the flight recorder (``trace``), stage timers and
device-traffic counters (``stages``), the dispatch latency ledger and the
kernel-build sentinel (``devprof``), the step timer, device trace and host
profiler (``profiler``) — the knob half of the perf ledger (``perfdb``),
and the quality plane: decision provenance (``decisions``), the canary
prober (``canary``), the SLO engine (``slo``) and the fleet collector that
scrapes and merges every process's ``/metrics`` (``collector``)."""
