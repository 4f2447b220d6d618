"""Observability: the reference's ``obs`` core — the metrics registry
(``telemetry``), spans and the flight recorder (``trace``), stage timers and
device-traffic counters (``stages``), the dispatch latency ledger and the
kernel-build sentinel (``devprof``), the step timer, device trace and host
profiler (``profiler``) — the knob half of the perf ledger (``perfdb``),
and the quality plane: decision provenance (``decisions``), the canary
prober (``canary``), the SLO engine (``slo``) and the Prometheus text
parser it reads a registry through (``collector``).  The fleet collector
comes with ROADMAP item 18d."""
