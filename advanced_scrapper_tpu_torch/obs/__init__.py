"""Observability: the reference's ``obs`` core — the metrics registry
(``telemetry``), spans and the flight recorder (``trace``), stage timers and
device-traffic counters (``stages``), the dispatch latency ledger and the
kernel-build sentinel (``devprof``), the step timer, device trace and host
profiler (``profiler``) — and the knob half of the perf ledger
(``perfdb``).  Decisions, canaries and SLOs come with ROADMAP item 14b."""
