"""Observability of the port (counterpart of ``fedml_tpu/observability``):
round tracing (:mod:`.tracing`), the perf-regression ledger
(:mod:`.perfmon`) and the FLOP count of a local step (:mod:`.costmodel`).
The registry, flight recorder, compile watcher and ``PerfMonitor`` wait
for ROADMAP A16."""
