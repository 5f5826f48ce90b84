"""Observability of the port (counterpart of ``fedml_tpu/observability``):
round tracing (:mod:`.tracing`), the metrics registry the pace
controller reads and writes (:mod:`.registry`), the perf-regression
ledger (:mod:`.perfmon`) and the FLOP count of a local step
(:mod:`.costmodel`). The switchboard that turns the registry on, the
flight recorder, compile watcher and ``PerfMonitor`` wait for ROADMAP
A16."""
