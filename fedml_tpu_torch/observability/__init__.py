"""Observability of the port (counterpart of ``fedml_tpu/observability``):
round tracing (:mod:`.tracing`), the metrics registry the pace
controller reads and writes (:mod:`.registry`), the perf-regression
ledger (:mod:`.perfmon`) and the FLOP count of a local step
(:mod:`.costmodel`), and the control plane's flight recorder
(:mod:`.flightrec`), which a caller installs with
``set_flight_recorder``. The switchboard that turns the registry and the
recorder on, the compile watcher and ``PerfMonitor`` wait for ROADMAP
A16."""
