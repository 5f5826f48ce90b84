"""Observability of the port (counterpart of ``fedml_tpu/observability``):
round tracing (:mod:`.tracing`), the metrics registry (:mod:`.registry`),
the control plane's flight recorder (:mod:`.flightrec`), the run-health
monitor with its ``status.json`` writer and the perf-regression ledger
(:mod:`.perfmon`, with its ``--xprof_round`` profiler window), the
per-round watcher of kernel-library builds and loads (:mod:`.compilemon`)
and the FLOP cost model (:mod:`.costmodel`).

Everything defaults OFF: the module-level tracer is a no-op, the
registry, recorder, monitor, watcher and cost-model globals are None,
and every instrumentation point guards on that -- a run without the
flags runs no observability code beyond one global read per event and
computes bit-identical results. :func:`enable` flips the switchboard for
a scope and writes the artifacts on exit.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading

from fedml_tpu_torch.observability.costmodel import (CostModel,
                                                     get_cost_model,
                                                     set_cost_model)
from fedml_tpu_torch.observability.flightrec import (FlightRecorder,
                                                     get_flight_recorder,
                                                     set_flight_recorder)
from fedml_tpu_torch.observability.perfmon import (PerfMonitor,
                                                   StatusWriter,
                                                   get_perf_monitor,
                                                   set_perf_monitor)
from fedml_tpu_torch.observability.registry import (MetricsRegistry,
                                                    get_registry,
                                                    set_registry)
from fedml_tpu_torch.observability.tracing import (NOOP_TRACER, NoopTracer,
                                                   Span, SpanContext,
                                                   TRACE_KEY, Tracer,
                                                   get_tracer, set_tracer)


@contextlib.contextmanager
def enable(trace=False, trace_dir=None, flightrec=False, flightrec_dir=None,
           registry=True, compile_events=None, metrics_logger=None,
           flight_capacity=4096, perfmon=False, status_path=None,
           xprof_dir=None, xprof_round=None, cost_model=False):
    """Arm the observability switchboard for a scope (the reference's
    ``enable``, same arguments).

    Yields an object with ``tracer`` / ``registry`` / ``recorder`` /
    ``compile_watcher`` / ``monitor`` / ``cost_model`` attributes (None
    for the pieces left off). On exit: exports ``trace.json`` +
    ``spans.jsonl`` into ``trace_dir``, dumps the registry to
    ``metrics.prom`` (in ``flightrec_dir`` or ``trace_dir`` when either
    is set), pushes the compile watcher's, the cost model's and the perf
    monitor's reports to ``metrics_logger``, forces a final
    ``status.json`` write, and restores the previous globals (scopes
    nest).

    ``compile_events`` defaults to ``trace``. ``perfmon`` arms the
    registry too (its histograms need a sink); ``status_path`` defaults
    to ``<flightrec_dir or trace_dir>/status.json`` when perfmon is on
    and either dir is set; ``xprof_round`` (with ``perfmon``) captures
    that round under ``torch.profiler`` into ``xprof_dir`` (default that
    same directory).
    """
    if compile_events is None:
        compile_events = bool(trace)
    state = _Scope()
    prev_tracer = prev_reg = prev_fr = prev_mon = prev_cm = None
    hooks = None
    if compile_events:
        from fedml_tpu_torch.observability.compilemon import watch_compiles
        state._watch_cm = watch_compiles()
        state.compile_watcher = state._watch_cm.__enter__()
    if trace:
        state.tracer = Tracer()
        prev_tracer = set_tracer(state.tracer)
    if registry and (trace or flightrec or perfmon):
        state.registry = MetricsRegistry()
        prev_reg = set_registry(state.registry)
    if flightrec:
        state.recorder = FlightRecorder(
            out_dir=flightrec_dir or trace_dir or ".",
            capacity=flight_capacity)
        prev_fr = set_flight_recorder(state.recorder)
        hooks = _install_crash_hooks(state.recorder)
    if perfmon:
        out_dir = flightrec_dir or trace_dir
        if status_path is None and out_dir is not None:
            status_path = os.path.join(out_dir, "status.json")
        state.monitor = PerfMonitor(status_path=status_path,
                                    xprof_dir=xprof_dir or out_dir,
                                    xprof_round=xprof_round)
        prev_mon = set_perf_monitor(state.monitor)
    if cost_model:
        state.cost_model = CostModel()
        prev_cm = set_cost_model(state.cost_model)
    try:
        yield state
    finally:
        if state.compile_watcher is not None:
            state._watch_cm.__exit__(None, None, None)
            report = state.compile_watcher.report()
            logging.info("compile watch: %s", report)
            if metrics_logger is not None:
                metrics_logger(report)
        if state.cost_model is not None:
            set_cost_model(prev_cm)
            if metrics_logger is not None and state.cost_model.programs:
                metrics_logger(state.cost_model.record())
        if state.monitor is not None:
            set_perf_monitor(prev_mon)
            state.monitor.status_update(force=True, final=True)
            if state.monitor.status is not None:
                state.status_path = state.monitor.status.path
            if metrics_logger is not None and state.monitor.rounds:
                metrics_logger(state.monitor.record())
        if state.recorder is not None:
            _uninstall_crash_hooks(hooks)
            set_flight_recorder(prev_fr)
        if state.registry is not None:
            set_registry(prev_reg)
            out_dir = flightrec_dir or trace_dir
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)
                state.prom_path = state.registry.dump_prometheus(
                    os.path.join(out_dir, "metrics.prom"))
        if state.tracer is not None:
            set_tracer(prev_tracer)
            if trace_dir is not None:
                os.makedirs(trace_dir, exist_ok=True)
                state.chrome_path = state.tracer.export_chrome(
                    os.path.join(trace_dir, "trace.json"))
                state.spans_path = state.tracer.export_jsonl(
                    os.path.join(trace_dir, "spans.jsonl"))
                logging.info(
                    "fedtrace: %d spans -> %s (open in Perfetto / "
                    "chrome://tracing)", len(state.tracer.finished_spans()),
                    state.chrome_path)


class _Scope:
    """What :func:`enable` yields; also records artifact paths on exit."""

    def __init__(self):
        self.tracer = None
        self.registry = None
        self.recorder = None
        self.compile_watcher = None
        self.monitor = None
        self.cost_model = None
        self.chrome_path = None
        self.spans_path = None
        self.prom_path = None
        self.status_path = None
        self._watch_cm = None


def _install_crash_hooks(recorder):
    """Chain sys/threading excepthooks: an unhandled crash dumps the ring
    before the interpreter's default handling runs."""
    prev_sys = sys.excepthook
    prev_thr = threading.excepthook

    def on_crash(exc_type, exc, tb):
        try:
            recorder.record("crash", error=f"{exc_type.__name__}: {exc}")
            recorder.dump("crash", extra={"error": repr(exc)})
        except OSError:  # the disk is gone too: still run default handling
            pass
        prev_sys(exc_type, exc, tb)

    def on_thread_crash(args):
        try:
            recorder.record("crash", thread_name=getattr(
                args.thread, "name", "?"),
                error=f"{args.exc_type.__name__}: {args.exc_value}")
            recorder.dump("crash", extra={"error": repr(args.exc_value)})
        except OSError:
            pass
        prev_thr(args)

    sys.excepthook = on_crash
    threading.excepthook = on_thread_crash
    return (prev_sys, prev_thr, on_crash, on_thread_crash)


def _uninstall_crash_hooks(hooks):
    if hooks is None:
        return
    prev_sys, prev_thr, on_crash, on_thread_crash = hooks
    # only unwind our own frame: someone may have chained on top of us
    if sys.excepthook is on_crash:
        sys.excepthook = prev_sys
    if threading.excepthook is on_thread_crash:
        threading.excepthook = prev_thr


__all__ = ["Tracer", "NoopTracer", "NOOP_TRACER", "Span", "SpanContext",
           "TRACE_KEY", "get_tracer", "set_tracer",
           "MetricsRegistry", "get_registry", "set_registry",
           "FlightRecorder", "get_flight_recorder", "set_flight_recorder",
           "PerfMonitor", "StatusWriter", "get_perf_monitor",
           "set_perf_monitor",
           "CostModel", "get_cost_model", "set_cost_model", "enable"]
