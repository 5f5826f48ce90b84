"""Runtime performance monitor and the perf-regression ledger
(counterpart of ``fedml_tpu/observability/perfmon.py``).

- :class:`PerfMonitor` feeds the metrics registry with histograms (per
  round wall seconds, per step seconds, client update staleness, buffer
  depth at fold, per report latency whose upper buckets are the
  straggler tail) and a rolling ``fed_rounds_per_hour`` gauge, and owns
  the optional status writer. Disabled cost: one module-global read per
  instrumentation point (``get_perf_monitor() is None``). It also owns
  the ``--xprof_round N`` window: a ``torch.profiler`` capture (host and
  CUDA activity) of exactly round N, written to
  ``<xprof_dir>/xprof_round_<N>/trace.json``, in place of the
  reference's ``jax.profiler`` window; a no-op when the profiler is
  unavailable or busy, and taken once.
- :class:`StatusWriter` writes a throttled, atomic (tmp file +
  ``os.replace``) ``status.json`` snapshot, so an operator can read a
  distributed server's live health without attaching to its logs.
- The ledger: every perf run of the port's bench (``python -m
  fedml_tpu_torch.bench``) appends its record to a JSONL ledger of its
  own, ``bench_results/torch_ledger.jsonl`` by default, so a record
  taken on the card never shares a file with the JAX package's records;
  ``--check-regress`` compares the newest record of each ``metric``
  against the median of its same-metric predecessors with a noise band
  and exits non-zero on regression.

Stdlib only at import time (torch is touched only inside an armed
capture window).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import deque

from fedml_tpu_torch.observability.registry import get_registry
from fedml_tpu_torch.utils import profiling

#: Bucket layouts for the monitor's histograms: latency-flavored seconds
#: for round/report times, tighter sub-second edges for steps, small
#: integer edges for staleness/depth counts.
#:
#: The sub-1 s region is fine-grained: the pace controller's tail
#: tracker reads bucket upper edges as its p50/p90, so roughly 1.4-2x
#: edge ratios below 1 s keep its resolution near its geometric rate
#: limit.
ROUND_BUCKETS = (0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.25, 0.35, 0.5,
                 0.75, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
                 300.0, 600.0)
STEP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0)
COUNT_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096)


class StatusWriter:
    """Merged-field ``status.json`` snapshots, throttled and atomic.

    ``update(**fields)`` merges into the held snapshot and rewrites the
    file when ``force=True`` or ``min_interval_s`` has elapsed since the
    last write. The write is tmp-file + ``os.replace`` so a reader never
    observes a torn JSON document. Thread-safe (handler threads and the
    turnover thread both report)."""

    def __init__(self, path, min_interval_s=2.0):
        self.path = str(path)
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._fields = {"status_version": 1}
        self._last_write = 0.0
        self.writes = 0

    def update(self, force=False, **fields):
        # the file commit happens UNDER the lock: two racing forced
        # updates must not os.replace() out of order and leave the file
        # holding the older snapshot. Writes are decision-rate (or
        # throttled), and this lock guards nothing else, so holding it
        # across one small local write is fine.
        with self._lock:
            self._fields.update(fields)
            now = time.time()
            if not force and now - self._last_write < self.min_interval_s:
                return None
            self._fields["updated_at"] = now
            snapshot = dict(self._fields)
            tmp = self.path + ".tmp"
            try:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(snapshot, f, indent=2, sort_keys=True,
                              default=str)
                os.replace(tmp, self.path)
            except OSError as e:  # health must never kill the run -- and
                # a failed write must not advance the throttle clock or
                # the write counter
                logging.warning("perfmon: status write to %s failed: %s",
                                self.path, e)
                return None
            self._last_write = now
            self.writes += 1
        return self.path


class PerfMonitor:
    """Overhead-bounded run-health monitor (see module docstring).

    Every ``observe_*`` is a bounded-deque append plus, when the metrics
    registry is armed, one histogram observation: O(1) host work, no
    device touches, no effect on any computed value."""

    def __init__(self, status_path=None, xprof_dir=None, xprof_round=None,
                 window=128, status_interval_s=2.0):
        self.xprof_dir = xprof_dir
        self.xprof_round = (int(xprof_round)
                            if xprof_round is not None else None)
        self._xprof_done = False
        self.xprof_path = None
        self.status = (StatusWriter(status_path,
                                    min_interval_s=status_interval_s)
                       if status_path else None)
        self._lock = threading.Lock()
        self._round_ends = deque(maxlen=max(2, int(window)))
        self.rounds = 0
        self.reports = 0

    # -- observations ------------------------------------------------------
    def observe_round(self, seconds, steps=None):
        """One federated round (or distributed round attempt) completed
        in ``seconds``; ``steps`` (true client-steps executed, when the
        caller knows them host-side) additionally feeds the per-step
        histogram and never forces a device sync to learn."""
        now = time.time()
        with self._lock:
            self._round_ends.append(now)
            self.rounds += 1
            rph = self._rph_locked()
        reg = get_registry()
        if reg is not None:
            reg.observe("fed_round_seconds", float(seconds),
                        buckets=ROUND_BUCKETS,
                        help="wall seconds per federated round")
            if steps:
                reg.observe("fed_step_seconds",
                            float(seconds) / max(int(steps), 1),
                            buckets=STEP_BUCKETS,
                            help="wall seconds per executed client step "
                                 "(round time / true steps)")
            if rph is not None:
                reg.set_gauge("fed_rounds_per_hour", rph,
                              help="rolling rounds/hour over the last "
                                   "window of rounds")
        return rph

    def _rph_locked(self):
        """THE rolling rounds/hour formula (callers hold ``_lock``):
        one definition feeds the gauge, ``rounds_per_hour()`` and
        ``record()`` so they can never drift apart."""
        if len(self._round_ends) < 2:
            return None
        span = self._round_ends[-1] - self._round_ends[0]
        if span <= 0:
            return None
        return round(3600.0 * (len(self._round_ends) - 1) / span, 2)

    def rounds_per_hour(self):
        """Current rolling rounds/hour (None until two observations) --
        the same value the ``fed_rounds_per_hour`` gauge holds, exposed
        so both distributed servers can put the live pace in their
        ``status.json`` snapshot on either paradigm (sync rounds and
        async flushes feed the one gauge)."""
        with self._lock:
            return self._rph_locked()

    def observe_report_latency(self, seconds):
        """Seconds from a round attempt's open to one client report --
        the distribution whose upper buckets ARE the straggler tail."""
        with self._lock:
            self.reports += 1
        reg = get_registry()
        if reg is not None:
            reg.observe("fed_report_latency_seconds", float(seconds),
                        buckets=ROUND_BUCKETS,
                        help="round-open to client report; upper buckets "
                             "are the straggler tail")

    def observe_fold(self, staleness, depth):
        """One async buffer fold: staleness + post-fold depth
        distributions (the histogram complement of the point gauges set
        on every fold)."""
        reg = get_registry()
        if reg is not None:
            reg.observe("fed_staleness_levels", int(staleness),
                        buckets=COUNT_BUCKETS,
                        help="staleness (server versions) distribution "
                             "of folded updates")
            reg.observe("fed_buffer_depth_levels", int(depth),
                        buckets=COUNT_BUCKETS,
                        help="buffer depth observed at each fold")

    # -- xprof window ------------------------------------------------------
    def xprof(self, round_idx):
        """Context manager: a ``torch.profiler`` capture of exactly round
        ``xprof_round`` into ``<xprof_dir>/xprof_round_<N>/``. Any other
        round, and a profiler that cannot start (unavailable, a capture
        already running), is a clean no-op; the capture fires at most
        once. With a card, a capture without device events raises
        (``profiling.MissingDeviceTrace``)."""
        if (self.xprof_round is None or self._xprof_done
                or int(round_idx) != self.xprof_round):
            return contextlib.nullcontext()
        return self._xprof_capture(round_idx)

    @contextlib.contextmanager
    def _xprof_capture(self, round_idx):
        out_dir = os.path.join(self.xprof_dir or ".",
                               f"xprof_round_{int(round_idx)}")
        started = False
        try:
            profiling.start_trace(out_dir)
            started = True
        except (ImportError, RuntimeError, ValueError, OSError) as e:
            logging.warning("perfmon: --xprof_round %d capture unavailable "
                            "(%s: %s) -- continuing without it",
                            round_idx, type(e).__name__, e)
        self._xprof_done = True  # one shot, even if the start failed
        try:
            yield
        finally:
            if started:
                try:
                    self.xprof_path = profiling.stop_trace()
                    logging.info("perfmon: xprof trace of round %d -> %s",
                                 round_idx, out_dir)
                except profiling.MissingDeviceTrace:
                    raise
                except (ImportError, RuntimeError, ValueError,
                        OSError) as e:
                    logging.warning("perfmon: xprof stop failed (%s: %s)",
                                    type(e).__name__, e)

    # -- status ------------------------------------------------------------
    def status_update(self, force=False, **fields):
        if self.status is None:
            return None
        return self.status.update(force=force, **fields)

    def record(self, prefix="perf/") -> dict:
        """Cumulative monitor summary for the metrics sink at scope
        exit."""
        with self._lock:
            out = {prefix + "rounds_observed": self.rounds,
                   prefix + "reports_observed": self.reports}
            rph = self._rph_locked()
            if rph is not None:
                out[prefix + "rounds_per_hour"] = rph
        if self.status is not None:
            out[prefix + "status_path"] = self.status.path
            out[prefix + "status_writes"] = self.status.writes
        return out


_monitor = None


def get_perf_monitor():
    """The process-wide monitor, or None when perf monitoring is off --
    instrumentation points guard with ``if mon is not None``."""
    return _monitor


def set_perf_monitor(monitor):
    global _monitor
    prev = _monitor
    _monitor = monitor
    return prev


# -- perf-regression ledger -------------------------------------------------

#: Default noise band for :func:`check_regression`: the newest record
#: regresses when its headline value drops below ``median * (1 - band)``
#: of its same-metric predecessors. 15% absorbs normal host jitter while
#: an injected 2x slowdown lands far outside it.
DEFAULT_REGRESS_BAND = 0.15


def append_ledger(record, path):
    """Append one bench record (dict) to the JSONL ledger at ``path``,
    stamped with the append time. Returns the path."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"ledger_ts": time.time(), **record},
                           sort_keys=True) + "\n")
    return path


def ledger_records(path):
    """All parseable records in the ledger, oldest first (unparseable
    lines are skipped with a warning, never fatal -- the ledger is
    append-only across tool versions)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                logging.warning("ledger %s line %d unparseable -- skipped",
                                path, i + 1)
    return out


def check_regression(path, band=DEFAULT_REGRESS_BAND):
    """Compare each metric's newest record against the median of its
    predecessors (higher-is-better headline ``value``: rounds/hour,
    clients/sec, reports/sec, decode frames/sec).

    Baseline = all EARLIER records with the same ``metric`` string (a
    smoke record never judges a flagship run and vice versa), and EVERY
    distinct metric's latest record is judged -- a run that appends
    several rows cannot shadow one metric's regression behind another's
    newer record. A fresh ledger -- no record at all, or no metric with
    a same-metric predecessor -- passes. Returns ``(ok, detail_dict)``;
    the CLI (``--check-regress``) prints the detail as one
    JSON line and exits non-zero when ``ok`` is False.
    """
    records = ledger_records(path)
    detail = {"check": "perf-regression", "ledger": path,
              "records": len(records), "band": band}
    if not records:
        detail.update({"fresh_ledger": True, "pass": True})
        return True, detail
    by_metric = {}        # metric -> ordered values (numeric), last rec
    for r in records:
        vals, _ = by_metric.setdefault(r.get("metric"), ([], None))
        if isinstance(r.get("value"), (int, float)):
            vals.append(r.get("value"))
        by_metric[r.get("metric")] = (vals, r)
    judged = []
    for metric, (vals, latest) in by_metric.items():
        value = latest.get("value")
        baseline = (vals[:-1] if isinstance(value, (int, float))
                    else vals)
        if not baseline:
            continue  # no same-metric predecessor: fresh for this metric
        ordered = sorted(baseline)
        n = len(ordered)
        median = (ordered[n // 2] if n % 2 else
                  0.5 * (ordered[n // 2 - 1] + ordered[n // 2]))
        threshold = median * (1.0 - band)
        ok = isinstance(value, (int, float)) and value >= threshold
        judged.append({"metric": metric, "latest_value": value,
                       "baseline_records": n, "baseline_median": median,
                       "threshold": round(threshold, 4), "pass": ok})
    if not judged:
        detail.update({"fresh_ledger": True, "pass": True})
        return True, detail
    ok = all(j["pass"] for j in judged)
    # top-level fields mirror the single-metric shape: the (first)
    # failing metric when red, the last-judged metric when green
    head = next((j for j in judged if not j["pass"]), judged[-1])
    detail.update({"fresh_ledger": False, **head, "pass": ok,
                   "metrics": judged})
    return ok, detail


__all__ = ["PerfMonitor", "StatusWriter", "get_perf_monitor",
           "set_perf_monitor", "append_ledger", "ledger_records",
           "check_regression", "DEFAULT_REGRESS_BAND", "ROUND_BUCKETS",
           "STEP_BUCKETS", "COUNT_BUCKETS"]
