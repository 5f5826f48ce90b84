"""The perf-regression ledger (counterpart of the ledger part of
``fedml_tpu/observability/perfmon.py``; ``PerfMonitor`` and
``StatusWriter`` wait for ROADMAP A16, so :func:`get_perf_monitor` is
None and the control plane's health reports are no-ops, as in the
reference with the monitor off).

Every perf run of the port's bench (``python -m fedml_tpu_torch.bench``)
appends its record to a JSONL ledger of its own,
``bench_results/torch_ledger.jsonl`` by default, so a record taken on
the card never shares a file with the JAX package's records;
``--check-regress`` compares the newest record of each ``metric``
against the median of its same-metric predecessors with a noise band and
exits non-zero on regression.

Stdlib only.
"""

from __future__ import annotations

import json
import logging
import os
import time

#: Default noise band for :func:`check_regression`: the newest record
#: regresses when its headline value drops below ``median * (1 - band)``
#: of its same-metric predecessors. 15% absorbs normal host jitter while
#: an injected 2x slowdown lands far outside it.
DEFAULT_REGRESS_BAND = 0.15


def get_perf_monitor():
    """The process-wide perf monitor: None until ROADMAP A16 ports
    ``PerfMonitor`` -- instrumentation points guard with ``if mon is not
    None``."""
    return None


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


__all__ = ["DEFAULT_REGRESS_BAND", "get_perf_monitor", "append_ledger",
           "ledger_records", "check_regression"]
