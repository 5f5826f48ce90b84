"""Metrics registry (counterpart of
``fedml_tpu/observability/registry.py``; a copy): counters, gauges and
histograms with labels, behind three primitives:

- ``inc(name, value, **labels)``  -- monotonic counter
- ``set_gauge(name, value, **labels)`` -- last-value gauge
- ``observe(name, value, **labels)``   -- histogram (cumulative buckets)

Names are snake_case and unit-suffixed (``_total``, ``_seconds``,
``_bytes``) with labels for dimensions that fan out -- Prometheus
exposition rules, so :meth:`MetricsRegistry.render_prometheus` is a
straight dump. :meth:`MetricsRegistry.snapshot_into` merges every series
that changed since the previous snapshot into a metrics record (prefix
``m/``).

The pace controller (``resilience/steering.py``) reads its histograms
and writes its gauges here. :func:`get_registry` is None while
observability is off (``observability.enable`` turns it on for a scope),
so every instrumentation point costs one module-global read.
Thread-safe; stdlib-only.
"""

from __future__ import annotations

import math
import re
import threading

#: Default histogram buckets: latency-flavored seconds (also fine for
#: small counts); pass ``buckets=`` to ``observe`` for sized values.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0)

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key, extra=()):
    items = list(key) + list(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt_value(v):
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"  # repr() would render 'nan' -- grammar-invalid
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, bool):
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(int(v))


class _Hist:
    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
        self.total = 0.0
        self.count = 0

    def observe(self, v):
        v = float(v)
        self.total += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsRegistry:
    """Label-aware counter/gauge/histogram store."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"type", "help", "series": {label_key: value|_Hist}}
        self._metrics = {}
        # snapshot_into change tracking: flat key -> last emitted value
        self._last_snapshot = {}

    def _series(self, name, kind, help_text):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r} (Prometheus "
                             "exposition: [a-zA-Z_:][a-zA-Z0-9_:]*)")
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = {"type": kind, "help": help_text,
                                       "series": {}}
        elif m["type"] != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m['type']}, not {kind}")
        return m

    def inc(self, name, value=1, help="", **labels):
        """Monotonic counter add (negative increments are a bug)."""
        if value < 0:
            raise ValueError(f"counter {name!r} increment must be >= 0")
        with self._lock:
            s = self._series(name, "counter", help)["series"]
            key = _label_key(labels)
            s[key] = s.get(key, 0) + value

    def set_gauge(self, name, value, help="", **labels):
        with self._lock:
            s = self._series(name, "gauge", help)["series"]
            s[_label_key(labels)] = value

    def observe(self, name, value, buckets=DEFAULT_BUCKETS, help="",
                **labels):
        with self._lock:
            s = self._series(name, "histogram", help)["series"]
            key = _label_key(labels)
            h = s.get(key)
            if h is None:
                h = s[key] = _Hist(buckets)
            h.observe(value)

    def declare_histogram(self, name, buckets=DEFAULT_BUCKETS, help="",
                          **labels):
        """Pre-register a histogram series with zero observations, so a
        dashboard sees the metric (all-zero buckets, ``_count 0``)
        before -- or even without -- the first event. Idempotent;
        an existing series keeps its buckets and counts."""
        with self._lock:
            s = self._series(name, "histogram", help)["series"]
            s.setdefault(_label_key(labels), _Hist(buckets))

    # -- reads -------------------------------------------------------------
    def get(self, name, **labels):
        """Current value of one series (histograms return (sum, count))."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return None
            v = m["series"].get(_label_key(labels))
            if isinstance(v, _Hist):
                return (v.total, v.count)
            return v

    def histogram_buckets(self, name, **labels):
        """Raw bucket layout + per-bucket counts of one histogram
        series: ``((upper_edges..., inf), (counts...,))``, or None for a
        missing series. The pace controller (resilience/steering.py)
        diffs successive snapshots to quantile the *window* between two
        control decisions -- the cumulative distribution would let a
        long quiet phase mask a regime change."""
        with self._lock:
            m = self._metrics.get(name)
            v = (m["series"].get(_label_key(labels))
                 if m is not None else None)
            if not isinstance(v, _Hist):
                return None
            return (v.buckets + (math.inf,), tuple(v.counts))

    def histogram_quantile(self, name, q, **labels):
        """Approximate quantile of one histogram series from its bucket
        counts: the upper edge of the first bucket whose cumulative count
        reaches ``q * count`` (Prometheus' ``histogram_quantile`` without
        interpolation -- conservative, never under-reports a tail).
        Returns None for a missing/empty series; observations past the
        last bucket return ``inf`` (the tail escaped the layout)."""
        if not 0.0 <= float(q) <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            m = self._metrics.get(name)
            v = (m["series"].get(_label_key(labels))
                 if m is not None else None)
            if not isinstance(v, _Hist) or v.count == 0:
                return None
            target = float(q) * v.count
            cum = 0
            for le, c in zip(v.buckets, v.counts):
                cum += c
                if cum >= target:
                    return float(le)
            return math.inf

    def collect(self):
        """Flat ``{"name{label=v}": value}`` of every scalar series
        (histograms expose ``_sum`` and ``_count``)."""
        out = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                for key, v in sorted(m["series"].items()):
                    lbl = _fmt_labels(key)
                    if isinstance(v, _Hist):
                        out[f"{name}_sum{lbl}"] = v.total
                        out[f"{name}_count{lbl}"] = v.count
                    else:
                        out[f"{name}{lbl}"] = v
        return out

    def snapshot_into(self, record, prefix="m/"):
        """Merge every series that changed since the last snapshot into
        ``record`` (in place; existing keys are never overwritten).
        Called by the metrics sink -- per-round counters surface in the
        round's own metrics record."""
        flat = self.collect()
        for k, v in flat.items():
            if self._last_snapshot.get(k) != v:
                record.setdefault(prefix + k, v)
        self._last_snapshot = flat
        return record

    def render_prometheus(self):
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if m["help"]:
                    lines.append(f"# HELP {name} {_escape(m['help'])}")
                lines.append(f"# TYPE {name} {m['type']}")
                for key, v in sorted(m["series"].items()):
                    if isinstance(v, _Hist):
                        cum = 0
                        for le, c in zip(v.buckets + (math.inf,), v.counts):
                            cum += c
                            lines.append(
                                f"{name}_bucket"
                                f"{_fmt_labels(key, [('le', _fmt_value(float(le)))])}"
                                f" {cum}")
                        lines.append(
                            f"{name}_sum{_fmt_labels(key)} "
                            f"{_fmt_value(v.total)}")
                        lines.append(
                            f"{name}_count{_fmt_labels(key)} {v.count}")
                    else:
                        lines.append(
                            f"{name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def dump_prometheus(self, path):
        with open(path, "w") as f:
            f.write(self.render_prometheus())
        return path


_registry = None


def get_registry():
    """The process-wide registry, or None when observability is off --
    instrumentation points guard with ``if reg is not None``."""
    return _registry


def set_registry(registry):
    global _registry
    prev = _registry
    _registry = registry
    return prev


__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS", "get_registry",
           "set_registry"]
