"""Aggregation leg of a ``RoundProgram`` (counterpart of
``fedml_tpu/program/aggregation.py``; bitwise on the same entries).

:func:`fold_entries_fp64` is the canonical fold: entries sorted by key,
each payload taken to float64 and scaled, summed, then divided by the
total weight late and cast to float32. :func:`aggregate_reports`, the
synchronous partial aggregation over the reporting subset, folds through
it. :class:`AggregationPolicy` holds the knobs of both regimes (sync, or
FedBuff-style buffered async); the buffered aggregator itself waits for
ROADMAP A10. Host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

#: AggregationPolicy.mode values
AGG_SYNC = "sync"
AGG_ASYNC = "async"


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured dicts, lists and tuples
    (numpy or scalar leaves)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


@dataclass(frozen=True)
class AggregationPolicy:
    """Aggregation knobs: ``buffer_k`` (server update every K buffered
    updates), ``staleness_decay`` (an update ``s`` versions stale weighs
    ``(1 + s) ** -a``), ``flush_deadline_s`` (0 = flush only on K),
    ``async_window`` (in-flight chunks of the simulation) and ``mode``
    (``"async"``, the historical meaning of building the policy, or
    ``"sync"``). The field order is the reference's."""

    buffer_k: int = 64
    staleness_decay: float = 0.5
    flush_deadline_s: float = 0.0
    async_window: int = 4
    mode: str = AGG_ASYNC

    @classmethod
    def sync(cls) -> "AggregationPolicy":
        """The barrier-round policy: reports fold at the round boundary
        through :func:`aggregate_reports`, no buffer."""
        return cls(buffer_k=0, staleness_decay=0.0, flush_deadline_s=0.0,
                   async_window=0, mode=AGG_SYNC)

    @property
    def is_async(self) -> bool:
        return self.mode == AGG_ASYNC

    @classmethod
    def from_args(cls, args) -> Optional["AggregationPolicy"]:
        """The async policy ``--async_agg`` describes, or None."""
        if not int(getattr(args, "async_agg", 0) or 0):
            return None
        return cls(
            buffer_k=int(getattr(args, "buffer_k", 64) or 64),
            staleness_decay=float(getattr(args, "staleness_decay", 0.5)),
            flush_deadline_s=float(getattr(args, "flush_deadline", 0.0)
                                   or 0.0),
            async_window=int(getattr(args, "async_window", 4) or 4))


def staleness_weight(staleness, decay) -> float:
    """``(1 + s) ** -decay``; exactly 1.0 at ``s == 0`` or ``decay == 0``."""
    s = max(0, int(staleness))
    if s == 0 or decay == 0:
        return 1.0
    return float((1.0 + s) ** -float(decay))


def fold_entries_fp64(entries) -> tuple:
    """The canonical weighted fold over ``(sort_key, weight, payload,
    scale)`` entries: each contributes ``float64(payload) * scale`` to the
    numerator and ``weight`` to the denominator, in sorted-key order, so
    the result does not depend on arrival order. Returns ``(params_f32,
    weight_total)``. Compressed payloads wait for ROADMAP A12."""
    entries = sorted(entries, key=lambda e: e[0])
    if not entries:
        raise ValueError("weighted fold over an empty entry set "
                         "(abandon/skip instead)")
    total = 0.0
    acc = None
    for _key, weight, payload, scale in entries:
        total += float(weight)
        contrib = _tree_map(
            lambda x: np.asarray(x, np.float64) * float(scale), payload)
        acc = contrib if acc is None else _tree_map(np.add, acc, contrib)
    if total <= 0:
        raise ValueError("weighted fold has zero total weight")
    return _tree_map(lambda x: (x / total).astype(np.float32), acc), total


def aggregate_reports(reports) -> tuple:
    """Weighted average over the reporting subset ``{rank: (num_samples,
    params)}``, renormalised by the reporters' sample total; returns
    ``(params, total_n)``. An empty subset raises."""
    if not reports:
        raise ValueError("aggregate_reports over an empty reporting subset "
                         "(abandon the round instead)")
    total = float(sum(float(reports[r][0]) for r in sorted(reports)))
    if total <= 0:
        raise ValueError("reporting subset has zero total samples")
    params, fold_total = fold_entries_fp64(
        (r, float(n), payload, float(n))
        for r, (n, payload) in reports.items())
    if fold_total != total:
        raise AssertionError("fold total differs from the reporters' sum")
    return params, total


class BufferedAggregator:
    """The FedBuff buffer of the async regime; waits for ROADMAP A10."""

    def __init__(self, policy: AggregationPolicy, fold_fn=None):
        raise NotImplementedError(
            "the buffered async aggregator waits for ROADMAP A10 (async "
            "aggregation)")


__all__ = ["AGG_SYNC", "AGG_ASYNC", "AggregationPolicy",
           "BufferedAggregator", "aggregate_reports", "fold_entries_fp64",
           "staleness_weight"]
