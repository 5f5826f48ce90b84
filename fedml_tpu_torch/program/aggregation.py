"""Aggregation leg of a ``RoundProgram`` (counterpart of
``fedml_tpu/program/aggregation.py``; bitwise on the same entries).

:func:`fold_entries_fp64` is the canonical fold: entries sorted by key,
each payload taken to float64 and scaled, summed, then divided by the
total weight late and cast to float32. :func:`aggregate_reports`, the
synchronous partial aggregation over the reporting subset, folds through
it. :class:`AggregationPolicy` holds the knobs of both regimes (sync, or
FedBuff-style buffered async), and :class:`BufferedAggregator` is the
async regime's buffer: staleness-weighted updates held until ``buffer_k``
clients (or the end of a round) flush them through the same fold. Host
numpy.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from fedml_tpu_torch.observability.registry import get_registry
from fedml_tpu_torch.observability.tracing import get_tracer

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
    weight_total)``.

    A payload may be a :class:`~fedml_tpu_torch.compression.wire.
    CompressedUpdate` (an encoded delta and the base it is relative to):
    its decoded delta accumulates sparsely (O(k) a topk report) in sorted
    entry order, and each distinct base is added once, scaled by its
    entries' scale sum, in sorted ``base_key`` order. The combine order:
    the dense entries, then the bases, then the delta accumulator."""
    from fedml_tpu_torch.compression.wire import CompressedUpdate

    entries = sorted(entries, key=lambda e: e[0])
    if not entries:
        raise ValueError("weighted fold over an empty entry set "
                         "(abandon/skip instead)")
    total = 0.0
    acc = None          # dense contributions (fp64 tree)
    cacc = None         # compressed-delta contributions ({name: fp64})
    base_acc = {}       # base_key -> [scale_sum, base params]
    for _key, weight, payload, scale in entries:
        total += float(weight)
        if isinstance(payload, CompressedUpdate):
            cacc = payload.fold_delta(cacc, float(scale))
            slot = base_acc.setdefault(payload.base_key,
                                       [0.0, payload.base])
            slot[0] += float(scale)
            continue
        contrib = _tree_map(
            lambda x: np.asarray(x, np.float64) * float(scale), payload)
        acc = contrib if acc is None else _tree_map(np.add, acc, contrib)
    for bk in sorted(base_acc):
        scale_sum, base = base_acc[bk]
        bcontrib = _tree_map(
            lambda x: np.asarray(x, np.float64) * float(scale_sum), base)
        acc = bcontrib if acc is None else _tree_map(np.add, acc, bcontrib)
    if cacc is not None:
        acc = cacc if acc is None else _tree_map(np.add, acc, cacc)
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


@dataclass(frozen=True)
class FlushResult:
    """One server update produced by :meth:`BufferedAggregator.flush`."""

    params: dict          # f32 tree (the fold's output)
    weight: float         # the fold's denominator (after staleness)
    version: int          # server version AFTER this flush
    contributors: tuple   # entry keys folded (ranks or chunk ordinals)
    clients: int          # client updates those entries represent
    reason: str           # "buffer_k" | "deadline" | "drain" | "peer_lost"
    max_staleness: int


class BufferedAggregator:
    """Thread-safe staleness-weighted update buffer (FedBuff).

    ``fold`` takes a per-client report (``weight`` its sample count, the
    payload its params) or a pre-weighted partial sum from the streaming
    engine (``preweighted=True``: the payload is ``sum_i n_i * p_i`` over
    ``clients`` members and ``weight`` their ``sum_i n_i``). Entries stay
    until :meth:`flush` folds them in sorted-key order through
    :func:`fold_entries_fp64` (or the ``fold_fn`` handed in: the robust
    leg's fold, same contract), so the flushed bytes do not depend on
    arrival order. Folding a key again overwrites it (the newer update
    trained on fresher params) and is counted."""

    def __init__(self, policy: AggregationPolicy, fold_fn=None):
        self.policy = policy
        self._fold_fn = fold_fn
        self._lock = threading.Lock()
        self._entries = {}        # key -> (weight, payload, scale)
        self._entry_clients = {}  # key -> client count
        self._entry_staleness = {}
        self.version = 0
        self.counters = {"folds": 0, "flushes": 0, "drain_flushes": 0,
                         "deadline_flushes": 0, "overwrites": 0,
                         "clients_folded": 0, "max_staleness": 0,
                         "depth_peak": 0}

    @property
    def depth(self) -> int:
        """Distinct buffered entries (the ``fed_buffer_depth`` gauge)."""
        with self._lock:
            return len(self._entries)

    def clients_buffered(self) -> int:
        with self._lock:
            return sum(self._entry_clients.values())

    def fold(self, key, weight, payload, staleness=0, clients=1,
             preweighted=False) -> int:
        """Buffer one update; returns the distinct-entry depth after it.
        ``staleness`` is the server versions elapsed since the update's
        model was issued; the entry's weight (and a pre-weighted
        partial's numerator scale) is multiplied by
        :func:`staleness_weight`."""
        with get_tracer().span("buffer-fold", staleness=int(staleness),
                               clients=int(clients)) as sp:
            with self._lock:
                depth = self._fold_locked(key, weight, payload, staleness,
                                          clients, preweighted)
            sp.set(depth=depth)
        self._note_fold(staleness, depth)
        return depth

    def _fold_locked(self, key, weight, payload, staleness, clients,
                     preweighted):
        """One entry into the buffer; the caller holds ``_lock``."""
        sw = staleness_weight(staleness, self.policy.staleness_decay)
        w = float(weight) * sw
        scale = sw if preweighted else w
        if key in self._entries:
            self.counters["overwrites"] += 1
        else:
            self.counters["clients_folded"] += int(clients)
        self._entries[key] = (w, payload, scale)
        self._entry_clients[key] = int(clients)
        self._entry_staleness[key] = int(staleness)
        self.counters["folds"] += 1
        self.counters["max_staleness"] = max(
            self.counters["max_staleness"], int(staleness))
        depth = len(self._entries)
        self.counters["depth_peak"] = max(self.counters["depth_peak"],
                                          depth)
        return depth

    @staticmethod
    def _note_fold(staleness, depth):
        reg = get_registry()
        if reg is not None:
            reg.set_gauge("fed_buffer_depth", depth,
                          help="distinct updates buffered awaiting flush")
            reg.set_gauge("fed_update_staleness", int(staleness),
                          help="staleness (server versions) of the last "
                               "folded update")

    def _threshold(self, target):
        """``buffer_k`` capped by ``target`` (at least 1)."""
        k = self.policy.buffer_k
        if target is not None:
            k = min(k, int(target))
        return max(1, k)

    def fold_many(self, entries, ready_target=None):
        """Per-client reports ``(key, weight, payload, staleness)`` under
        one lock, stopping after the entry that brings the buffered
        client count to the flush threshold (:meth:`ready`'s rule).
        Returns ``(consumed, depth)``: the caller flushes and comes back
        with the rest. Bitwise the same as folding one at a time."""
        k = self._threshold(ready_target)
        consumed, depth, noted = 0, 0, []
        with get_tracer().span("buffer-fold", batch=len(entries)) as sp:
            with self._lock:
                for key, weight, payload, staleness in entries:
                    depth = self._fold_locked(key, weight, payload,
                                              staleness, 1, False)
                    noted.append((staleness, depth))
                    consumed += 1
                    if sum(self._entry_clients.values()) >= k:
                        break
            sp.set(depth=depth, consumed=consumed)
        for staleness, d in noted:
            self._note_fold(staleness, d)
        return consumed, depth

    def ready(self, target=None) -> bool:
        """True when the buffered client count reaches ``buffer_k``,
        capped by ``target`` (e.g. the clients still alive) so a buffer
        that can never fill does not stall."""
        k = self._threshold(target)
        with self._lock:
            return sum(self._entry_clients.values()) >= k

    def flush(self, reason="buffer_k") -> FlushResult:
        """Fold and clear the buffer, bump the server version."""
        with self._lock:
            if not self._entries:
                raise ValueError("flush of an empty update buffer")
            entries = [(k, w, p, s)
                       for k, (w, p, s) in self._entries.items()]
            clients = sum(self._entry_clients.values())
            max_stale = max(self._entry_staleness.values())
            self._entries, self._entry_clients = {}, {}
            self._entry_staleness = {}
            self.version += 1
            version = self.version
            self.counters["flushes"] += 1
            if reason == "deadline":
                self.counters["deadline_flushes"] += 1
            elif reason == "drain":
                self.counters["drain_flushes"] += 1
        with get_tracer().span("buffer-flush", reason=reason,
                               entries=len(entries), clients=clients,
                               version=version):
            params, weight = (self._fold_fn or fold_entries_fp64)(entries)
        reg = get_registry()
        if reg is not None:
            reg.set_gauge("fed_buffer_depth", 0,
                          help="distinct updates buffered awaiting flush")
            reg.inc("fed_buffer_flushes_total",
                    help="server updates produced by the async buffer",
                    reason=reason)
        return FlushResult(params=params, weight=weight, version=version,
                           contributors=tuple(e[0] for e in entries),
                           clients=clients, reason=reason,
                           max_staleness=max_stale)

    def record(self, prefix="async/") -> dict:
        """The cumulative counters as a round-record fragment, with the
        server version and the current buffer depth."""
        with self._lock:
            out = {prefix + k: v for k, v in self.counters.items()}
            out[prefix + "version"] = self.version
            out[prefix + "buffer_depth"] = len(self._entries)
        return out


__all__ = ["AGG_SYNC", "AGG_ASYNC", "AggregationPolicy",
           "BufferedAggregator", "FlushResult", "aggregate_reports",
           "fold_entries_fp64", "staleness_weight"]
