"""Runtime compile/transfer auditor and the concurrency race sanitizer
(counterpart of ``fedml_tpu/analysis/runtime.py``).

Eager PyTorch never retraces: what the reference's auditor catches as
recompilation (a shape that changes every round) costs nothing extra
here, and the port's only compile events are the builds and loads of
its kernel libraries (``ops/_build.py``). The compile watcher
(``observability/compilemon.py``) books those per federated round at
the round loops' single end-of-round sync
(``fedml_tpu_torch.utils.profiling.end_of_round_sync``); :func:`audit`
arms it (or joins the run's) and reports its rounds under the
reference's keys: a *retrace* is a library loaded into the process, a
*compile* a library built by ``nvcc``. A healthy run loads its libraries
in round 0 (or in a warmup before it) and never again:
``audit/retraces_per_round`` is ``[n, 0, 0, ...]``.

The transfer guard keeps the reference's meaning: the end-of-round sync
must not move state between host and device. Each state leaf that is
not on the run's device at the sync is counted as a violation; nothing
is raised, the run continues.

The second half is the **race sanitizer** (:func:`race_audit`,
``--race_audit``): inside the context the control plane's lock factories
(``fedml_tpu_torch.core.locks``) return instrumented locks that record,
per thread, the order in which lock creation sites nest (lock-order
cycles) and whether a *state* lock is held when execution reaches a
blocking chokepoint (the TCP frame send/recv helpers are patched for the
audit's lifetime; ``io_lock`` families are exempt by declared purpose).
"""

from __future__ import annotations

import contextlib
import logging
import threading

import numpy as np
import torch

from fedml_tpu_torch.analysis.concurrency import find_lock_cycles
from fedml_tpu_torch.core.locks import creation_site as _creation_site
from fedml_tpu_torch.observability.compilemon import watch_compiles

_current = None


def current_auditor():
    """The auditor armed by the innermost active :func:`audit`, or None."""
    return _current


def state_leaves(tree):
    """The tensors and arrays of a state tree (nested dicts, lists and
    tuples), in order."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in state_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in state_leaves(v)]
    return []


def leaf_device(x):
    """The device a leaf lives on: a numpy array lives on the host."""
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def on_device(x, device):
    """Whether leaf ``x`` lives on ``device`` (a device named without an
    index, ``cuda``, matches any of its type)."""
    d = leaf_device(x)
    return d.type == device.type and (device.index is None or d.index is None
                                      or d.index == device.index)


def state_device(state):
    """The device of the first tensor of ``state`` (the host without
    one)."""
    leaves = state_leaves(state)
    return leaf_device(leaves[0]) if leaves else torch.device("cpu")


def synchronize(device):
    """Wait for the device's queued work (nothing to wait for on the
    host)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RuntimeAuditor:
    """Reads the rounds of a compile watcher (kernel-library loads as
    "retraces", builds as "compiles") from the round it starts at, and
    counts transfer-guard violations."""

    def __init__(self, watcher):
        self.watcher = watcher
        self.transfer_guard_violations = 0
        self._first = watcher.rounds
        self._off0 = (watcher.off_round_traces, watcher.off_round_compiles)
        self._final = None

    @property
    def rounds(self):
        return self.watcher.rounds - self._first

    @property
    def retraces_per_round(self):
        return self.watcher.traces_per_round[self._first:]

    @property
    def compiles_per_round(self):
        return self.watcher.compiles_per_round[self._first:]

    def mark_round(self):
        """Close the current round's bucket."""
        self.watcher.mark_round()

    def check_transfers(self, state, device):
        """Count (and log) each leaf of ``state`` not on ``device``;
        returns this call's count."""
        off = [x for x in state_leaves(state) if not on_device(x, device)]
        if off:
            self.transfer_guard_violations += len(off)
            logging.warning("audit: %d state leaves off %s at the "
                            "end-of-round sync (first on %s)", len(off),
                            device, leaf_device(off[0]))
        return len(off)

    def report(self):
        if self._final is not None:
            return dict(self._final)
        w = self.watcher
        pending_traces, pending_compiles = w.pending()
        return {
            "audit/rounds": self.rounds,
            "audit/retraces_per_round": list(self.retraces_per_round),
            "audit/compiles_per_round": list(self.compiles_per_round),
            # the headline number: libraries loaded after round 0
            "audit/steady_state_retraces": sum(self.retraces_per_round[1:]),
            # activity outside any round bucket (periodic/final eval,
            # teardown), kept apart so it never passes for a round's
            "audit/trailing_traces":
                w.off_round_traces - self._off0[0] + pending_traces,
            "audit/trailing_compiles":
                w.off_round_compiles - self._off0[1] + pending_compiles,
            "audit/transfer_guard_violations":
                self.transfer_guard_violations,
        }


@contextlib.contextmanager
def audit(metrics_logger=None, enabled=True):
    """Audit the enclosed run; yields the :class:`RuntimeAuditor` (or None
    when ``enabled`` is falsy, so ``--audit`` wires straight through).

    On exit the report is pushed to ``metrics_logger`` (any callable
    taking a dict) and logged. Round bucketing needs the round loop to
    pass through ``end_of_round_sync``; activity outside any round is
    reported as trailing counts."""
    global _current
    if not enabled:
        yield None
        return
    with watch_compiles() as watcher:
        auditor = RuntimeAuditor(watcher)
        prev, _current = _current, auditor
        try:
            yield auditor
        finally:
            _current = prev
            auditor._final = report = auditor.report()
            logging.info("runtime audit: %s", report)
            if metrics_logger is not None:
                metrics_logger(report)
            _report_to_registry(report)


# -- race sanitizer -------------------------------------------------------

class _AuditedLock:
    """Instrumented lock handed out by the lock factories while a
    :func:`race_audit` is active. Semantics are exactly the wrapped
    ``threading`` primitive's; acquisition and release also maintain the
    auditor's per-thread held stack."""

    __slots__ = ("_inner", "_auditor", "kind", "site")

    def __init__(self, auditor, kind, reentrant, site):
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._auditor = auditor
        self.kind = kind
        self.site = site

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._auditor._acquired(self)
        return ok

    def release(self):
        self._auditor._released(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        # the wrapped primitive's surface (``locked()`` exists on Lock
        # always, on RLock from 3.12): hasattr() behaves as outside an
        # audit
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)


class RaceAuditor:
    """Records lock-acquisition order and held-while-blocking events for
    every lock created through the factories while active."""

    def __init__(self):
        self._tls = threading.local()
        self._mu = threading.Lock()  # deliberately uninstrumented
        self._active = True
        self.locks_created = 0
        self.acquisitions = 0
        self.order_edges = {}         # (site_a, site_b) -> count
        self.held_while_blocking = []  # (label, (lock sites...), thread)

    # -- factory hook (fedml_tpu_torch.core.locks) -------------------------
    def make_lock(self, kind, reentrant):
        with self._mu:
            self.locks_created += 1
        return _AuditedLock(self, kind, reentrant, _creation_site())

    def _held(self):
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _acquired(self, lock):
        held = self._held()
        if self._active:
            with self._mu:
                self.acquisitions += 1
                for h in held:
                    if h.site != lock.site:
                        key = (h.site, lock.site)
                        self.order_edges[key] = \
                            self.order_edges.get(key, 0) + 1
        held.append(lock)

    def _released(self, lock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    # -- chokepoints -------------------------------------------------------
    def blocking(self, label):
        """Called by the patched blocking chokepoints: any *state* lock
        held here is a held-while-blocking violation (io locks exist to
        be held across exactly this)."""
        if not self._active:
            return
        held = [l for l in self._held() if l.kind == "state"]
        if held:
            event = (label, tuple(sorted({l.site for l in held})),
                     threading.current_thread().name)
            with self._mu:
                self.held_while_blocking.append(event)
            from fedml_tpu_torch.observability.flightrec import (
                get_flight_recorder)
            fr = get_flight_recorder()
            if fr is not None:
                fr.record("held_while_blocking", label=event[0],
                          locks=list(event[1]), thread_name=event[2])
            logging.warning("race audit: %s while holding state lock(s) "
                            "%s on %s", *event)

    # -- reporting ---------------------------------------------------------
    def lock_order_cycles(self):
        """Site-level cycles in the observed acquisition-order graph."""
        return [cycle + [cycle[0]]
                for cycle in find_lock_cycles(self.order_edges)]

    def report(self):
        return {
            "race/locks_created": self.locks_created,
            "race/acquisitions": self.acquisitions,
            "race/order_edges": sorted(
                f"{a} -> {b}" for (a, b) in self.order_edges),
            "race/lock_order_cycles": self.lock_order_cycles(),
            "race/held_while_blocking": list(self.held_while_blocking),
        }


@contextlib.contextmanager
def race_audit(enabled=True, metrics_logger=None):
    """Arm the race sanitizer: locks created through the factories inside
    this context are instrumented, and the TCP frame helpers are patched
    to report blocking points. Yields the :class:`RaceAuditor` (or None
    when disabled); pushes the report to ``metrics_logger`` on exit."""
    if not enabled:
        yield None
        return
    from fedml_tpu_torch.core import locks as _locks
    from fedml_tpu_torch.core.comm import tcp as _tcp
    auditor = RaceAuditor()
    prev = _locks._auditor
    _locks._auditor = auditor
    orig_send, orig_recv = _tcp._send_frame, _tcp._recv_frame

    def _send(sock, payload):
        auditor.blocking("tcp._send_frame")
        return orig_send(sock, payload)

    def _recv(sock):
        auditor.blocking("tcp._recv_frame")
        return orig_recv(sock)

    _tcp._send_frame, _tcp._recv_frame = _send, _recv
    try:
        yield auditor
    finally:
        _locks._auditor = prev
        _tcp._send_frame, _tcp._recv_frame = orig_send, orig_recv
        auditor._active = False  # long-lived managers stop recording
        report = auditor.report()
        logging.info("race audit: %s", report)
        if metrics_logger is not None:
            metrics_logger(report)
        _report_to_registry(report)


def _report_to_registry(report):
    """Mirror an auditor report's scalar totals into the metrics registry
    when one is armed, so audit results land in ``metrics.prom``."""
    from fedml_tpu_torch.observability.registry import get_registry
    reg = get_registry()
    if reg is None:
        return
    for key, val in report.items():
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            if isinstance(val, list):
                reg.set_gauge("audit_events",
                              len(val), help="auditor event-list lengths",
                              event=key.split("/", 1)[-1])
            continue
        name = "audit_" + key.split("/", 1)[-1]
        reg.set_gauge(name, val, help="runtime auditor total")


__all__ = ["RuntimeAuditor", "audit", "current_auditor",
           "RaceAuditor", "race_audit", "find_lock_cycles",
           "state_leaves", "state_device", "synchronize"]
