"""Compile-event watcher of the port (counterpart of
``fedml_tpu/observability/jaxmon.py``).

Eager PyTorch traces and compiles nothing: the port's only compile
events are the builds and loads of its kernel libraries
(``ops/_build.py``). The watcher listens to them (``add_build_listener``)
and buckets them per federated round at the round loops'
``end_of_round_sync``, as the reference's watcher buckets
``jax.monitoring`` events:

- a *compile* is one library built by ``nvcc``; its seconds are the wall
  seconds of the ``nvcc`` batch it was built in (a batch's compilers run
  at once, so each library of the batch is charged the batch's seconds
  once, not per library);
- a *cache hit* is a library loaded as already built in the build
  directory (``build/``, or ``--compile_cache_dir``); a *cache miss* is
  a library that had to be built first. A warm restart over a built
  directory has misses 0, the reference's gate.

Registry names (when a registry is armed), each standing for the
reference's:

- ``kernel_builds_total`` for ``jax_compiles_total``;
- ``kernel_build_seconds`` (histogram, a batch's wall seconds) for
  ``jax_compile_seconds``;
- ``kernel_loads_total`` (label ``cached``) for ``jax_traces_total``: a
  load is the step the library goes through every time a process first
  runs it, as a trace is the reference's.

The report keeps the reference's keys: ``compile/compiles_per_round``,
``compile/seconds_per_round``, ``compile/traces_per_round`` (loads a
round), the totals, ``compile/cache_hits`` and ``compile/cache_misses``.
Work the round loops mark as between rounds (``off_round_work``: the
periodic evaluation) counts in the totals but in no round's bucket.
Pure measurement: no gate, no effect on any computed value.

One watcher serves a run: :func:`watch_compiles` inside an active
watcher yields that watcher, so the ``enable(compile_events=)`` scope,
the runtime auditor (``analysis/runtime.py``, which reads its per-round
lists) and the warmup all book one event stream once.
"""

from __future__ import annotations

import contextlib
import threading

from fedml_tpu_torch.observability.registry import get_registry
from fedml_tpu_torch.ops import _build

_current = None


def current_watcher():
    return _current


class CompileWatcher:
    """Counts kernel-library builds (with their seconds) and loads,
    bucketed per round by :meth:`mark_round`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active = False
        self._compiles = 0
        self._compile_s = 0.0
        self._traces = 0
        self.rounds = 0
        self.compiles_per_round = []
        self.compile_seconds_per_round = []
        self.traces_per_round = []
        self.total_compiles = 0
        self.total_compile_seconds = 0.0
        self.total_traces = 0
        self.cache_hits = 0
        self.cache_misses = 0
        #: builds and loads booked between rounds (``off_round``)
        self.off_round_compiles = 0
        self.off_round_traces = 0
        self._off_depth = 0

    def _on_event(self, event, **fields):
        if not self._active:
            return
        reg = get_registry()
        with self._lock:
            off = self._off_depth > 0
            if event == "build":
                n, secs = len(fields["names"]), float(fields["seconds"])
                if off:
                    self.off_round_compiles += n
                else:
                    self._compiles += n
                    self._compile_s += secs
                self.total_compiles += n
                self.total_compile_seconds += secs
                self.cache_misses += n
            else:
                if off:
                    self.off_round_traces += 1
                else:
                    self._traces += 1
                self.total_traces += 1
                if fields["cached"]:
                    self.cache_hits += 1
        if reg is None:
            return
        if event == "build":
            reg.inc("kernel_builds_total", n,
                    help="kernel libraries built by nvcc")
            reg.observe("kernel_build_seconds", secs,
                        help="wall seconds of an nvcc batch")
        else:
            reg.inc("kernel_loads_total",
                    help="kernel libraries loaded into the process",
                    cached=str(bool(fields["cached"])).lower())

    @contextlib.contextmanager
    def off_round(self):
        """Book the enclosed work as between rounds instead of charging
        the next round's bucket."""
        with self._lock:
            self._off_depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._off_depth -= 1

    def pending(self):
        """Loads and builds of the round not closed yet."""
        with self._lock:
            return self._traces, self._compiles

    def totals(self):
        """``(builds, build seconds, cache hits, cache misses)`` so far."""
        with self._lock:
            return (self.total_compiles, self.total_compile_seconds,
                    self.cache_hits, self.cache_misses)

    def mark_round(self):
        """Close the current round's bucket (round 0 holds the builds,
        unless a warmup ran them before the loop)."""
        with self._lock:
            self.compiles_per_round.append(self._compiles)
            self.compile_seconds_per_round.append(round(self._compile_s, 4))
            self.traces_per_round.append(self._traces)
            self._compiles = 0
            self._compile_s = 0.0
            self._traces = 0
            self.rounds += 1

    def report(self):
        with self._lock:
            return {
                "compile/rounds": self.rounds,
                "compile/compiles_per_round": list(self.compiles_per_round),
                "compile/seconds_per_round":
                    list(self.compile_seconds_per_round),
                "compile/traces_per_round": list(self.traces_per_round),
                "compile/total_compiles": self.total_compiles,
                "compile/total_seconds":
                    round(self.total_compile_seconds, 4),
                "compile/total_traces": self.total_traces,
                "compile/cache_hits": self.cache_hits,
                "compile/cache_misses": self.cache_misses,
            }

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._active = True
        _build.add_build_listener(self._on_event)
        return self

    def stop(self):
        self._active = False
        _build.remove_build_listener(self._on_event)


@contextlib.contextmanager
def watch_compiles():
    """Arm a :class:`CompileWatcher` for the block and yield it; inside
    an active watcher, yield that one (it stays armed after the block).
    The round loops' ``end_of_round_sync`` marks its rounds."""
    global _current
    if _current is not None:
        yield _current
        return
    watcher = CompileWatcher().start()
    prev, _current = _current, watcher
    try:
        yield watcher
    finally:
        _current = prev
        watcher.stop()


__all__ = ["CompileWatcher", "watch_compiles", "current_watcher"]
