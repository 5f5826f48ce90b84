"""Structured span tracing for the federated round lifecycle
(counterpart of ``fedml_tpu/observability/tracing.py``, kept as its own
copy: the port imports nothing of the JAX package).

Dapper-style distributed tracing (Sigelman et al., 2010) scaled down to
this control plane: every span carries a ``trace_id`` shared by the whole
round tree and a ``parent_id`` naming the span it hangs under;
parentage flows through a thread-local context stack. Finished spans
export as Chrome trace events (Perfetto / ``chrome://tracing``,
:meth:`Tracer.export_chrome`), and :meth:`Tracer.durations_by_name`
feeds the bench's per-phase times. The reference's cross-process context
propagation (``inject``/``extract``/``remote_context``) and JSONL export
are left out until a transport that carries the context is ported.

Disabled-path contract: the module-level tracer defaults to
:data:`NOOP_TRACER`, whose spans are a single shared no-op context
manager -- a run without a tracer executes no tracing code beyond one
global read per instrumentation point.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time


def _new_id(nbytes=8):
    return os.urandom(nbytes).hex()


class SpanContext:
    """The propagatable half of a span: what children need to stitch."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id


class Span:
    """One timed phase. Created by :meth:`Tracer.start_span` (detached --
    for cross-thread begin/end like the server's per-attempt round span)
    or :meth:`Tracer.span` (context manager, thread-local parentage)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "t0", "t1", "thread", "_tracer")

    def __init__(self, tracer, name, trace_id, parent_id, attrs):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0 = tracer._now()
        self.t1 = None
        self.thread = threading.current_thread().name

    @property
    def context(self):
        return SpanContext(self.trace_id, self.span_id)

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def end(self):
        """Idempotent: a span double-ended by a racing path records once
        (the check-and-set runs under the tracer's lock -- two genuinely
        concurrent end() calls record exactly one span)."""
        self._tracer._finish(self, self._tracer._now())


class _SpanScope:
    """Context manager pairing a span with the thread-local stack."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer, span):
        self._tracer = tracer
        self.span = span

    def __enter__(self):
        self._tracer._push(self.span.context)
        return self.span

    def __exit__(self, *exc):
        self._tracer._pop()
        self.span.end()
        return False


class Tracer:
    """Collects spans; thread-safe; exports Chrome trace-event JSON.

    Args:
      max_spans: retention bound -- the oldest spans are dropped beyond it
        (a multi-hour run must not grow host memory without bound). The
        drop count is reported in the Chrome export's metadata.
    """

    enabled = True

    def __init__(self, max_spans=200_000):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._spans = []
        self._dropped = 0
        self._max = int(max_spans)
        #: epoch anchor: span timestamps are epoch-based microseconds so
        #: traces from different processes of one job align in Perfetto
        self._t0_epoch = time.time()
        self._t0_perf = time.perf_counter()

    def _now(self):
        # monotonic progression, epoch-anchored (us)
        return (self._t0_epoch
                + (time.perf_counter() - self._t0_perf)) * 1e6

    # -- thread-local context stack ---------------------------------------
    def _stack(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _push(self, ctx):
        self._stack().append(ctx)

    def _pop(self):
        stack = self._stack()
        if stack:
            stack.pop()

    def current(self):
        """The innermost active context on this thread (or None)."""
        stack = self._stack()
        return stack[-1] if stack else None

    # -- span creation -----------------------------------------------------
    def start_span(self, name, parent=None, root=False, **attrs):
        """Detached span: NOT pushed on the thread-local stack, so it can
        be ended from another thread (the FSM round span's lifecycle).
        ``parent`` is a :class:`SpanContext`; None falls back to the
        calling thread's current context; ``root=True`` forces a fresh
        trace even when a context is active (the server's per-attempt
        round spans are roots regardless of which handler thread opened
        them)."""
        ctx = None if root else (
            parent if parent is not None else self.current())
        if ctx is not None:
            return Span(self, name, ctx.trace_id, ctx.span_id, attrs)
        return Span(self, name, _new_id(), None, attrs)

    def span(self, name, parent=None, root=False, **attrs):
        """Context-managed span parented on this thread's current context
        (or ``parent`` when given); children opened inside see it."""
        return _SpanScope(self, self.start_span(name, parent=parent,
                                                root=root, **attrs))

    def _finish(self, span, t1):
        with self._lock:
            if span.t1 is not None:
                return  # racing double-end: first one won
            span.t1 = t1
            if len(self._spans) >= self._max:
                # drop oldest half in one amortized cut (per-append pops
                # would be quadratic)
                self._spans = self._spans[len(self._spans) // 2:]
                self._dropped += self._max - len(self._spans)
            self._spans.append(span)

    # -- introspection / export --------------------------------------------
    def finished_spans(self):
        with self._lock:
            return list(self._spans)

    def durations_by_name(self):
        """``{span name: [durations in seconds]}`` -- the bench's
        per-phase attribution feed."""
        out = {}
        for s in self.finished_spans():
            out.setdefault(s.name, []).append(
                ((s.t1 or s.t0) - s.t0) / 1e6)
        return out

    def export_chrome(self, path):
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing).

        Every finished span becomes a balanced B/E pair; pid groups by
        span thread name is not enough for cross-rank trees, so the trace
        and span ids ride in ``args`` and ``rank`` attrs (when present)
        name the track."""
        events = []
        threads = {}
        for s in self.finished_spans():
            tid = threads.setdefault(s.thread, len(threads))
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            args.update({str(k): _jsonable(v) for k, v in s.attrs.items()})
            common = {"name": s.name, "cat": "fed", "pid": 0, "tid": tid}
            events.append({"ph": "B", "ts": s.t0, "args": args, **common})
            events.append({"ph": "E", "ts": s.t1 or s.t0, **common})
        meta = [{"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                 "args": {"name": tname}}
                for tname, tid in sorted(threads.items(), key=lambda kv: kv[1])]
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms",
               "otherData": {"dropped_spans": self._dropped}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _jsonable(v):
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    return str(v)


# -- the no-op tracer ----------------------------------------------------

class _NoopScope:
    """Shared, reusable no-op context manager (also quacks like a Span)."""

    __slots__ = ()
    name = trace_id = span_id = parent_id = None
    context = None
    span = None  # _SpanScope surface parity

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def end(self):
        return None


_NOOP_SCOPE = _NoopScope()
_NoopScope.span = _NOOP_SCOPE  # `with t.span(..) as s:` yields the noop


class NoopTracer:
    """Zero-cost stand-in when tracing is off: every method returns a
    shared inert object."""

    enabled = False

    def span(self, name, parent=None, root=False, **attrs):
        return _NOOP_SCOPE

    def start_span(self, name, parent=None, root=False, **attrs):
        return _NOOP_SCOPE

    def current(self):
        return None

    def finished_spans(self):
        return []

    def durations_by_name(self):
        return {}


NOOP_TRACER = NoopTracer()
_tracer = NOOP_TRACER


def get_tracer():
    """The process-wide tracer (default: :data:`NOOP_TRACER`)."""
    return _tracer


def set_tracer(tracer):
    """Install ``tracer`` (None restores the no-op); returns the previous
    one so scopes can nest."""
    global _tracer
    prev = _tracer
    _tracer = tracer if tracer is not None else NOOP_TRACER
    return prev


__all__ = ["SpanContext", "Span", "Tracer", "NoopTracer",
           "NOOP_TRACER", "get_tracer", "set_tracer"]
