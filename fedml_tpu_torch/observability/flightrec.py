"""Control-plane flight recorder: a bounded ring of events, dumped on death
(counterpart of ``fedml_tpu/observability/flightrec.py``; installed by
``observability.enable(flightrec=True)``, which the mains' ``--flightrec``
flag arms, or ``set_flight_recorder``).

A flaky chaos failure ("the round hung once at 2 a.m.") is only debuggable
if the control plane's last N events survive the crash. The recorder keeps
a thread-safe ring buffer of structured events -- message send/recv with
type+rank+bytes, RoundController decisions, retry/backoff attempts,
lock-audit violations -- and snapshots it to
``<out_dir>/flightrec_<reason>.jsonl`` when something dies:

- ``peer_lost``: a transport synthesized ``MSG_TYPE_PEER_LOST`` (TCP
  EOF-without-GOODBYE, exhausted retry budget, local-network abort);
- ``abandoned_round``: the RoundController resolved an attempt below
  quorum;
- ``crash``: an unhandled exception reached the interpreter's top level
  (the ``enable()`` scope chains ``sys.excepthook`` /
  ``threading.excepthook`` while active).

Dumps are deduplicated per reason per recorder (the first death is the
interesting one; repeats append ``_2``, ``_3`` ... up to ``max_dumps``)
and each line is self-describing JSON, so a post-mortem is ``jq`` away.

Recording cost when enabled is one dict + deque append under a lock per
control-plane event (tens per round); when disabled the instrumentation
points read one module global and branch away.
"""

from __future__ import annotations

import json
import os
import threading
import time


class FlightRecorder:
    """Bounded ring of control-plane events.

    Args:
      out_dir: where dumps land (created on first dump).
      capacity: ring size in events (oldest evicted first).
      max_dumps: total dump-file cap per recorder (a crash loop must not
        fill the disk with identical post-mortems).
    """

    def __init__(self, out_dir=".", capacity=4096, max_dumps=8):
        from collections import deque
        self.out_dir = out_dir
        self._buf = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._seq = 0
        self.max_dumps = int(max_dumps)
        self.dumps = []          # paths written, in order
        self._reason_counts = {}

    def record(self, kind, **fields):
        """Append one event. ``fields`` must be JSON-serializable scalars
        (arrays and pytrees do not belong in a black box)."""
        evt = {"t": time.time(), "kind": str(kind),
               "thread": threading.current_thread().name}
        evt.update(fields)
        with self._lock:
            self._seq += 1
            evt["seq"] = self._seq
            self._buf.append(evt)
        return evt

    def snapshot(self):
        with self._lock:
            return list(self._buf)

    def dump(self, reason, extra=None):
        """Write the ring to ``flightrec_<reason>.jsonl``; returns the
        path (None once ``max_dumps`` is reached). The triggering context
        can attach an ``extra`` event appended after the ring."""
        reason = str(reason).replace(os.sep, "_")
        with self._lock:
            if len(self.dumps) >= self.max_dumps:
                return None
            n = self._reason_counts.get(reason, 0) + 1
            self._reason_counts[reason] = n
            name = (f"flightrec_{reason}.jsonl" if n == 1
                    else f"flightrec_{reason}_{n}.jsonl")
            events = list(self._buf)
            # path building + file I/O stay OUTSIDE the lock (record()
            # callers on hot paths must never wait on the filesystem)
            path = self.out_dir + os.sep + name
            self.dumps.append(path)
        os.makedirs(self.out_dir, exist_ok=True)
        with open(path, "w") as f:
            for evt in events:
                f.write(json.dumps(evt, default=str) + "\n")
            if extra:
                f.write(json.dumps({"t": time.time(), "kind": "dump_info",
                                    **extra}, default=str) + "\n")
        return path


_recorder = None


def get_flight_recorder():
    """The process-wide recorder, or None when off -- instrumentation
    points guard with ``if fr is not None``."""
    return _recorder


def set_flight_recorder(recorder):
    global _recorder
    prev = _recorder
    _recorder = recorder
    return prev


__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder"]
