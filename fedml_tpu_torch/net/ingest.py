"""Parallel frame-decode stage: the wire->aggregator ingest pipeline
(counterpart of ``fedml_tpu/net/ingest.py``; the event-loop transport
builds the stage, the TCP hub uses :func:`note_ingest`).

The event-loop transport splits receive work across two threads: the
*loop* (sockets, framing) and the *dispatcher* (decode + FSM handlers).
At soak scale the dispatcher is decode-bound -- single-threaded Python
frame decode capped the 10k-connection soak at ~1.7k reports/sec on one
core (docs/NETWORKING.md) -- exactly the population-scale regime
Bonawitz et al. (MLSys'19) size aggregators for. :class:`DecodeStage`
is the optional middle tier: ``workers`` decode threads between the
loop and the dispatcher, sharded **by peer rank**, so

- per-peer frame/EOF order is preserved *by construction* (one rank
  always lands on the same worker, and control items -- EOF, shed,
  join -- ride the same shard queue as that rank's frames);
- cross-peer interleaving may differ from the single-FIFO path, which
  is safe because every fold downstream is the sorted-key
  arrival-order-independent ``fold_entries_fp64`` (and the A/B tests
  pin that worker count changes no trajectory);
- ``workers=1`` keeps today's path: the stage is simply not built and
  the dispatcher decodes inline (bitwise-pinned default).

Workers apply the transport's ``decode_fn`` -- a loop-callback-grade
function that must never block (fedcheck FL129 roots decode-stage
callbacks statically) -- in drained batches, so the queue's wait/notify
machinery is paid per chunk, not per frame. Decode throughput feeds the
metrics registry: ``fed_ingest_frames_total`` and the
``fed_ingest_decode_seconds`` histogram (observed per decode batch; the
ratio sum/frames is the decode-seconds-per-report the perf-regression
ledger gates).

Thread model: shard queues are ``SimpleQueue`` (lock-free put); the
stage's ``_lock`` guards only the stats counters and the stop barrier
-- never held across a decode or a downstream put.
"""

from __future__ import annotations

import threading
import time
from queue import Empty, SimpleQueue

from fedml_tpu_torch.core.locks import audited_lock
from fedml_tpu_torch.observability.registry import get_registry

#: Items a worker decodes per queue wakeup (mirrors the dispatcher's
#: ``_DISPATCH_BATCH``): one blocking ``get`` then a non-blocking drain.
_WORKER_BATCH = 256

#: Histogram buckets for per-batch decode seconds (sub-millisecond to
#: the multi-second chunks a 256-frame drain of big models can cost).
INGEST_DECODE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                         0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                         5.0)

_CLOSE = ("__ingest_close__",)


def note_ingest(frames, seconds, transport):
    """One decode batch's worth of ingest accounting into the registry
    (no-op when observability is off) -- shared by the worker stage and
    the transports' inline decode paths so decode-seconds-per-report
    means the same thing on every path."""
    reg = get_registry()
    if reg is None:
        return
    reg.inc("fed_ingest_frames_total", int(frames),
            help="wire frames decoded by the ingest stage",
            transport=transport)
    reg.observe("fed_ingest_decode_seconds", float(seconds),
                buckets=INGEST_DECODE_BUCKETS,
                help="wall seconds per ingest decode batch (sum / "
                     "fed_ingest_frames_total = decode seconds per "
                     "report)", transport=transport)


class DecodeStage:
    """N decode workers between a transport's I/O loop and its
    dispatcher (module docstring). ``decode_fn(item) -> item`` maps a
    ``("frame", rank, buf)`` item to its decoded form; every other item
    kind passes through untouched. Decoded (and passed-through) items
    land on ``out_queue`` in per-shard order."""

    def __init__(self, workers, decode_fn, out_queue,
                 transport="eventloop"):
        self.workers = max(1, int(workers))
        self._decode_fn = decode_fn
        self._out = out_queue
        self._transport = str(transport)
        self._lock = audited_lock()
        self._barriers = {}       # token -> [remaining, item]
        self._barrier_seq = 0
        self.frames = 0           # decoded frames (stats; under _lock)
        self.decode_s = 0.0       # decode wall seconds (under _lock)
        self._queues = [SimpleQueue() for _ in range(self.workers)]
        self._threads = [
            threading.Thread(target=self._worker_run, args=(q,),
                             daemon=True, name=f"ingest-decode-{i}")
            for i, q in enumerate(self._queues)]
        for t in self._threads:
            t.start()

    # -- producer side (the I/O loop) --------------------------------------
    def submit(self, rank, item):
        """Route one item to ``rank``'s shard. Frames and that rank's
        control items (eof/shed/join) MUST all come through here so the
        shard queue preserves their relative order."""
        self._queues[int(rank) % self.workers].put(item)

    def post_barrier(self, item):
        """Deliver ``item`` to the output AFTER everything already
        submitted to every shard has been decoded and forwarded -- the
        multi-queue analog of appending to a single FIFO (used for the
        ``stopped`` sentinel so pre-stop frames are never dropped)."""
        with self._lock:
            self._barrier_seq += 1
            token = self._barrier_seq
            self._barriers[token] = [self.workers, item]
        for q in self._queues:
            q.put(("__ingest_barrier__", token))

    def close(self):
        """Stop the workers (idempotent); queued items are forwarded
        first -- close is a barrier followed by thread exit."""
        for q in self._queues:
            q.put(_CLOSE)
        for t in self._threads:
            t.join(timeout=5.0)

    # -- stats --------------------------------------------------------------
    def stats(self):
        with self._lock:
            return {"frames": self.frames,
                    "decode_s": round(self.decode_s, 6)}

    # -- worker threads ------------------------------------------------------
    def _barrier_arrive(self, token):
        with self._lock:
            entry = self._barriers.get(token)
            if entry is None:
                return None
            entry[0] -= 1
            if entry[0] > 0:
                return None
            del self._barriers[token]
            return entry[1]

    def _worker_run(self, q):
        while True:
            items = [q.get()]
            try:
                while len(items) < _WORKER_BATCH:
                    items.append(q.get_nowait())
            except Empty:
                pass
            t0 = None
            decoded = 0
            for item in items:
                kind = item[0]
                if kind == "__ingest_close__":
                    if decoded:
                        self._note(decoded, time.perf_counter() - t0)
                    return
                if kind == "__ingest_barrier__":
                    out = self._barrier_arrive(item[1])
                    if out is not None:
                        self._out.put(out)
                    continue
                if kind == "frame":
                    if t0 is None:
                        t0 = time.perf_counter()
                    item = self._decode_fn(item)
                    decoded += 1
                self._out.put(item)
            if decoded:
                self._note(decoded, time.perf_counter() - t0)

    def _note(self, frames, seconds):
        with self._lock:
            self.frames += frames
            self.decode_s += seconds
        note_ingest(frames, seconds, self._transport)


__all__ = ["DecodeStage", "note_ingest", "INGEST_DECODE_BUCKETS"]
