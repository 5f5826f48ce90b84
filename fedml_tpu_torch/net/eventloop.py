"""Selector event-loop transport: one thread, ten thousand connections
(counterpart of ``fedml_tpu/net/eventloop.py``; same frames, same
protocol, same counters).

Same contract as the threaded hub (``core/comm/tcp.py``): star topology
(rank 0 listens, clients dial and HELLO), length-prefixed binary-codec
frames, in-band GOODBYE/STOP, ``MSG_TYPE_PEER_LOST`` synthesis on
EOF-without-GOODBYE, ``abort()`` for crash injection, wire-byte metrics.
What changes is the execution model:

- **One I/O thread** (the *loop*) owns the selector and every socket: it
  accepts, reads frames with ``recv_into`` into preallocated per-frame
  buffers, and drains per-connection write queues with non-blocking
  ``send`` -- no thread per peer, no per-peer send lock, no ``sendall``
  that one wedged receiver can pin. Loop callbacks must never block.
- **One dispatcher thread** (whoever calls ``handle_receive_message``)
  decodes frames and runs the FSM handlers, fed by the loop through an
  in-process queue -- handlers may train models and send messages, and
  the FIFO preserves the per-peer frame/EOF order the protocol needs
  (a GOODBYE is always processed before the EOF it precedes).
- **Senders never touch sockets**: ``send_message`` encodes to zero-copy
  buffer views (``compression.codec.message_to_wire_views`` -- tensor
  bytes are never copied into a frame at all) and appends them to the
  receiver's write queue; the loop writes them when the socket can take
  them, advancing through partial sends by re-slicing the views.
- **Backpressure is explicit**: a connection whose queued-but-unsent
  bytes cross ``high_watermark`` is *congested*; if it has not drained
  back under ``low_watermark`` within ``drain_grace_s`` it is SHED --
  hard-closed and reported through the exact PEER_LOST path a crashed
  peer takes, so the resilience layer (re-cohort, partial aggregation,
  retry caps) absorbs slow readers with zero new machinery. A shed is a
  flight-recorder event and a ``net_backpressure_sheds_total`` counter.

Thread model / lock discipline: ``_lock`` (state) guards peer membership,
write queues + their byte counts, the congestion set, and the peer-lost
dedup set -- never held across I/O; ``_ctr_lock`` keeps the wire counters
exact. Connection *read* state (``_Conn.rx_*``) is loop-thread-only and
needs no lock. The flags ``_running``/``_stopping``/``_loop_stop`` are
benign racy booleans, same as the threaded transport.
"""

from __future__ import annotations

import json
import logging
import selectors
import socket
import struct
import threading
import time
from collections import deque
from queue import Empty, SimpleQueue

from fedml_tpu_torch.core.locks import audited_lock
from fedml_tpu_torch.observability.flightrec import get_flight_recorder
from fedml_tpu_torch.observability.registry import get_registry
from fedml_tpu_torch.compression.codec import (DECODE_ERRORS, MAGIC,
                                         message_from_header,
                                         message_from_wire,
                                         message_to_wire_views,
                                         parse_wire_header)
from fedml_tpu_torch.core.comm.base import (BaseCommunicationManager,
                                      MSG_TYPE_PEER_JOIN,
                                      MSG_TYPE_PEER_LOST, RejoinWindow)
from fedml_tpu_torch.core.comm.tcp import MSG_TYPE_GOODBYE, _enable_keepalive
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.net.ingest import DecodeStage, note_ingest

_HDR = struct.Struct("!I")
_MAX_FRAME = 256 * 1024 * 1024
#: Loop tick when nothing is due: bounds congestion-deadline latency and
#: stop-flush polling without burning CPU (the wake pipe handles sends).
_TICK_S = 0.2
#: Seconds the graceful-stop flush (STOP wave / GOODBYE drain) may take
#: before the loop force-closes everything -- the Timer(5.0) analog.
_STOP_FLUSH_S = 5.0
#: Frames the dispatcher decodes per FIFO wakeup. At soak rates the
#: dispatcher is the single-threaded decode bottleneck and a blocking
#: ``get()`` per frame pays the queue's wait/notify machinery every
#: time; draining a chunk per wakeup amortizes it while the per-peer
#: frame/EOF order within the drained list is exactly the queue order,
#: so the GOODBYE-vs-crash reasoning is untouched.
_DISPATCH_BATCH = 256


class _Conn:
    """Per-connection state. ``rx_*`` is touched only by the loop thread
    (no lock); ``tx``/``tx_bytes``/``congested_at``/``closing``/``shed``
    are shared with sender threads under the manager's state lock."""

    __slots__ = ("sock", "rank", "hello", "tx", "tx_bytes", "congested_at",
                 "closing", "shed", "dead", "want_write", "parked",
                 "rx_hdr", "rx_buf", "rx_view", "rx_got")

    def __init__(self, sock, rank=None):
        self.sock = sock
        self.rank = rank          # peer rank (None until HELLO, server side)
        self.hello = rank is not None
        self.tx = deque()         # outbound memoryviews (zero-copy)
        self.tx_bytes = 0         # queued-but-unsent payload+header bytes
        self.congested_at = None  # monotonic time the high watermark hit
        self.closing = False      # flush remaining tx, then SHUT_WR
        self.shed = False
        self.dead = False         # closed (dedups the dispatcher post)
        self.want_write = False   # loop-owned: WRITE interest registered
        self.parked = False       # loop-owned: deferred rejoin, unread
        self.rx_hdr = memoryview(bytearray(_HDR.size))
        self.rx_buf = None        # bytearray of the in-flight frame
        self.rx_view = None
        self.rx_got = 0


def _hard_close(sock):
    # shutdown-then-close: see core/comm/tcp.py -- closing an fd does not
    # wake a blocked recv; SHUT_RDWR interrupts deterministically
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class EventLoopCommManager(BaseCommunicationManager):
    """Single-threaded selector transport (see module docstring).

    Args:
      host/port: rank 0's listen address (clients dial it).
      rank: 0 = server (listens), >0 = client.
      world_size: total ranks (server waits for world_size-1 HELLOs).
      timeout: dial/handshake bound (construction fails past it).
      binary: binary wire codec (default) vs legacy JSON frames.
      metrics_logger: live ``count_wire`` feed (bytes_on_wire accounting).
      high_watermark/low_watermark: per-connection queued-byte thresholds
        for the congestion state machine (bytes).
      drain_grace_s: how long a congested connection may stay above the
        low watermark before it is shed via PEER_LOST; 0 sheds at the
        first loop tick after crossing the high watermark.
      backlog: listener accept backlog (soak harnesses dial in bursts).
      decode_workers: parallel frame-decode workers between the loop
        and the dispatcher (``net.ingest.DecodeStage``), sharded by
        peer rank so per-peer frame/EOF order is preserved. The default
        1 keeps today's inline-decode dispatcher, bitwise (A/B-pinned);
        any worker count leaves every trajectory unchanged because the
        downstream folds are arrival-order independent.
    """

    def __init__(self, host, port, rank, world_size, timeout=60.0,
                 binary=True, metrics_logger=None,
                 high_watermark=32 * 2 ** 20, low_watermark=8 * 2 ** 20,
                 drain_grace_s=10.0, backlog=4096, decode_workers=1,
                 rejoin_burst=16, rejoin_window_s=1.0):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self._binary = bool(binary)
        self.high_watermark = int(high_watermark)
        self.low_watermark = int(low_watermark)
        self.drain_grace_s = float(drain_grace_s)
        # rejoin-storm rate limit (hub): at most rejoin_burst
        # re-admissions per rejoin_window_s sliding window; excess
        # HELLOs park unread (selector-unregistered, connection open)
        # and admit as the window refills -- deferred, never dropped.
        # Same contract as TcpCommManager._accept_rejoins.
        self.rejoin_burst = max(1, int(rejoin_burst))
        self.rejoin_window_s = float(rejoin_window_s)
        self.rejoins_deferred = 0
        # loop-thread only; same contract object as the tcp hub's
        self._rejoin_window = RejoinWindow(rejoin_burst, rejoin_window_s)
        #: payload bytes through this manager (same contract as tcp)
        self.bytes_sent = 0
        self.bytes_received = 0
        self.resends = 0
        self.sheds = 0
        #: inline-decode ingest accounting (the workers=1 path; the
        #: worker stage keeps its own -- see ingest_stats())
        self.ingest_frames = 0
        self.ingest_decode_s = 0.0
        self._metrics = metrics_logger
        self._observers = []
        self._running = False
        self._stopping = False
        self._loop_stop = False
        self._stop_deadline = None
        self._torn_down = False
        # _lock: peer membership, write queues, congestion set, peer-lost
        # dedup. Never held across socket I/O (the loop sends/receives
        # outside it); _ctr_lock keeps the wire counters exact when the
        # loop and the dispatcher count concurrently.
        self._lock = audited_lock()
        self._ctr_lock = audited_lock()
        self._peers = {}          # rank -> _Conn
        self._kick = set()        # conns with freshly queued tx
        self._congested = set()   # conns past the high watermark
        self._lost_notified = set()
        self._goodbye = set()     # dispatcher-only: ranks that hung up
        self._inbox = SimpleQueue()   # loop -> dispatcher
        # parallel decode stage: frames and per-rank control
        # items route through rank-sharded worker queues into the same
        # inbox; workers=1 keeps the stage unbuilt (inline decode)
        self.decode_workers = max(1, int(decode_workers))
        self._ingest = (DecodeStage(self.decode_workers,
                                    self._decode_item, self._inbox)
                        if self.decode_workers > 1 else None)
        self._sel = selectors.DefaultSelector()
        self._wake_buf = memoryview(bytearray(4096))  # wake-pipe drain
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           (self._on_wake, None))
        self._listener = None
        self._joined = threading.Event()
        if self.world_size <= 1:
            self._joined.set()
        if self.rank == 0:
            self._listener = socket.create_server((host, port),
                                                  backlog=int(backlog))
            self._listener.setblocking(False)
            self._sel.register(self._listener, selectors.EVENT_READ,
                               (self._on_accept, None))
        else:
            # blocking dial + HELLO before the loop starts: launch order
            # between hosts is not coordinated (same retry as tcp)
            deadline = time.monotonic() + timeout
            while True:
                try:
                    sock = socket.create_connection((host, port),
                                                    timeout=timeout)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.05)
            hello = json.dumps({"rank": self.rank}).encode()
            sock.sendall(_HDR.pack(len(hello)) + hello)
            sock.setblocking(False)
            _enable_keepalive(sock)
            conn = _Conn(sock, rank=0)
            with self._lock:
                self._peers[0] = conn
            self._sel.register(sock, selectors.EVENT_READ,
                               (self._on_conn_event, conn))
        self._loop_thread = threading.Thread(
            target=self._loop_run, daemon=True,
            name=f"evloop-{self.rank}")
        self._loop_thread.start()
        if self.rank == 0 and not self._joined.wait(timeout):
            with self._lock:
                n = len(self._peers)
            self.close()
            raise TimeoutError(
                f"event-loop hub: only {n}/{self.world_size - 1} peers "
                f"joined within {timeout}s")

    # -- BaseCommunicationManager -----------------------------------------
    def add_observer(self, observer):
        self._observers.append(observer)

    def remove_observer(self, observer):
        self._observers.remove(observer)

    def _count_out(self, nbytes, is_resend=False):
        with self._ctr_lock:
            self.bytes_sent += nbytes
            if is_resend:
                self.resends += 1
        if self._metrics is not None:
            self._metrics.count_wire(nbytes,
                                     raw_bytes=0 if is_resend else nbytes)
        reg = get_registry()
        if reg is not None:
            reg.inc("comm_bytes_total", nbytes,
                    help="control-plane payload bytes by direction",
                    transport="eventloop", direction="sent")
            if is_resend:
                reg.inc("comm_resends_total",
                        help="frames re-sent by the retry layer",
                        transport="eventloop")

    def _count_in(self, nbytes):
        with self._ctr_lock:
            self.bytes_received += nbytes
        reg = get_registry()
        if reg is not None:
            reg.inc("comm_bytes_total", nbytes,
                    help="control-plane payload bytes by direction",
                    transport="eventloop", direction="received")

    def send_message(self, msg: Message, is_resend=False):
        receiver = int(msg.get_receiver_id())
        if self.rank == 0 and receiver == 0:
            self._dispatch(msg)  # self-addressed: no wire, no bytes
            return
        if self._binary:
            views = [memoryview(v) if not isinstance(v, memoryview) else v
                     for v in message_to_wire_views(msg)]
        else:
            views = [memoryview(msg.to_json().encode())]
        nbytes = sum(len(v) for v in views)
        self._count_out(nbytes, is_resend=is_resend)
        fr = get_flight_recorder()
        if fr is not None:
            # recorded BEFORE the enqueue, mirroring tcp: a send whose
            # peer is shed mid-queue must already be in the ring
            fr.record("send", type=msg.get_type(), src=self.rank,
                      dst=receiver, bytes=nbytes, transport="eventloop",
                      resend=bool(is_resend))
        target = receiver if self.rank == 0 else 0
        self._enqueue(target, views, nbytes, label=receiver)

    def _enqueue(self, target_rank, views, nbytes, label=None):
        """Queue one frame (header + buffer views) onto ``target_rank``'s
        connection and wake the loop. Raises KeyError when the peer is
        not routed (never joined, died, shed, or said goodbye) -- the
        retry layer treats that exactly like a failed write."""
        frame = [memoryview(_HDR.pack(nbytes))] + list(views)
        # ONE critical section for routing check + append: a gap between
        # them would let a racing stop wave / close mark the connection
        # closing and the frame would be queued behind a SHUT_WR, dying
        # on a later send() instead of surfacing here as unrouted
        with self._lock:
            conn = self._peers.get(target_rank)
            unrouted = (conn is None or conn.shed or conn.closing
                        or conn.dead)
            if not unrouted:
                conn.tx.extend(frame)
                conn.tx_bytes += nbytes + _HDR.size
                if (conn.tx_bytes > self.high_watermark
                        and conn.congested_at is None):
                    conn.congested_at = time.monotonic()
                    self._congested.add(conn)
                self._kick.add(conn)
        if unrouted:
            if self.rank != 0:
                # dead server pipe: mirror tcp's client-send failure --
                # dispatch PEER_LOST (deduped) and raise a typed error
                self._notify_peer_lost(0)
                raise ConnectionError(
                    "server (rank 0) transport died "
                    "(MSG_TYPE_PEER_LOST dispatched)")
            raise KeyError(
                f"no connected peer with rank "
                f"{target_rank if label is None else label} (never "
                "joined, its transport died -- see MSG_TYPE_PEER_LOST "
                "-- was shed by backpressure, or it said goodbye)")
        self._wake()

    def _wake(self):
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass  # pipe full = a wake is already pending; closed = torn down

    def handle_receive_message(self):
        """Blocking dispatcher loop: decodes loop-delivered frames and
        runs observers/handlers until STOP (client) or until every peer
        is gone or STOP is relayed (hub)."""
        self._running = True
        if self.rank == 0:
            self._serve_hub()
        else:
            self._serve_client()

    # -- dispatcher thread -------------------------------------------------
    def _drain_inbox(self):
        """One dispatcher wakeup's worth of work: block for the first
        item, then drain up to ``_DISPATCH_BATCH`` already-queued items
        without re-entering the queue's wait machinery. Order is the
        FIFO's order -- batching changes wakeup count, never sequencing."""
        items = [self._inbox.get()]
        try:
            while len(items) < _DISPATCH_BATCH:
                items.append(self._inbox.get_nowait())
        except Empty:
            pass
        return items

    def _decode_item(self, item):
        """One ``("frame", rank, buf)`` FIFO item -> its dispatch form
        ``("msg", rank, payload, frame)``. ``payload`` is a decoded
        ``Message`` for frames this rank dispatches locally, a
        ``("peek", type, receiver)`` envelope for frames the hub only
        relays or control-handles (GOODBYE / in-band PEER_LOST) -- the
        tensor payload is never decoded for those -- or the decode
        exception. Decoded tensor payloads ALIAS the frame buffer
        (zero-copy; the buffer is per-frame and handed off whole, never
        recycled). Loop-callback-grade: runs on the decode workers and
        must never block, take a manager lock, or touch a socket."""
        _kind, rank, frame = item
        try:
            if frame and frame[0] == MAGIC:
                header, off = parse_wire_header(frame)
                mtype = str(header[Message.MSG_ARG_KEY_TYPE])
                receiver = header[Message.MSG_ARG_KEY_RECEIVER]
                if self.rank == 0 and (int(receiver) != 0
                                       or mtype in (MSG_TYPE_GOODBYE,
                                                    MSG_TYPE_PEER_LOST)):
                    return ("msg", rank, ("peek", mtype, int(receiver)),
                            frame)
                payload = message_from_header(header, frame, off)
            else:
                payload = message_from_wire(frame)
        except DECODE_ERRORS as e:
            payload = e
        return ("msg", rank, payload, frame)

    def _predecode(self, items):
        """Inline batch decode of a drained chunk (the ``workers=1``
        path): one timed pass over every raw frame in the chunk, with
        the ingest counters fed per chunk -- the worker stage does the
        same per shard batch, so decode-seconds-per-report means one
        thing on both paths. Items already decoded by the workers pass
        through untouched."""
        t0 = None
        n = 0
        for i, item in enumerate(items):
            if item[0] == "frame":
                if t0 is None:
                    t0 = time.perf_counter()
                items[i] = self._decode_item(item)
                n += 1
        if n:
            dt = time.perf_counter() - t0
            with self._ctr_lock:
                self.ingest_frames += n
                self.ingest_decode_s += dt
            note_ingest(n, dt, "eventloop")
        return items

    def ingest_stats(self) -> dict:
        """Cumulative decode-stage accounting: frames decoded + decode
        wall seconds, summed over the inline path and the worker stage
        (the soak bench's decode-seconds-per-report evidence)."""
        with self._ctr_lock:
            frames, secs = self.ingest_frames, self.ingest_decode_s
        if self._ingest is not None:
            st = self._ingest.stats()
            frames += st["frames"]
            secs += st["decode_s"]
        return {"frames": frames, "decode_s": round(secs, 6),
                "workers": self.decode_workers}

    def _groupable(self, payload):
        """The batch-dispatch predicate: a decoded Message addressed to
        this rank whose type is not transport-reserved may join a
        same-type dispatch run. Reserved ``__``-types (STOP, GOODBYE,
        PEER_LOST) always dispatch singly through the control paths."""
        if not isinstance(payload, Message):
            return None
        t = payload.get_type()
        if t.startswith("__"):
            return None
        if int(payload.get_receiver_id()) != self.rank:
            return None
        return t

    def _serve_hub(self):
        while True:
            items = self._predecode(self._drain_inbox())
            i, n = 0, len(items)
            while i < n:
                item = items[i]
                kind = item[0]
                if kind == "stopped":
                    return
                if kind == "msg":
                    mtype = self._groupable(item[2])
                    if mtype is not None:
                        # maximal run of consecutive same-type local
                        # messages: one batched dispatch (one lock
                        # acquisition + one batched fold downstream).
                        # ANY other item kind breaks the run, so
                        # per-peer frame/EOF order is untouched.
                        j = i + 1
                        while j < n and items[j][0] == "msg" \
                                and self._groupable(items[j][2]) == mtype:
                            j += 1
                        self._dispatch_batch(
                            mtype, [(it[2], it[1], len(it[3]))
                                    for it in items[i:j]])
                        i = j
                        continue
                    if not self._dispatch_hub_item(item[1], item[2],
                                                   item[3]):
                        return
                elif kind == "join":
                    # rejoin: FIFO order guarantees the PEER_JOIN lands
                    # before any frame the rejoined rank sends
                    self._goodbye.discard(item[1])
                    self._notify_peer_join(item[1])
                elif kind in ("eof", "shed"):
                    rank = item[1]
                    clean = rank in self._goodbye and kind != "shed"
                    if not clean and not self._stopping:
                        self._notify_peer_lost(rank)
                    with self._lock:
                        n_left = len(self._peers)
                    if n_left == 0:
                        # every peer gone with no STOP: mirror tcp --
                        # release the listener, quench late notifications
                        self._running = False
                        self._stopping = True
                        self.close()
                        return
                i += 1

    def _dispatch_batch(self, mtype, run):
        """Deliver one run of same-type locally-addressed messages
        (``run`` = [(msg, rank, nbytes)]): observers implementing
        ``receive_message_batch`` get the whole run -- the async
        server's batched-entry fold costs one ``_advance_lock``
        acquisition per run instead of one per report -- everyone else
        gets the unchanged per-message loop (bitwise for the sync FSMs
        by construction)."""
        fr = get_flight_recorder()
        for msg, rank, nbytes in run:
            self._count_in(nbytes)
            if fr is not None:
                fr.record("recv", type=mtype, src=rank, dst=self.rank,
                          bytes=nbytes, transport="eventloop")
        msgs = [m for m, _, _ in run]
        for obs in list(self._observers):
            batch = getattr(obs, "receive_message_batch", None)
            if batch is not None and len(msgs) > 1:
                try:
                    batch(mtype, msgs)
                except (AttributeError, KeyError, IndexError, TypeError,
                        ValueError, ArithmeticError):
                    # a buggy FSM handler must not kill the dispatcher
                    # -- infra failures (OSError, MemoryError) still
                    # propagate
                    logging.exception("eventloop hub: handler error for "
                                      "batched type=%s (%d message(s))",
                                      mtype, len(msgs))
                continue
            # error isolation at per-message granularity, matching the
            # unbatched path: one poisoned message loses itself, never
            # the rest of the run
            for m in msgs:
                try:
                    obs.receive_message(mtype, m)
                except (AttributeError, KeyError, IndexError, TypeError,
                        ValueError, ArithmeticError):
                    logging.exception("eventloop hub: handler error for "
                                      "type=%s (in batched run)", mtype)

    def _dispatch_hub_item(self, rank, payload, frame) -> bool:
        self._count_in(len(frame))
        if isinstance(payload, Exception):
            # malformed payload: the codec's concrete decode failures --
            # the peer is lost, loudly (same disposition as tcp)
            logging.error("eventloop hub: undecodable frame from "
                          "rank %s: %s", rank, payload)
            self._request_drop(rank)
            return True
        if isinstance(payload, tuple):  # ("peek", type, receiver)
            _tag, mtype, receiver = payload
            sender = rank
        else:
            mtype = payload.get_type()
            receiver = int(payload.get_receiver_id())
            sender = rank
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("recv", type=mtype, src=sender, dst=self.rank,
                      bytes=len(frame), transport="eventloop")
        if mtype == MSG_TYPE_GOODBYE:
            # clean hang-up: remember it so the EOF that follows (FIFO
            # guarantees it is processed after this frame) stays silent
            self._goodbye.add(rank)
            self._request_drop(rank)
            return True
        if mtype == MSG_TYPE_PEER_LOST:
            logging.warning("eventloop hub: dropping in-band reserved %s "
                            "frame from rank %s", MSG_TYPE_PEER_LOST, rank)
            return True
        if receiver == 0 and isinstance(payload, Message):
            try:
                keep = self._dispatch(payload)
            except (AttributeError, KeyError, IndexError, TypeError,
                    ValueError, ArithmeticError):
                # a buggy FSM handler must not kill the dispatcher --
                # infra failures (OSError, MemoryError) still propagate
                logging.exception("eventloop hub: handler error for "
                                  "type=%s from rank %s", mtype, rank)
                keep = True
            if not keep:
                self.stop_receive_message()
                return False
            return True
        # client -> client: relay the RAW frame (zero re-encode, and --
        # via the header peek -- zero payload decode; the destination
        # validates the payload)
        try:
            self._enqueue(receiver, [memoryview(frame)], len(frame))
            self._count_out(len(frame))
        except KeyError:
            logging.warning("eventloop hub: dropping message for unknown "
                            "rank %s (type=%s)", receiver, mtype)
        return True

    def _serve_client(self):
        try:
            while True:
                for item in self._predecode(self._drain_inbox()):
                    kind = item[0]
                    if kind == "stopped":
                        return
                    if kind == "msg":
                        if not self._running:
                            continue  # GOODBYE sent: draining until EOF
                        payload, frame = item[2], item[3]
                        self._count_in(len(frame))
                        if isinstance(payload, Exception):
                            raise payload  # undecodable server frame:
                            # crash loudly (pre-ingest disposition)
                        msg = payload
                        fr = get_flight_recorder()
                        if fr is not None:
                            fr.record("recv", type=msg.get_type(),
                                      src=msg.get_sender_id(),
                                      dst=self.rank,
                                      bytes=len(frame),
                                      transport="eventloop")
                        if msg.get_type() == MSG_TYPE_PEER_LOST:
                            logging.warning("eventloop client: dropping "
                                            "in-band reserved %s frame",
                                            MSG_TYPE_PEER_LOST)
                            continue
                        if not self._dispatch(msg):
                            return
                    elif kind in ("eof", "shed"):
                        if self._running and not self._stopping:
                            self._notify_peer_lost(0)
                        return
        finally:
            self._running = False
            if not self._stopping:
                # STOP frame / server EOF: hard teardown. A graceful stop
                # (_stopping set) leaves teardown to the loop's flush
                # machinery so the queued GOODBYE still gets delivered.
                self._stopping = True
                self.close()

    def _dispatch(self, msg: Message) -> bool:
        if msg.get_type() == "__stop__":
            self._running = False
            return False
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)
        return True

    def _request_drop(self, rank):
        """Dispatcher -> loop: close ``rank``'s connection (decode error
        or clean GOODBYE). The loop's close posts the matching eof."""
        with self._lock:
            conn = self._peers.get(rank)
            if conn is not None:
                conn.shed = True  # unroute for senders immediately
                self._kick.add(conn)
        self._wake()

    def _notify_peer_lost(self, peer_rank):
        """Dispatch MSG_TYPE_PEER_LOST once per peer unless this is our
        own shutdown (same dedup + quench contract as tcp; the retry
        layer calls this directly on exhausted budgets)."""
        if self._stopping:
            return
        with self._lock:
            if peer_rank in self._lost_notified:
                return
            self._lost_notified.add(peer_rank)
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("peer_lost", peer=peer_rank, observer=self.rank,
                      transport="eventloop")
            fr.dump("peer_lost", extra={"peer": peer_rank,
                                        "observer": self.rank})
        lost = Message(MSG_TYPE_PEER_LOST, peer_rank, self.rank)
        for obs in list(self._observers):
            obs.receive_message(MSG_TYPE_PEER_LOST, lost)

    def _notify_peer_join(self, peer_rank):
        """Dispatch MSG_TYPE_PEER_JOIN for an accepted rejoin (runs on
        the dispatcher thread, mirroring ``_notify_peer_lost``)."""
        if self._stopping:
            return
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("peer_join", peer=peer_rank, observer=self.rank,
                      transport="eventloop")
        reg = get_registry()
        if reg is not None:
            reg.inc("fed_peer_rejoins_total",
                    help="previously lost/shed ranks re-admitted by a "
                         "fresh HELLO", transport="eventloop")
        joined = Message(MSG_TYPE_PEER_JOIN, peer_rank, self.rank)
        for obs in list(self._observers):
            obs.receive_message(MSG_TYPE_PEER_JOIN, joined)

    # -- shutdown ----------------------------------------------------------
    def stop_receive_message(self):
        self._running = False
        self._stopping = True
        if self.rank == 0:
            with self._lock:
                ranks = sorted(self._peers)
            for r in ranks:
                payload = Message("__stop__", 0, r).to_json().encode()
                try:  # STOP frames bypass wire accounting, like tcp's wave
                    self._enqueue(r, [memoryview(payload)], len(payload))
                except KeyError:
                    pass  # died as we were waving
        else:
            payload = Message(MSG_TYPE_GOODBYE, self.rank,
                              0).to_json().encode()
            try:
                self._enqueue(0, [memoryview(payload)], len(payload))
            except (KeyError, ConnectionError):
                pass  # server already gone: nothing to say goodbye to
        # flush-then-FIN: mark every connection closing; the loop drains
        # its queue, SHUT_WRs, and hard-closes on EOF (or on the bounded
        # stop deadline -- the Timer(5.0) analog)
        with self._lock:
            for conn in self._peers.values():
                conn.closing = True
                self._kick.add(conn)
        self._stop_deadline = time.monotonic() + _STOP_FLUSH_S
        if self._ingest is not None:
            # barrier, not a bare put: frames already sharded to decode
            # workers must reach the dispatcher BEFORE the stop sentinel
            # (the multi-queue analog of appending to the single FIFO)
            self._ingest.post_barrier(("stopped",))
        else:
            self._inbox.put(("stopped",))
        self._wake()

    def abort(self):
        """Die abruptly -- crash simulation (``fedml_tpu_torch.resilience``):
        no GOODBYE, no STOP wave; peers observe EOF-without-GOODBYE."""
        self._running = False
        self._stopping = True
        self._inbox.put(("stopped",))
        self.close()

    def close(self):
        """Idempotent hard teardown. Signals the loop (which owns the
        selector) and closes every socket; safe from any thread."""
        self._loop_stop = True
        self._wake()
        if not self._loop_thread.is_alive():
            self._teardown()

    # -- loop thread -------------------------------------------------------
    def _loop_run(self):
        try:
            while not self._loop_stop:
                events = self._sel.select(_TICK_S)
                for key, mask in events:
                    cb, conn = key.data
                    cb(conn, mask)
                self._service_kicks()
                self._check_congestion()
                self._service_deferred_rejoins()
                if self._stop_deadline is not None:
                    with self._lock:
                        idle = not self._peers
                    if idle or time.monotonic() > self._stop_deadline:
                        break
        except OSError:
            if not self._loop_stop:  # fds closed under a live select
                logging.exception("eventloop %d: loop I/O error",
                                  self.rank)
        finally:
            self._teardown()

    def _on_wake(self, _conn, _mask):
        try:  # recv_into a preallocated buffer: no allocation per wake
            while self._wake_r.recv_into(self._wake_buf):
                pass
        except OSError:
            pass

    def _on_accept(self, _conn, _mask):
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:  # includes BlockingIOError: backlog drained
                return
            sock.setblocking(False)
            _enable_keepalive(sock)
            conn = _Conn(sock)  # rank unknown until its HELLO frame
            try:
                self._sel.register(sock, selectors.EVENT_READ,
                                   (self._on_conn_event, conn))
            except (ValueError, KeyError, OSError):
                _hard_close(sock)

    def _on_conn_event(self, conn, mask):
        if mask & selectors.EVENT_READ:
            self._read_conn(conn)
        if mask & selectors.EVENT_WRITE and not conn.dead:
            self._flush_conn(conn)

    def _read_conn(self, conn):
        while not conn.parked:
            try:
                if conn.rx_buf is None:
                    n = conn.sock.recv_into(conn.rx_hdr[conn.rx_got:])
                else:
                    remaining = len(conn.rx_buf) - conn.rx_got
                    n = (conn.sock.recv_into(conn.rx_view[conn.rx_got:])
                         if remaining else 0)
                    if not remaining:
                        self._frame_complete(conn)
                        continue
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close_conn(conn, post=True)
                return
            if n == 0 and (conn.rx_buf is None or conn.rx_got
                           < len(conn.rx_buf)):
                self._close_conn(conn, post=True)  # EOF
                return
            conn.rx_got += n
            if conn.rx_buf is None:
                if conn.rx_got < _HDR.size:
                    continue
                (length,) = _HDR.unpack(conn.rx_hdr)
                if length > _MAX_FRAME:
                    logging.error("eventloop %d: unframeable stream from "
                                  "rank %s (%d-byte header)", self.rank,
                                  conn.rank, length)
                    self._close_conn(conn, post=True)
                    return
                conn.rx_buf = bytearray(length)
                conn.rx_view = memoryview(conn.rx_buf)
                conn.rx_got = 0
            if conn.rx_buf is not None and conn.rx_got == len(conn.rx_buf):
                self._frame_complete(conn)

    def _post_rank_item(self, rank, item):
        """Loop -> dispatcher, through the decode stage when armed:
        frames AND a rank's control items (eof/shed/join) ride the same
        rank shard, so per-peer ordering survives parallel decode."""
        if self._ingest is not None:
            self._ingest.submit(rank, item)
        else:
            self._inbox.put(item)

    def _frame_complete(self, conn):
        frame, conn.rx_buf, conn.rx_view, conn.rx_got = (
            conn.rx_buf, None, None, 0)
        if not conn.hello and self.rank == 0:
            self._handshake(conn, frame)
            return
        if self._running or not self._stopping:
            self._post_rank_item(conn.rank, ("frame", conn.rank, frame))

    def _handshake(self, conn, frame):
        """Server-side HELLO: route the connection by its declared rank.
        Invalid HELLOs close the connection (the loop must never raise);
        the constructor's join timeout surfaces the misconfiguration.

        Rejoin protocol: the selector accepts for the life of the loop,
        so a HELLO arriving *after* the initial join from a rank that is
        not currently routed (crashed, shed by backpressure, or said
        goodbye) re-admits it -- its peer-lost dedup is cleared (a
        second death must notify again) and a ``join`` item is posted to
        the dispatcher FIFO, which dispatches ``MSG_TYPE_PEER_JOIN``
        *in order* with the rank's subsequent frames."""
        try:
            peer_rank = int(json.loads(bytes(frame).decode())["rank"])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            logging.warning("eventloop hub: undecodable HELLO -- closing")
            self._close_conn(conn, post=False)
            return
        rejoin = self._joined.is_set()  # a late HELLO is a (re)join
        with self._lock:
            rejoin = rejoin or peer_rank in self._lost_notified
        if rejoin and not self._rejoin_window.try_admit():
            # rejoin-storm rate limit: park the connection unread (its
            # frames stay in the kernel buffer -- ``parked`` stops
            # _read_conn's drain loop, so a frame already queued behind
            # the HELLO is not misparsed as a second HELLO) and admit
            # it when the window refills -- deferred, never dropped.
            # Validity is judged at ADMIT time; loop-thread state only.
            conn.parked = True
            self._rejoin_window.deferred.append((conn, peer_rank))
            with self._ctr_lock:
                self.rejoins_deferred += 1
            logging.warning("eventloop hub: rejoin HELLO rank %s "
                            "deferred by the admission window (%d/%ss)",
                            peer_rank, self.rejoin_burst,
                            self.rejoin_window_s)
            reg = get_registry()
            if reg is not None:
                reg.inc("fed_peer_rejoins_deferred_total",
                        help="rejoin HELLOs deferred by the admission-"
                             "rate window (admitted later, never "
                             "dropped)",
                        transport="eventloop")
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            return
        self._admit_hello(conn, peer_rank, rejoin, registered=True)

    def _service_deferred_rejoins(self):
        """Admit parked rejoin HELLOs as the window refills (one loop
        tick granularity, arrival order preserved)."""
        for conn, peer_rank in self._rejoin_window.drain():
            self._admit_hello(conn, peer_rank, rejoin=True,
                              registered=False)

    def _admit_hello(self, conn, peer_rank, rejoin, registered):
        """Route one HELLO'd connection (validity judged here, at admit
        time -- a deferred rank's state can change while parked).
        ``registered`` = the socket is still in the selector."""
        conn.parked = False
        with self._lock:
            bad = (peer_rank <= 0 or peer_rank >= self.world_size
                   or peer_rank in self._peers)
            if not bad:
                conn.rank = peer_rank
                conn.hello = True
                self._peers[peer_rank] = conn
                joined = len(self._peers)
                # a rank already marked lost is a rejoin even BEFORE the
                # initial join completed (crash + re-dial mid-startup);
                # the dedup clears unconditionally so a second death
                # notifies again (same contract as tcp._accept_rejoins)
                self._lost_notified.discard(peer_rank)
        if bad:
            logging.warning(
                "eventloop hub: invalid HELLO rank %s for world size %s "
                "(duplicate or out-of-range -- misconfigured launch?)",
                peer_rank, self.world_size)
            # _close_conn's unregister tolerates a parked (already-
            # unregistered) socket
            self._close_conn(conn, post=False)
            return
        if not registered:
            try:
                self._sel.register(conn.sock, selectors.EVENT_READ,
                                   (self._on_conn_event, conn))
            except (KeyError, ValueError, OSError):
                self._close_conn(conn, post=False)
                return
        if rejoin:
            logging.warning("eventloop hub: rank %d rejoined", peer_rank)
            self._post_rank_item(peer_rank, ("join", peer_rank))
        if joined >= self.world_size - 1:
            self._joined.set()

    def _service_kicks(self):
        with self._lock:
            kicked = list(self._kick)
            self._kick.clear()
        for conn in kicked:
            if conn.shed:
                self._close_conn(conn, post=True)
                continue
            self._flush_conn(conn)

    def _flush_conn(self, conn):
        while True:
            with self._lock:
                buf = conn.tx[0] if conn.tx else None
            if buf is None:
                break
            try:
                n = conn.sock.send(buf)
            except (BlockingIOError, InterruptedError):
                self._want_write(conn, True)
                return
            except OSError:
                self._close_conn(conn, post=True)
                return
            with self._lock:
                conn.tx_bytes -= n
                if n == len(buf):
                    conn.tx.popleft()
                else:
                    conn.tx[0] = buf[n:]  # re-slice the view: zero-copy
                drained = (conn.congested_at is not None
                           and conn.tx_bytes <= self.low_watermark)
                if drained:
                    conn.congested_at = None
                    self._congested.discard(conn)
        self._want_write(conn, False)
        if conn.closing:
            try:  # queue flushed: FIN; the EOF (ours or theirs) closes
                conn.sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def _want_write(self, conn, want):
        if conn.want_write == want:
            return
        conn.want_write = want
        mask = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
        try:
            self._sel.modify(conn.sock, mask, (self._on_conn_event, conn))
        except (KeyError, ValueError, OSError):
            pass  # already unregistered (racing close)

    def _check_congestion(self):
        now = time.monotonic()
        with self._lock:
            over = [c for c in self._congested
                    if c.congested_at is not None
                    and now - c.congested_at >= self.drain_grace_s]
        for conn in over:
            self._shed_conn(conn)

    def _shed_conn(self, conn):
        """Slow-peer shedding: the backpressure contract's teeth. The
        connection is hard-closed and the death takes the ordinary
        PEER_LOST path, so the resilience layer re-cohorts around it."""
        with self._ctr_lock:
            self.sheds += 1
        logging.warning(
            "eventloop %d: shedding rank %s -- %d bytes queued above the "
            "%d-byte high watermark for %.1fs (slow reader)", self.rank,
            conn.rank, conn.tx_bytes, self.high_watermark,
            self.drain_grace_s)
        reg = get_registry()
        if reg is not None:
            reg.inc("net_backpressure_sheds_total",
                    help="connections shed for staying over the write-"
                         "queue high watermark past the drain grace",
                    transport="eventloop")
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("backpressure_shed", peer=conn.rank,
                      observer=self.rank, queued_bytes=conn.tx_bytes,
                      transport="eventloop")
        self._close_conn(conn, post=True, kind="shed")

    def _close_conn(self, conn, post, kind="eof"):
        """Loop-side connection teardown: unregister, unroute, hard-close;
        ``post`` forwards the death to the dispatcher (which decides
        PEER_LOST vs clean GOODBYE from its own FIFO-ordered state)."""
        with self._lock:
            if conn.dead:
                return  # racing read-error + write-error: close once
            conn.dead = True
            rank = conn.rank
            if rank is not None and self._peers.get(rank) is conn:
                del self._peers[rank]
            self._congested.discard(conn)
            self._kick.discard(conn)
            conn.tx.clear()
            conn.tx_bytes = 0
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        _hard_close(conn.sock)
        if post and rank is not None:
            self._post_rank_item(rank, (kind, rank))

    def _teardown(self):
        """Final hard teardown (loop exit or close() with a dead loop)."""
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
            self._peers.clear()
            self._congested.clear()
            self._kick.clear()
        # parked rejoin HELLOs sit OUTSIDE the selector map: close them
        # explicitly (nothing to rejoin after teardown)
        while self._rejoin_window.deferred:
            conn, _rank = self._rejoin_window.deferred.popleft()
            _hard_close(conn.sock)
        try:  # the selector map also holds mid-handshake connections
            socks = [key.fileobj for key in
                     list(self._sel.get_map().values())]
        except (RuntimeError, OSError):
            socks = []
        for sock in socks:
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
            if sock not in (self._wake_r, self._wake_w):
                _hard_close(sock)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except (OSError, RuntimeError):
            pass
        if self._ingest is not None:
            self._ingest.close()  # drains shards, then workers exit
        self._inbox.put(("stopped",))  # release a blocked dispatcher


__all__ = ["EventLoopCommManager"]
