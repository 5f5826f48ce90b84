"""TCP socket transport: real cross-process messaging for the control plane
(counterpart of ``fedml_tpu/core/comm/tcp.py``; its frames byte for byte).

Closes the gap the in-process ``local`` backend leaves (reference parity
target: the MPI backend, ``fedml_core/distributed/communication/mpi/
com_manager.py:13-98``, which is inherently multi-process). Design differs
deliberately from the reference's send/receive daemon pair with 0.3 s queue
polling and ctypes thread kills:

- rank 0 listens; every rank dials rank 0 and identifies itself with a
  HELLO frame. Messages route through rank 0 (star topology -- exactly the
  reference's FedAvg communication pattern, where all traffic is
  server<->client anyway; peer-to-peer algorithms use the SPMD collectives
  data plane, not this layer).
- frames are length-prefixed ``Message.to_bytes()`` payloads: a binary
  envelope (``fedml_tpu_torch.compression.codec``) whose control fields stay
  JSON while ndarray params ride as raw dtype+shape+buffer frames -- ~10x
  smaller than the previous JSON-nested-list codec for array payloads.
  (The reference pickles python objects over MPI -- a code-execution
  hazard across trust boundaries; this envelope is data-only, and legacy
  all-JSON frames still decode via the first-byte sniff.) Pass
  ``binary=False`` to emit the legacy JSON frames instead.
- the receive loop is a blocking ``recv`` dispatching to observers; STOP
  is an in-band frame, so shutdown needs no thread assassination.

Heavy tensors still never travel here: on TPU the model/update plane is XLA
collectives; this layer carries control/metadata for the cross-silo and
device-bridge paradigms (same role as ``mqtt.py``, without a broker).
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time

from fedml_tpu_torch.core.locks import audited_lock, io_lock
from fedml_tpu_torch.observability.flightrec import get_flight_recorder
from fedml_tpu_torch.observability.registry import get_registry
from fedml_tpu_torch.compression.codec import (DECODE_ERRORS, MAGIC,
                                         message_from_header,
                                         message_from_wire,
                                         parse_wire_header)
from fedml_tpu_torch.core.comm.base import (BaseCommunicationManager,
                                      MSG_TYPE_PEER_JOIN,
                                      MSG_TYPE_PEER_LOST, RejoinWindow)
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.net.ingest import note_ingest

_HDR = struct.Struct("!I")
_MAX_FRAME = 256 * 1024 * 1024

#: In-band clean-shutdown frame from a client: distinguishes "this rank is
#: done and hanging up" from a crash, so only EOF-without-GOODBYE raises
#: MSG_TYPE_PEER_LOST at the server.
MSG_TYPE_GOODBYE = "__goodbye__"


def _send_frame(sock, payload: bytes):
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    """Exactly ``n`` bytes into a fresh ``bytearray`` via ``recv_into``
    (no per-chunk concat copies); the buffer is per-frame and handed
    off whole, so the codec's zero-copy decode may alias it."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return buf


def _enable_keepalive(sock, idle=60, interval=10, count=5):
    """Dead-peer detection at the federated-round timescale: without
    tuning, Linux's first keepalive probe fires after tcp_keepalive_time
    (default 7200 s) -- useless against a powered-off peer mid-run. With
    these values a dead transport surfaces in ~idle + interval*count
    (~2 min) while idle-but-alive peers stay connected indefinitely."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", idle), ("TCP_KEEPINTVL", interval),
                     ("TCP_KEEPCNT", count)):
        if hasattr(socket, opt):  # Linux; other OSes keep their defaults
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)


def _recv_frame(sock) -> bytes:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if n > _MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds limit")
    return _recv_exact(sock, n)


def _hard_close(sock):
    # shutdown() before close(): closing an fd does NOT wake a thread
    # blocked in recv() on it (the fd can even be reused under it);
    # shutdown(SHUT_RDWR) interrupts the recv with EOF deterministically
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class TcpCommManager(BaseCommunicationManager):
    """Star-topology TCP transport.

    Args:
      host/port: rank 0's listen address (clients dial it).
      rank: 0 = server (listens), >0 = client.
      world_size: total ranks (server waits for world_size-1 HELLOs).
    """

    def __init__(self, host, port, rank, world_size, timeout=60.0,
                 binary=True, metrics_logger=None, rejoin_burst=16,
                 rejoin_window_s=1.0):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self._binary = bool(binary)
        # rejoin-storm rate limit (rank 0): at most rejoin_burst
        # re-admissions per rejoin_window_s sliding window. A healed
        # partition HELLOs everyone back at once; unthrottled, the
        # admission burst (serve threads + PEER_JOIN dispatch + per-rank
        # re-sync each) lands on the FSM as one spike. Excess HELLOs are
        # DEFERRED -- the connection parks with its handshake held, and
        # admits as the window refills -- never dropped; counted by
        # fed_peer_rejoins_deferred_total.
        self.rejoin_burst = max(1, int(rejoin_burst))
        self.rejoin_window_s = float(rejoin_window_s)
        self.rejoins_deferred = 0
        #: payload bytes through this manager (sends + relays / receives),
        #: excluding the 4-byte length prefix; callers can poll these and
        #: forward to MetricsLogger.count_wire for bytes_on_wire accounting
        self.bytes_sent = 0
        self.bytes_received = 0
        #: frames re-sent by the retry layer (resilience.send_with_retry)
        self.resends = 0
        # live wire accounting: every outbound payload (sends + relays)
        # feeds count_wire as it happens. A RESENT frame counts its bytes
        # again but its raw (logical) payload only once, so the logged
        # compression_ratio honestly degrades under retries instead of
        # pretending the retry was free.
        self._metrics = metrics_logger
        self._observers = []
        self._running = False
        # _lock guards peer membership + the _lost_notified dedup set;
        # per-peer _send_locks (and the client's single _send_lock)
        # serialize the blocking frame writes per connection so one
        # stalled peer (full OS send buffer) can only wedge sends TO that
        # peer, never the membership lock or the whole hub. The split is
        # load-bearing: a frame write under _lock would let one wedged
        # pipe block peer-lost dispatch and membership changes (fedcheck
        # FL125); _ctr_lock keeps the wire counters exact when several
        # serve threads count concurrently (FL123 lost-update hazard).
        self._lock = audited_lock()
        self._ctr_lock = audited_lock()
        self._send_locks = {}
        self._lost_notified = set()  # see _notify_peer_lost
        self._serve_threads = []   # rank 0: live + finished serve threads
        # (guarded by _lock; grows when a shed/crashed rank REJOINS --
        # the accept loop keeps running for the life of the receive loop)
        self._loop_active = False  # client receive loop running?
        self._stopping = False  # our own teardown (quenches PEER_LOST)
        if self.rank == 0:
            self._listener = socket.create_server((host, port))
            self._listener.settimeout(timeout)
            self._peers = {}
            for _ in range(self.world_size - 1):
                conn, _addr = self._listener.accept()
                conn.settimeout(timeout)
                hello = json.loads(_recv_frame(conn).decode())
                peer_rank = int(hello["rank"])
                if (peer_rank in self._peers or peer_rank <= 0
                        or peer_rank >= self.world_size):
                    conn.close()
                    raise ValueError(
                        f"invalid HELLO rank {peer_rank} for world size "
                        f"{self.world_size} (duplicate or out-of-range "
                        "rank -- misconfigured launch?)")
                # handshake done: drop the timeout -- long idle gaps
                # (minutes of local training between control messages)
                # must not tear down the transport; TCP keepalive still
                # detects a dead peer vs an idle one
                conn.settimeout(None)
                _enable_keepalive(conn)
                self._peers[peer_rank] = conn
                self._send_locks[peer_rank] = io_lock()
        else:
            # retry the dial until the server is up (launch order between
            # hosts is not coordinated) or the timeout elapses
            deadline = time.monotonic() + timeout
            while True:
                try:
                    self._sock = socket.create_connection(
                        (host, port), timeout=timeout)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.05)
            _send_frame(self._sock, json.dumps({"rank": self.rank}).encode())
            self._sock.settimeout(None)  # see server side: idle != dead
            _enable_keepalive(self._sock)
            self._send_lock = io_lock()  # serializes pipe writes (see _lock)

    # -- BaseCommunicationManager ----------------------------------------
    def add_observer(self, observer):
        self._observers.append(observer)

    def remove_observer(self, observer):
        self._observers.remove(observer)

    def _count_out(self, nbytes, is_resend=False):
        # several serve threads relay (and the FSM sends) concurrently:
        # unguarded `+=` on the shared counters loses updates
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
                    transport="tcp", direction="sent")
            if is_resend:
                reg.inc("comm_resends_total",
                        help="frames re-sent by the retry layer",
                        transport="tcp")

    def _count_in(self, nbytes):
        with self._ctr_lock:
            self.bytes_received += nbytes
        reg = get_registry()
        if reg is not None:
            reg.inc("comm_bytes_total", nbytes,
                    help="control-plane payload bytes by direction",
                    transport="tcp", direction="received")

    def send_message(self, msg: Message, is_resend=False):
        receiver = int(msg.get_receiver_id())
        if self.rank == 0 and receiver == 0:
            # self-addressed: dispatch locally -- no serialization, and no
            # bytes_sent (nothing touches the wire)
            self._dispatch(msg)
            return
        payload = msg.to_bytes() if self._binary else msg.to_json().encode()
        self._count_out(len(payload), is_resend=is_resend)
        fr = get_flight_recorder()
        if fr is not None:
            # recorded BEFORE the write: a send that wedges (and triggers
            # the dump) must already be in the ring
            fr.record("send", type=msg.get_type(), src=self.rank,
                      dst=receiver, bytes=len(payload), transport="tcp",
                      resend=bool(is_resend))
        if self.rank == 0:
            with self._lock:
                dest = self._peers.get(receiver)
                slock = self._send_locks.get(receiver)
            if dest is None:
                raise KeyError(
                    f"no connected peer with rank {receiver} (never joined, "
                    "its transport died -- see MSG_TYPE_PEER_LOST -- or it "
                    "said goodbye)")
            try:
                with slock:
                    _send_frame(dest, payload)
            except OSError as e:
                # the peer died between lookup and write: unroute it and
                # dispatch PEER_LOST (dedup'd against its serve thread),
                # then surface a typed error to the direct caller
                self._drop_peer(receiver, lost=True, conn=dest)
                raise ConnectionError(
                    f"peer rank {receiver} transport died mid-send "
                    "(MSG_TYPE_PEER_LOST dispatched)") from e
        else:
            # clients have one pipe -- to the server; rank 0 routes.
            # Mirror the server branch's failure semantics: a dead server
            # mid-send must dispatch PEER_LOST (sends can fail before the
            # receive loop has ever started) and raise a typed error.
            # _send_lock, not _lock: a wedged pipe write must never block
            # _notify_peer_lost / membership state behind it (FL125)
            try:
                with self._send_lock:
                    _send_frame(self._sock, payload)
            except OSError as e:
                self._notify_peer_lost(0)
                raise ConnectionError(
                    "server (rank 0) transport died mid-send "
                    "(MSG_TYPE_PEER_LOST dispatched)") from e

    def handle_receive_message(self):
        """Blocking receive loop dispatching to observers until STOP."""
        self._running = True
        if self.rank == 0:
            # snapshot under the lock: a concurrent _drop_peer (e.g. a
            # failed send from the FSM's start() thread racing loop
            # startup) must not mutate the dict mid-iteration
            with self._lock:
                peers = list(self._peers.items())
                self._serve_threads = [
                    threading.Thread(target=self._serve_peer,
                                     args=(conn, rank), daemon=True,
                                     name=f"tcp-serve-{rank}")
                    for rank, conn in peers]
                threads = list(self._serve_threads)
            for t in threads:
                t.start()
            # rejoin protocol: keep accepting HELLOs for the life of the
            # loop -- a shed/crashed rank that dials back in is re-routed
            # and announced to the FSM via MSG_TYPE_PEER_JOIN
            accept_thread = threading.Thread(target=self._accept_rejoins,
                                             daemon=True,
                                             name="tcp-accept-rejoins")
            accept_thread.start()
            # dynamic join: rejoins add serve threads after startup, so a
            # fixed join list would miss them. Exit when no serve thread
            # is live AND the run stopped (or every peer is gone with no
            # STOP -- the pre-rejoin semantics, preserved).
            while True:
                with self._lock:
                    threads = list(self._serve_threads)
                live = [t for t in threads if t.is_alive()]
                if live:
                    live[0].join(timeout=0.2)
                    continue
                with self._lock:
                    has_peers = bool(self._peers)
                if not self._running or not has_peers:
                    break
                time.sleep(0.05)  # zero live threads but a rejoin is
                # mid-admission: give its serve thread a tick to appear
            self._running = False
            self._stopping = True
            self.close()
        else:
            self._loop_active = True
            try:
                while True:
                    try:
                        frame = _recv_frame(self._sock)
                    except (ConnectionError, OSError):
                        if self._running:  # EOF without our own shutdown
                            self._notify_peer_lost(0)
                        break
                    if not self._running:
                        # GOODBYE sent, draining until the server FINs us:
                        # closing with unread inbound would RST and could
                        # destroy the GOODBYE still queued at the server
                        continue
                    self._count_in(len(frame))
                    t0 = time.perf_counter()
                    msg = message_from_wire(frame)
                    note_ingest(1, time.perf_counter() - t0, "tcp")
                    fr = get_flight_recorder()
                    if fr is not None:
                        fr.record("recv", type=msg.get_type(),
                                  src=msg.get_sender_id(), dst=self.rank,
                                  bytes=len(frame), transport="tcp")
                    if msg.get_type() == MSG_TYPE_PEER_LOST:
                        logging.warning("tcp client: dropping in-band "
                                        "reserved %s frame",
                                        MSG_TYPE_PEER_LOST)
                        continue
                    if not self._dispatch(msg):
                        break
            finally:
                self._loop_active = False
                self.close()  # release the server's serve thread promptly

    def _accept_rejoins(self):
        """Rejoin protocol (rank 0): accept HELLOs after the initial
        join, for the life of the receive loop. A fresh HELLO from a
        rank that is *not currently routed* (it crashed, was shed, or
        said goodbye) is re-admitted: routed, given a serve thread, its
        peer-lost dedup cleared (a second death must notify again), and
        announced to the observers as ``MSG_TYPE_PEER_JOIN`` so the FSM
        can return it to the alive set. Invalid or duplicate HELLOs
        close the connection -- the loop itself must never die to one
        bad dialer.

        Rejoin-storm rate limiting: admissions are throttled to
        ``rejoin_burst`` per ``rejoin_window_s`` sliding window; excess
        HELLOs park on a deferral queue (connection open, handshake
        held) and admit as the window refills, in arrival order --
        validity (duplicate/out-of-range) is judged at ADMIT time,
        since a deferred rank's state can change while it waits."""
        try:
            self._listener.settimeout(0.25)
        except OSError:
            return  # already closed: teardown won the race
        window = RejoinWindow(self.rejoin_burst, self.rejoin_window_s)
        try:
            while self._running:
                for conn, peer_rank in window.drain():
                    self._admit_rejoin(conn, peer_rank)
                try:
                    conn, _addr = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return  # listener closed: teardown
                try:
                    conn.settimeout(10.0)
                    hello = json.loads(_recv_frame(conn).decode())
                    peer_rank = int(hello["rank"])
                    conn.settimeout(None)  # see __init__: idle != dead
                    _enable_keepalive(conn)
                except (ValueError, KeyError, TypeError, UnicodeDecodeError,
                        ConnectionError, OSError):
                    logging.warning("tcp hub: undecodable rejoin HELLO -- "
                                    "closing")
                    _hard_close(conn)
                    continue
                if not window.try_admit():
                    window.deferred.append((conn, peer_rank))
                    self._note_rejoin_deferred(peer_rank)
                    continue
                self._admit_rejoin(conn, peer_rank)
        finally:
            for conn, _rank in window.deferred:  # teardown: no rejoin
                _hard_close(conn)

    def _admit_rejoin(self, conn, peer_rank):
        """Route one accepted rejoin HELLO (validity judged here)."""
        with self._lock:
            bad = (peer_rank <= 0 or peer_rank >= self.world_size
                   or peer_rank in self._peers)
            if not bad:
                self._peers[peer_rank] = conn
                self._send_locks[peer_rank] = io_lock()
                self._lost_notified.discard(peer_rank)
        if bad:
            logging.warning(
                "tcp hub: rejected rejoin HELLO rank %s (duplicate "
                "or out-of-range for world size %s)", peer_rank,
                self.world_size)
            _hard_close(conn)
            return
        t = threading.Thread(target=self._serve_peer,
                             args=(conn, peer_rank), daemon=True,
                             name=f"tcp-serve-{peer_rank}")
        with self._lock:
            self._serve_threads.append(t)
        t.start()
        logging.warning("tcp hub: rank %d rejoined", peer_rank)
        self._notify_peer_join(peer_rank)

    def _note_rejoin_deferred(self, peer_rank):
        with self._ctr_lock:
            self.rejoins_deferred += 1
        logging.warning("tcp hub: rejoin HELLO rank %s deferred by the "
                        "admission window (%d/%ss)", peer_rank,
                        self.rejoin_burst, self.rejoin_window_s)
        reg = get_registry()
        if reg is not None:
            reg.inc("fed_peer_rejoins_deferred_total",
                    help="rejoin HELLOs deferred by the admission-rate "
                         "window (admitted later, never dropped)",
                    transport="tcp")

    def _serve_peer(self, conn, peer_rank):
        while self._running:
            try:
                frame = _recv_frame(conn)
            except (ConnectionError, OSError):
                # dead peer (no GOODBYE, no STOP): unroute + tell the FSM
                self._drop_peer(peer_rank, lost=True, conn=conn)
                return
            except ValueError:
                # oversized frame header: a desynchronized or hostile
                # stream -- there is no way to resynchronize framing, so
                # the peer is lost (silently dying here would leave it
                # routed with nobody reading its pipe)
                logging.exception("tcp hub: unframeable stream from rank "
                                  "%s", peer_rank)
                self._drop_peer(peer_rank, lost=True, conn=conn)
                return
            self._count_in(len(frame))
            try:
                # header-only peek: the envelope routes the frame; a
                # relayed tensor payload is never decoded at the hub
                # (parity with the event-loop hub's raw re-queue), and
                # a locally-dispatched frame's header JSON is parsed
                # exactly once (split decode via message_from_header)
                msg = None
                if len(frame) >= 1 and frame[0] == MAGIC:
                    header, hoff = parse_wire_header(frame)
                    mtype = str(header[Message.MSG_ARG_KEY_TYPE])
                    receiver = int(header[Message.MSG_ARG_KEY_RECEIVER])
                    if receiver == 0 and mtype not in (MSG_TYPE_GOODBYE,
                                                       MSG_TYPE_PEER_LOST):
                        t0 = time.perf_counter()
                        msg = message_from_header(header, frame, hoff)
                        note_ingest(1, time.perf_counter() - t0, "tcp")
                else:
                    # legacy JSON frames are tiny control messages:
                    # parse whole, once
                    t0 = time.perf_counter()
                    msg = message_from_wire(frame)
                    note_ingest(1, time.perf_counter() - t0, "tcp")
                    mtype = msg.get_type()
                    receiver = int(msg.get_receiver_id())
            except DECODE_ERRORS:
                # malformed payload (corrupt bytes, version skew, unknown
                # wire dtype, truncated array-frame list -> IndexError):
                # the concrete decode failures the codec can raise --
                # treat the peer as lost, loudly. Anything else is a
                # codec bug and should crash this serve thread.
                logging.exception("tcp hub: undecodable frame from rank "
                                  "%s", peer_rank)
                self._drop_peer(peer_rank, lost=True, conn=conn)
                return
            fr = get_flight_recorder()
            if fr is not None:
                fr.record("recv", type=mtype, src=peer_rank,
                          dst=self.rank, bytes=len(frame), transport="tcp")
            if mtype == MSG_TYPE_GOODBYE:
                # clean hang-up: unroute WITHOUT a peer-lost dispatch
                self._drop_peer(peer_rank, lost=False, conn=conn)
                return
            if mtype == MSG_TYPE_PEER_LOST:
                # reserved: transport-synthesized only. An in-band frame
                # of this type (bug or spoof) must not trigger fail-fast
                # for a healthy rank, nor be relayed to one.
                logging.warning("tcp hub: dropping in-band reserved "
                                "%s frame from rank %s",
                                MSG_TYPE_PEER_LOST, peer_rank)
                continue
            if receiver == 0:
                try:
                    keep = self._dispatch(msg)
                except (AttributeError, KeyError, IndexError, TypeError,
                        ValueError, ArithmeticError):
                    # a buggy FSM handler (bad lookup, shape/type mismatch)
                    # must not silently kill this peer's serve thread --
                    # the hub would stop reading a healthy client forever.
                    # Infrastructure failures (OSError, MemoryError, ...)
                    # are NOT survivable-by-logging and propagate.
                    logging.exception(
                        "tcp hub: handler error for type=%s from rank %s",
                        msg.get_type(), peer_rank)
                    keep = True
                if not keep:
                    # client-initiated stop: wave STOP at the remaining
                    # peers BEFORE tearing sockets down -- a bare close()
                    # would EOF healthy siblings without a STOP frame and
                    # their managers would report a server crash on what
                    # is a clean whole-job stop. stop_receive_message
                    # sets _stopping first, so the EOFs it causes never
                    # dispatch PEER_LOST locally either.
                    self.stop_receive_message()
                    return
            else:  # route client->client via hub
                with self._lock:
                    dest = self._peers.get(receiver)
                    slock = self._send_locks.get(receiver)
                if dest is None:  # unroutable: drop loudly, keep pipe alive
                    logging.warning("tcp hub: dropping message for unknown "
                                    "rank %s (type=%s)", receiver, mtype)
                else:
                    try:
                        with slock:
                            _send_frame(dest, frame)
                        self._count_out(len(frame))
                    except OSError:
                        # DESTINATION died mid-relay; its own serve thread
                        # may race to report it -- _drop_peer dedups. The
                        # sender's pipe is healthy: keep serving it.
                        self._drop_peer(receiver, lost=True, conn=dest)

    def _drop_peer(self, peer_rank, lost, conn=None):
        """Unroute a peer; when ``lost`` (EOF/send-failure, not GOODBYE)
        also dispatch MSG_TYPE_PEER_LOST. The pop doubles as dedup: two
        threads can observe the same death (the peer's serve thread and a
        relaying sibling), only the one that wins the pop notifies.

        ``conn`` is the socket the caller observed failing. Since the
        rejoin protocol, a rank can be RE-admitted while a stale send on
        its old socket is still blocked — popping by rank alone would
        then evict (and hard-close) the healthy rejoined connection and
        fire a spurious PEER_LOST. The pop only proceeds when the routed
        connection IS the one that failed; a stale socket is just closed."""
        with self._lock:
            was = self._peers.get(peer_rank)
            if was is not None and (conn is None or was is conn):
                del self._peers[peer_rank]
                self._send_locks.pop(peer_rank, None)
            else:
                was = None
        if was is None:
            if conn is not None:
                _hard_close(conn)  # the stale (already-replaced) socket
            return
        # close eagerly: after the pop, close() can no longer reach this
        # socket, and a CLOSE_WAIT fd must not wait for GC. (Also FINs the
        # peer promptly on the GOODBYE path -- its drain loop exits.)
        _hard_close(was)
        if lost:
            self._notify_peer_lost(peer_rank)

    def _notify_peer_lost(self, peer_rank):
        """Dispatch MSG_TYPE_PEER_LOST unless this is our own shutdown
        tearing the sockets down (then the silence is expected). Note the
        flag is ``_stopping``, not ``_running``: sends can fail (and must
        still notify) before the receive loop has ever started.

        Dedups per peer: on the client, a dead server can be observed by
        BOTH the receive loop's EOF and a concurrent send_message OSError
        (on rank 0 _drop_peer's pop already dedups, but the set costs
        nothing there) -- a re-cohort handler must run once per death."""
        if self._stopping:
            return
        with self._lock:
            if peer_rank in self._lost_notified:
                return
            self._lost_notified.add(peer_rank)
        fr = get_flight_recorder()
        if fr is not None:
            # post-mortem artifact: the ring as of the moment of death
            # (the per-peer dedup above bounds this to one dump per peer)
            fr.record("peer_lost", peer=peer_rank, observer=self.rank,
                      transport="tcp")
            fr.dump("peer_lost", extra={"peer": peer_rank,
                                        "observer": self.rank})
        lost = Message(MSG_TYPE_PEER_LOST, peer_rank, self.rank)
        for obs in list(self._observers):
            obs.receive_message(MSG_TYPE_PEER_LOST, lost)

    def _notify_peer_join(self, peer_rank):
        """Dispatch MSG_TYPE_PEER_JOIN for an accepted rejoin (mirrors
        ``_notify_peer_lost``; no dedup needed -- the accept loop admits
        a rank at most once while it is routed)."""
        if self._stopping:
            return
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("peer_join", peer=peer_rank, observer=self.rank,
                      transport="tcp")
        reg = get_registry()
        if reg is not None:
            reg.inc("fed_peer_rejoins_total",
                    help="previously lost/shed ranks re-admitted by a "
                         "fresh HELLO", transport="tcp")
        joined = Message(MSG_TYPE_PEER_JOIN, peer_rank, self.rank)
        for obs in list(self._observers):
            obs.receive_message(MSG_TYPE_PEER_JOIN, joined)

    def _dispatch(self, msg: Message) -> bool:
        if msg.get_type() == "__stop__":
            self._running = False
            return False
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)
        return True

    def stop_receive_message(self):
        self._running = False
        self._stopping = True
        if self.rank == 0:
            with self._lock:
                peers = list(self._peers.items())
                slocks = dict(self._send_locks)
            for r, conn in peers:
                # bounded acquire: a relay/send thread wedged in sendall
                # (destination alive but not reading -- a full send
                # buffer still ACKs keepalives, so the keepalive never
                # fires) must not block shutdown forever. On timeout we
                # skip the wave for that peer; the close below force-
                # closes its pipe, which also wakes the wedged sendall.
                if not slocks[r].acquire(timeout=2.0):
                    continue
                try:
                    _send_frame(conn, Message("__stop__", 0, r)
                                .to_json().encode())
                except OSError:
                    pass  # peer died as we were waving; close handles it
                finally:
                    slocks[r].release()
            # SHUT_WR, not an immediate close: closing with unread
            # inbound (a peer mid-send at stop time) RSTs and can destroy
            # the STOP frame still in flight -- the same hazard the
            # client GOODBYE path documents. FIN delivers the STOP; each
            # peer drains, stops, and closes, which lets the serve
            # threads exit and the receive loop run close() itself. The
            # timer bounds the wait if a peer never closes (or no
            # receive loop is running to reap the sockets).
            for r, conn in peers:
                try:
                    conn.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
            t = threading.Timer(5.0, self.close)
            t.daemon = True
            t.start()
        else:
            # in-band goodbye: lets the server tell a clean hang-up from
            # a crash (EOF alone now means MSG_TYPE_PEER_LOST there).
            # SHUT_WR (not close) so inbound can still be drained -- an
            # immediate close with unread inbound data would RST and
            # could destroy the queued GOODBYE server-side. Bounded
            # acquire, mirroring the server's STOP wave: a handler
            # wedged mid-send (server alive but not reading) must not
            # block shutdown forever -- on timeout we skip the GOODBYE
            # (the server will see a PEER_LOST-grade EOF, which is
            # honest: this pipe IS wedged) and the shutdown/hard-close
            # below still wakes the stuck sendall.
            if self._send_lock.acquire(timeout=2.0):
                try:
                    _send_frame(self._sock,
                                Message(MSG_TYPE_GOODBYE, self.rank, 0)
                                .to_json().encode())
                except OSError:
                    pass
                finally:
                    self._send_lock.release()
            try:
                self._sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            if self._loop_active:
                # the receive loop drains to EOF, then close()s. Bound
                # that: if the server never consumes the GOODBYE (alive
                # but stuck), force-close so the blocked recv wakes --
                # SHUT_WR alone cannot unblock an in-flight recv
                t = threading.Timer(5.0, lambda: _hard_close(self._sock))
                t.daemon = True
                t.start()
                return
            try:  # no loop running: drain inline (bounded) before close
                self._sock.settimeout(5.0)
                while self._sock.recv(65536):
                    pass
            except OSError:
                pass
            self.close()

    def abort(self):
        """Die abruptly -- crash simulation (``fedml_tpu_torch.resilience``).

        No GOODBYE, no STOP wave: sockets are hard-closed, so every peer
        observes EOF-without-GOODBYE and raises MSG_TYPE_PEER_LOST, exactly
        as a power-off would look. ``_stopping`` is set first so our own
        receive loop's EOF does not dispatch PEER_LOST locally."""
        self._running = False
        self._stopping = True
        self.close()

    def close(self):
        if self.rank == 0:
            with self._lock:
                peers = list(self._peers.values())
            for conn in peers:
                _hard_close(conn)
            try:
                self._listener.close()
            except OSError:
                pass
        else:
            _hard_close(self._sock)


__all__ = ["TcpCommManager", "MSG_TYPE_PEER_LOST", "MSG_TYPE_PEER_JOIN",
           "MSG_TYPE_GOODBYE"]
