"""In-process message transport (counterpart of
``fedml_tpu/core/comm/local.py``).

The reference's default transport is MPI-on-localhost with one send thread and
one receive thread per process, a 0.3 s queue poll, and pickled state dicts
(``fedml_core/distributed/communication/mpi/com_manager.py:36-79``). On TPU the
heavy tensors never travel through this layer, so the transport reduces to
per-rank queues with *blocking* delivery -- no poll latency, no daemon threads
to kill with ctypes (reference defect at ``mpi_send_thread.py:47-53``).

Ranks may run as Python threads (distributed-paradigm simulation) or simply as
calls on one thread (standalone). The same manager API also backs the MQTT
bridge, so algorithm managers are transport-agnostic like the reference's.
"""

from __future__ import annotations

import queue
import threading

from fedml_tpu_torch.core.comm.base import (BaseCommunicationManager,
                                      MSG_TYPE_PEER_LOST)
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.observability.flightrec import get_flight_recorder
from fedml_tpu_torch.observability.registry import get_registry


class LocalCommNetwork:
    """A set of connected ranks sharing in-process mailboxes.

    ``serialize=True`` round-trips every message through the binary wire
    codec (``Message.to_bytes``/``from_bytes``) instead of passing the
    object by reference -- the same bytes a TCP/MQTT hop would move, so
    simulation runs can measure ``bytes_on_wire`` (and catch
    non-serializable payloads) without opening sockets. Default ``False``
    keeps the zero-copy in-process behavior.
    """

    def __init__(self, world_size, serialize=False):
        self.world_size = world_size
        self.serialize = bool(serialize)
        self.mailboxes = [queue.Queue() for _ in range(world_size)]

    def manager(self, rank):
        return LocalCommManager(self, rank)

    def announce_lost(self, rank):
        """Deliver ``MSG_TYPE_PEER_LOST`` for ``rank`` to every other
        rank's mailbox -- the in-process analog of the TCP transport's
        EOF-without-GOODBYE synthesis, used by ``LocalCommManager.abort``
        (crash simulation, ``fedml_tpu_torch.resilience.faults``)."""
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("peer_lost", peer=rank, transport="local")
            fr.dump("peer_lost", extra={"peer": rank})
        for other in range(self.world_size):
            if other == rank:
                continue
            lost = Message(MSG_TYPE_PEER_LOST, rank, other)
            self.mailboxes[other].put(
                lost.to_bytes() if self.serialize else lost)


_STOP = object()


class LocalCommManager(BaseCommunicationManager):
    def __init__(self, network: LocalCommNetwork, rank: int):
        self.network = network
        self.rank = rank
        self.bytes_sent = 0  # wire-codec bytes (serialize=True networks)
        self.bytes_received = 0
        self.resends = 0  # frames re-sent by the retry layer
        self._observers = []
        self._running = False

    def add_observer(self, observer):
        self._observers.append(observer)

    def remove_observer(self, observer):
        self._observers.remove(observer)

    def send_message(self, msg: Message, is_resend=False):
        receiver = msg.get_receiver_id()
        if is_resend:
            self.resends += 1
        nbytes = 0
        if self.network.serialize:
            payload = msg.to_bytes()
            nbytes = len(payload)
            self.bytes_sent += nbytes
            self.network.mailboxes[receiver].put(payload)
        else:
            self.network.mailboxes[receiver].put(msg)
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("send", type=msg.get_type(), src=self.rank,
                      dst=receiver, bytes=nbytes, transport="local",
                      resend=bool(is_resend))
        reg = get_registry()
        if reg is not None:
            if nbytes:
                reg.inc("comm_bytes_total", nbytes,
                        help="control-plane payload bytes by direction",
                        transport="local", direction="sent")
            if is_resend:
                reg.inc("comm_resends_total",
                        help="frames re-sent by the retry layer",
                        transport="local")

    def handle_receive_message(self):
        """Blocking receive loop dispatching to observers until stopped."""
        self._running = True
        box = self.network.mailboxes[self.rank]
        while self._running:
            msg = box.get()
            if msg is _STOP:
                break
            nbytes = 0
            if isinstance(msg, (bytes, bytearray)):
                nbytes = len(msg)
                self.bytes_received += nbytes
                msg = Message.from_bytes(msg)
            fr = get_flight_recorder()
            if fr is not None:
                fr.record("recv", type=msg.get_type(),
                          src=msg.get_sender_id(), dst=self.rank,
                          bytes=nbytes, transport="local")
            reg = get_registry()
            if reg is not None and nbytes:
                reg.inc("comm_bytes_total", nbytes,
                        help="control-plane payload bytes by direction",
                        transport="local", direction="received")
            for obs in self._observers:
                obs.receive_message(msg.get_type(), msg)

    def stop_receive_message(self):
        self._running = False
        self.network.mailboxes[self.rank].put(_STOP)

    def abort(self):
        """Crash simulation: stop our own loop WITHOUT a clean shutdown
        handshake and tell every peer we are gone (the in-process analog
        of a TCP EOF-without-GOODBYE)."""
        self._running = False
        self.network.mailboxes[self.rank].put(_STOP)
        self.network.announce_lost(self.rank)


def run_ranks_in_threads(targets):
    """Run one callable per rank in its own thread and join all -- the
    replacement for ``mpirun -np N`` on localhost (reference
    ``run_fedavg_distributed_pytorch.sh:18-38``)."""
    threads = [threading.Thread(target=t, daemon=True, name=f"rank-{i}")
               for i, t in enumerate(targets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
