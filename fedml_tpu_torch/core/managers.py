"""Client/Server manager FSMs for the distributed paradigm (counterpart
of ``fedml_tpu/core/managers.py``).

Parity with reference ``fedml_core/distributed/client/client_manager.py:12-64``
and ``server/server_manager.py:11-57``: a handler registry keyed by message
type, a blocking receive loop, and ``finish()``. The reference terminated via
``MPI.COMM_WORLD.Abort()``; here ``finish()`` stops the receive loop cleanly.
"""

from __future__ import annotations

import logging

from fedml_tpu_torch.core.comm.base import MSG_TYPE_PEER_LOST, Observer
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.observability.flightrec import get_flight_recorder
from fedml_tpu_torch.observability.tracing import get_tracer


class DistributedManager(Observer):
    def __init__(self, args, comm_manager, rank=0, size=0):
        self.args = args
        self.size = size
        self.rank = rank
        self.com_manager = comm_manager
        self.com_manager.add_observer(self)
        self.message_handler_dict = {}
        self._lost_peer = None

    def run(self):
        self.register_message_receive_handlers()
        self.com_manager.handle_receive_message()
        if self._lost_peer is not None:
            raise RuntimeError(
                f"rank {self.rank}: peer rank {self._lost_peer} died "
                "mid-protocol (transport reported peer-lost and no "
                f"'{MSG_TYPE_PEER_LOST}' handler is registered). Failing "
                "fast instead of waiting forever; register a handler for "
                "this type to re-cohort/continue instead.")

    def get_sender_id(self):
        return self.rank

    def receive_message(self, msg_type, msg_params) -> None:
        handler = self.message_handler_dict.get(str(msg_type))
        if handler is None:
            if str(msg_type) == MSG_TYPE_PEER_LOST:
                # default fail-fast: stop the receive loop; run() raises
                # once handle_receive_message unwinds (an exception here
                # would die inside the transport's serve thread instead)
                self._lost_peer = msg_params.get_sender_id()
                fr = get_flight_recorder()
                if fr is not None:
                    fr.record("fail_fast", rank=self.rank,
                              lost_peer=self._lost_peer)
                self.finish()
                return
            fr = get_flight_recorder()
            if fr is not None:
                fr.record("no_handler", rank=self.rank, type=str(msg_type))
            logging.warning("rank %d: no handler for message type %s", self.rank, msg_type)
            return
        # cross-rank span stitching (fedml_tpu_torch.observability.tracing): a
        # sender-injected trace context becomes this thread's current
        # parent for the handler's own spans; no-op tracer extracts None
        tracer = get_tracer()
        ctx = tracer.extract(msg_params) if tracer.enabled else None
        if ctx is not None:
            with tracer.remote_context(ctx):
                handler(msg_params)
        else:
            handler(msg_params)

    def receive_message_batch(self, msg_type, msgs) -> None:
        """Batched dispatch hook: a chunk-draining transport (the event
        loop's dispatcher) hands a run of consecutive same-type messages
        here in FIFO order. The default is the per-message loop --
        bitwise-identical to N ``receive_message`` calls -- so only FSMs
        that explicitly implement a batched handler (the buffered async
        server's one-lock batched fold) ever behave differently, and
        even those must preserve the per-message trajectory exactly."""
        for msg in msgs:
            self.receive_message(msg_type, msg)

    def send_message(self, message: Message):
        tracer = get_tracer()
        if tracer.enabled:
            # carry the sender's current span context in the envelope's
            # __trace__ control field (JSON header of the binary codec)
            tracer.inject(message)
        self.com_manager.send_message(message)

    def register_message_receive_handlers(self) -> None:
        raise NotImplementedError

    def register_message_receive_handler(self, msg_type, handler_callback_func):
        self.message_handler_dict[str(msg_type)] = handler_callback_func

    def finish(self):
        self.com_manager.stop_receive_message()


class ClientManager(DistributedManager):
    """Base for per-client protocol FSMs."""


class ServerManager(DistributedManager):
    """Base for the rank-0 server protocol FSM."""
