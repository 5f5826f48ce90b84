"""Backend-neutral communication abstraction (counterpart of
``fedml_tpu/core/comm/base.py``).

Interface parity with reference ``fedml_core/distributed/communication/
base_com_manager.py:7-27`` and ``observer.py:4-7``. Concrete backends:
``local`` (in-process queues, for simulation and tests), ``tcp`` (real
cross-process byte transport, the MPI-backend analog), ``mqtt`` (device
bridge, optional), and the ICI data plane which needs no manager at all --
it is XLA collectives inside the jitted round step.
"""

from __future__ import annotations

import abc
import time
from collections import deque

#: Synthesized by transports when a peer's pipe dies WITHOUT a clean in-band
#: shutdown (process crash, power-off, network partition). ``sender_id`` is
#: the lost rank. ``DistributedManager`` fails fast on it by default (the
#: reference's aggregator blocks forever on a dead client,
#: ``FedAVGAggregator.py:50-56``); FSMs may register a handler to re-cohort
#: instead.
MSG_TYPE_PEER_LOST = "__peer_lost__"

#: Synthesized by transports when a previously-known rank's fresh HELLO is
#: accepted *after* the initial join (the rejoin protocol: a shed or
#: crashed client dialing back in). ``sender_id`` is the rejoined rank.
#: FSMs may register a handler to re-admit the rank to the alive set and
#: future cohorts; without one the event is logged and dropped (rejoin
#: then only restores the transport route, not cohort membership).
MSG_TYPE_PEER_JOIN = "__peer_join__"


class RejoinWindow:
    """Sliding-window admission limiter for rejoin HELLOs, shared by the
    threaded tcp hub and the event-loop hub so the contract cannot
    diverge: at most ``burst`` re-admissions per ``window_s``; excess
    arrivals park on ``deferred`` (connection open, handshake held) and
    admit in arrival order as the window refills -- deferred, never
    dropped. Single-consumer: each transport drives it from the one
    thread that owns its accept path (no lock)."""

    def __init__(self, burst, window_s):
        self.burst = max(1, int(burst))
        self.window_s = float(window_s)
        self._admits = deque()   # monotonic admission times in the window
        self.deferred = deque()  # (conn, rank) parked by the limiter

    def _prune(self, now):
        while self._admits and now - self._admits[0] > self.window_s:
            self._admits.popleft()

    def try_admit(self):
        """One fresh arrival: True = admitted (counted against the
        window); False = the caller must park it on ``deferred`` (a
        fresh arrival never jumps ahead of earlier parks)."""
        now = time.monotonic()
        self._prune(now)
        if self.deferred or len(self._admits) >= self.burst:
            return False
        self._admits.append(now)
        return True

    def drain(self):
        """Yield parked ``(conn, rank)`` entries admissible now, oldest
        first, counting each against the window."""
        self._prune(time.monotonic())
        while self.deferred and len(self._admits) < self.burst:
            self._admits.append(time.monotonic())
            yield self.deferred.popleft()


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type, msg_params) -> None:
        ...


class BaseCommunicationManager(abc.ABC):
    """Transport contract. Two optional extensions the concrete backends
    (local/tcp/mqtt) all implement and ``fedml_tpu_torch.resilience``
    relies on:

    - ``send_message(msg, is_resend=False)``: the retry layer flags
      resends so wire accounting counts the re-sent bytes without
      double-counting the logical payload.
    - ``abort()``: die abruptly (no clean-shutdown handshake) so peers
      observe :data:`MSG_TYPE_PEER_LOST` -- the fault-injection harness's
      crash primitive.
    """

    @abc.abstractmethod
    def send_message(self, msg):
        ...

    @abc.abstractmethod
    def add_observer(self, observer: Observer):
        ...

    @abc.abstractmethod
    def remove_observer(self, observer: Observer):
        ...

    @abc.abstractmethod
    def handle_receive_message(self):
        ...

    @abc.abstractmethod
    def stop_receive_message(self):
        ...
