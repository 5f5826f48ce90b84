"""Resilience policies: send retry/backoff, over-selection, deadlines
(counterpart of ``fedml_tpu/resilience/policy.py``).

The reference's server protocol blocks forever on the slowest client
(``FedAVGAggregator.py:50-56``); Bonawitz et al. (MLSys 2019, §3) replace
that with the pace-steering triple this module implements:

- **over-selection**: select ``ceil((1+eps) * C)`` clients, aggregate the
  first ``C`` reports (:meth:`RoundPolicy.select_count`);
- **report deadline**: when the timer fires with at least ``quorum * C``
  reports the round completes *degraded* over the reporting subset;
- **abandonment**: below quorum the round is abandoned and re-run with a
  fresh cohort (:class:`RoundController` raises the ``abandoned`` outcome;
  the integration layer re-samples with an incremented attempt counter).

Plus the transport-side half: :func:`send_with_retry` wraps control-plane
sends in bounded exponential backoff and, once the cap is exhausted,
dispatches ``MSG_TYPE_PEER_LOST`` to the manager's observers -- a peer we
cannot reach after retries is indistinguishable from a dead one, and the
FSM's existing peer-lost path (re-cohort or fail-fast) takes over.

Aggregation over the reporting subset renormalizes by construction:
:func:`aggregate_reports` divides by the *reporting* clients' sample total,
never the selected cohort's, so a dropped client shifts weight to its
surviving peers instead of biasing the average toward zero.

The policy/fold primitives themselves now live in
:mod:`fedml_tpu_torch.program` (the one ``RoundProgram`` subsystem behind both
paradigms): ``RoundPolicy`` is the program's
:class:`~fedml_tpu_torch.program.cohort.CohortPolicy` and
``fold_entries_fp64`` / ``aggregate_reports`` are the program's
aggregation leg, re-exported here under their historical names. This
module keeps what is genuinely control-plane: the retry/backoff layer
and the deadline-driven :class:`RoundController`.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

from fedml_tpu_torch.core.comm.base import MSG_TYPE_PEER_LOST
from fedml_tpu_torch.core.locks import audited_lock
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.observability.flightrec import get_flight_recorder
from fedml_tpu_torch.observability.registry import get_registry
from fedml_tpu_torch.program.aggregation import (  # noqa: F401 (re-export)
    aggregate_reports, fold_entries_fp64)
from fedml_tpu_torch.program.cohort import CohortPolicy as RoundPolicy


class PeerUnreachableError(ConnectionError):
    """Raised by :func:`send_with_retry` after the retry cap: the receiver
    is treated as lost (``MSG_TYPE_PEER_LOST`` has been dispatched)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for one control-plane send.

    ``delay(k)`` for attempt k (0-based) is ``base_delay * multiplier**k``
    capped at ``max_delay``; ``timeout_s`` bounds the whole message
    (attempts stop when the budget is spent even if retries remain)."""

    max_retries: int = 3
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    timeout_s: float = 30.0

    def delay(self, attempt: int) -> float:
        return min(self.base_delay * self.multiplier ** attempt,
                   self.max_delay)


def send_with_retry(comm, msg: Message, policy: RetryPolicy,
                    counters=None, sleep=time.sleep,
                    clock=time.monotonic) -> int:
    """Send ``msg`` through ``comm`` with retry + exponential backoff.

    Returns the number of retries used (0 = first try worked). Retries
    count into ``counters["retries"]`` when a dict is passed. Resends are
    flagged to the transport (``is_resend=True``) so wire accounting stays
    honest: the resent frame's bytes hit ``bytes_on_wire`` again while the
    logical payload is counted once (see ``TcpCommManager.send_message``).

    On exhaustion (or a spent ``timeout_s`` budget) the receiver is
    declared lost: ``MSG_TYPE_PEER_LOST`` is dispatched to ``comm``'s
    observers (via the transport's own ``_notify_peer_lost`` when it has
    one, so dedup applies) and :class:`PeerUnreachableError` is raised.
    """
    deadline = clock() + policy.timeout_s
    attempt = 0
    while True:
        try:
            comm.send_message(msg, is_resend=attempt > 0)
            return attempt
        except (ConnectionError, OSError, KeyError) as e:
            # KeyError: the tcp hub unrouted the peer (died or never
            # joined) -- same disposition as a failed write
            last = e
        attempt += 1
        if attempt > policy.max_retries or clock() >= deadline:
            receiver = int(msg.get_receiver_id())
            logging.warning(
                "send_with_retry: giving up on rank %s after %d attempt(s) "
                "(%s); declaring peer lost", receiver, attempt, last)
            _dispatch_peer_lost(comm, receiver)
            raise PeerUnreachableError(
                f"rank {receiver} unreachable after {attempt} attempt(s): "
                f"{last}") from last
        if counters is not None:
            counters["retries"] = counters.get("retries", 0) + 1
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("retry", dst=int(msg.get_receiver_id()),
                      type=msg.get_type(), attempt=attempt,
                      backoff_s=policy.delay(attempt - 1))
        reg = get_registry()
        if reg is not None:
            reg.inc("fed_send_retries_total",
                    help="control-plane send retries (backoff layer)")
        sleep(policy.delay(attempt - 1))


def _dispatch_peer_lost(comm, receiver):
    notify = getattr(comm, "_notify_peer_lost", None)
    if notify is not None:  # transport-native path dedups per peer
        notify(receiver)  # (tcp also flight-records + dumps there)
        return
    fr = get_flight_recorder()
    if fr is not None:
        fr.record("peer_lost", peer=receiver, transport="retry-layer")
        fr.dump("peer_lost", extra={"peer": receiver})
    lost = Message(MSG_TYPE_PEER_LOST, receiver, getattr(comm, "rank", 0))
    for obs in list(getattr(comm, "_observers", [])):
        obs.receive_message(MSG_TYPE_PEER_LOST, lost)


#: RoundController outcomes.
ROUND_COMPLETE = "complete"    # target reports arrived
ROUND_DEGRADED = "degraded"    # deadline hit with quorum <= reports < target
ROUND_ABANDONED = "abandoned"  # below quorum at the deadline (or cohort died)


class RoundController:
    """Deadline-based report collector for one round attempt at a time.

    Thread-safe: reports arrive on transport serve threads, the deadline
    fires on a timer thread, and peer-lost notifications can come from
    either. Exactly one of ``on_complete(reports, outcome)`` /
    ``on_abandoned(reports)`` fires per ``begin()``; late, duplicate and
    overflow reports are counted, not aggregated (over-selection's surplus
    reports land in ``counters["overflow_reports"]`` by design).
    """

    def __init__(self, policy: RoundPolicy, on_complete, on_abandoned,
                 timer_factory=threading.Timer):
        self.policy = policy
        self._on_complete = on_complete
        self._on_abandoned = on_abandoned
        self._timer_factory = timer_factory
        self._lock = audited_lock()
        self._timer = None
        self._round = None
        self._attempt = None
        self._decided = True  # nothing in flight yet
        self.counters = {"late_reports": 0, "duplicate_reports": 0,
                         "overflow_reports": 0}

    def begin(self, round_idx: int, attempt: int, cohort, target: int):
        """Open collection for (round_idx, attempt) over ``cohort`` ranks;
        the round completes at ``target`` accepted reports."""
        with self._lock:
            if not self._decided:
                raise RuntimeError("previous round attempt still open")
            self._round, self._attempt = int(round_idx), int(attempt)
            self._cohort = set(int(r) for r in cohort)
            self._target = int(target)
            self._reports = {}
            self._lost = set()
            self._decided = False
            if self.policy.deadline_s > 0:
                # the timer carries its (round, attempt) generation:
                # cancel() cannot stop a callback already blocked on the
                # lock, and a stale timer must never decide the NEXT
                # attempt it happens to wake up inside
                self._timer = self._timer_factory(
                    self.policy.deadline_s, self._on_deadline,
                    args=(self._round, self._attempt))
                self._timer.daemon = True
                self._timer.start()

    def report(self, round_idx, attempt, rank, num_samples, payload) -> bool:
        """Returns True when the report was accepted into this attempt."""
        rank = int(rank)
        with self._lock:
            if (self._decided or int(round_idx) != self._round
                    or int(attempt) != self._attempt
                    or rank not in self._cohort):
                self.counters["late_reports"] += 1
                return False
            if rank in self._reports:
                self.counters["duplicate_reports"] += 1
                return False
            if len(self._reports) >= self._target:
                # over-selection surplus: the first `target` reports win
                self.counters["overflow_reports"] += 1
                return False
            self._reports[rank] = (float(num_samples), payload)
            done = len(self._reports) >= self._target
            if done:
                decision = self._decide_locked(ROUND_COMPLETE)
        if done:
            self._fire(decision)
        return True

    def admit(self, round_idx, attempt, rank) -> bool:
        """Mid-round cohort admission: add a rejoined rank to the OPEN
        (round_idx, attempt) so its report is accepted into *this*
        attempt instead of idling to the next round. The target is
        unchanged -- the resumed rank fills in for a lost or straggling
        cohort member rather than extending the round -- and a rank
        counted lost is un-lost (its fresh report is the recovery the
        resume exists for). Returns True when the rank was admitted;
        False when nothing is open, the generation moved on, or the
        rank is already in the cohort."""
        rank = int(rank)
        with self._lock:
            if (self._decided or int(round_idx) != self._round
                    or int(attempt) != self._attempt
                    or rank in self._cohort):
                return False
            self._cohort.add(rank)
            self._lost.discard(rank)
            return True

    def peer_lost(self, rank) -> None:
        """A cohort member died mid-round. When everyone still outstanding
        is dead the attempt resolves immediately instead of burning the
        rest of the deadline."""
        with self._lock:
            if self._decided:
                return
            self._lost.add(int(rank))
            outstanding = self._cohort - set(self._reports) - self._lost
            if outstanding or len(self._reports) >= self._target:
                return  # timer (or the target report) will decide
            decision = self._decide_locked(
                ROUND_DEGRADED if self._quorum_met_locked()
                else ROUND_ABANDONED)
        self._fire(decision)

    def _on_deadline(self, round_idx, attempt):
        with self._lock:
            if (self._decided or round_idx != self._round
                    or attempt != self._attempt):
                return  # stale generation: a newer attempt owns the round
            decision = self._decide_locked(
                ROUND_DEGRADED if self._quorum_met_locked()
                else ROUND_ABANDONED)
        self._fire(decision)

    def _quorum_met_locked(self):
        return len(self._reports) >= self.policy.quorum_count(self._target)

    def _decide_locked(self, outcome):
        self._decided = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        # the decision tuple carries its own generation: _fire runs
        # OUTSIDE the lock (turnover callbacks may re-enter begin), so by
        # the time it logs, self._round may already belong to the NEXT
        # attempt -- reading it there is a data race
        return (outcome, dict(self._reports), self._round, self._attempt,
                self._target)

    def _fire(self, decision):
        outcome, reports, round_idx, attempt, target = decision
        logging.info("round %s attempt %s: %s with %d/%d reports",
                     round_idx, attempt, outcome, len(reports), target)
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("round_decision", outcome=outcome, round=round_idx,
                      attempt=attempt, reports=len(reports), target=target)
            if outcome == ROUND_ABANDONED:
                fr.dump("abandoned_round",
                        extra={"round": round_idx, "attempt": attempt,
                               "reports": len(reports), "target": target})
        reg = get_registry()
        if reg is not None:
            reg.inc("fed_round_attempts_total",
                    help="round-attempt decisions by outcome",
                    outcome=outcome)
        if outcome == ROUND_ABANDONED:
            self._on_abandoned(reports)
        else:
            self._on_complete(reports, outcome)

    def cancel(self):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._decided = True


__all__ = ["RetryPolicy", "RoundPolicy", "RoundController",
           "PeerUnreachableError", "send_with_retry", "aggregate_reports",
           "fold_entries_fp64",
           "ROUND_COMPLETE", "ROUND_DEGRADED", "ROUND_ABANDONED"]
