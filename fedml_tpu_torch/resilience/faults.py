"""Deterministic fault injection for the control-plane transports
(counterpart of ``fedml_tpu/resilience/faults.py``, decision for decision).

Production FL is defined by churn (Bonawitz et al., MLSys 2019 §3: devices
drop out of every round), but a test suite cannot wait for real networks to
misbehave. This module makes every failure mode a *scheduled, seeded event*:
a :class:`FaultPlan` compiles a set of :class:`FaultRule`\\ s into per-rank
action streams, and :class:`FaultyCommManager` wraps any
``BaseCommunicationManager`` (local, tcp, mqtt) to apply them at send time.
Two runs with the same plan and the same per-rank send sequences take
byte-identical fault decisions -- the property the chaos tests pin.

Faults are injected on the *send* side only: each rank's outbound sequence
is totally ordered (one sender thread), so per-rank decisions are
reproducible even though cross-rank interleaving is not. Supported actions:

- ``drop``      -- the message never reaches the wire.
- ``delay``     -- the send happens ``delay_s`` late (straggler).
- ``stall``     -- like ``delay``, but the intent is "past the server's
                   report deadline"; kept distinct so schedules read as the
                   failure they model.
- ``duplicate`` -- the frame is sent twice (at-least-once transports).
- ``reorder``   -- the message is held back and sent after the *next*
                   outbound message (pending holds flush on stop/kill).
- ``kill``      -- the rank dies: every later send/receive is swallowed and
                   the transport is severed abruptly (no GOODBYE), so the
                   server observes ``MSG_TYPE_PEER_LOST``, exactly like a
                   powered-off client.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from fedml_tpu_torch.core.locks import audited_lock
from fedml_tpu_torch.core.comm.base import (BaseCommunicationManager,
                                      MSG_TYPE_PEER_LOST)
from fedml_tpu_torch.core.message import Message

ACTIONS = ("drop", "delay", "stall", "duplicate", "reorder", "kill")


@dataclass(frozen=True)
class FaultRule:
    """One scheduled (or probabilistic) fault.

    Matching is per sending rank over that rank's outbound messages:

      rank:     sending rank the rule applies to (None = every rank).
      msg_type: only messages of this type count as matches (None = all;
                transport-internal frames never match).
      nth:      fire on the nth matching message, 1-based (exact,
                deterministic). Mutually exclusive with ``p``.
      p:        fire with probability ``p`` per matching message, drawn
                from the plan's per-rank seeded stream -- still
                reproducible given the same seed and send sequence.
      action:   one of :data:`ACTIONS`.
      delay_s:  sleep for delay/stall actions.
    """

    action: str
    rank: Optional[int] = None
    msg_type: Optional[str] = None
    nth: Optional[int] = None
    p: Optional[float] = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"expected one of {ACTIONS}")
        if (self.nth is None) == (self.p is None):
            raise ValueError(
                "exactly one of nth= (deterministic) or p= (seeded "
                f"probabilistic) must be set, got nth={self.nth} p={self.p}")
        if self.nth is not None and self.nth < 1:
            raise ValueError("nth is 1-based and must be >= 1")


class FaultPlan:
    """A seed plus a rule set; ``for_rank(r)`` derives that rank's injector
    state (independent RNG stream + fresh match counters), so every rank's
    decisions are a pure function of ``(seed, rank, its send sequence)``."""

    def __init__(self, seed: int = 0, rules: tuple = ()):
        self.seed = int(seed)
        self.rules = tuple(rules)

    def for_rank(self, rank: int) -> "_RankFaults":
        rules = tuple(r for r in self.rules
                      if r.rank is None or r.rank == int(rank))
        return _RankFaults(self.seed, int(rank), rules)

    def wrap(self, comm: BaseCommunicationManager,
             rank: int) -> "FaultyCommManager":
        return FaultyCommManager(comm, self.for_rank(rank))


class _RankFaults:
    """Per-rank decision stream. Not thread-safe by design: one sender."""

    def __init__(self, seed, rank, rules):
        self.rank = rank
        self.rules = rules
        # independent, collision-free per-rank stream (SeedSequence spawn
        # keys, not ad-hoc seed arithmetic)
        self._rng = np.random.default_rng(
            np.random.SeedSequence(seed).spawn(rank + 1)[-1])
        self._matches = [0] * len(rules)
        self.decisions = []  # (send_index, action) audit log

    def decide(self, send_index: int, msg_type: str) -> list:
        """Actions firing for this outbound message (schedule order)."""
        fired = []
        for i, rule in enumerate(self.rules):
            if rule.msg_type is not None and rule.msg_type != msg_type:
                continue
            self._matches[i] += 1
            if rule.nth is not None:
                hit = self._matches[i] == rule.nth
            else:
                hit = bool(self._rng.random() < rule.p)
            if hit:
                fired.append(rule)
                self.decisions.append((send_index, rule.action))
        return fired


class FaultyCommManager(BaseCommunicationManager):
    """Transparent fault-injecting wrapper around any comm manager.

    Observer registration and the receive loop pass straight through to the
    inner manager, so FSMs are oblivious; only ``send_message`` consults the
    schedule. ``kill()`` (also reachable via a ``kill`` rule) severs the
    inner transport without a clean shutdown and swallows all later
    traffic in both directions.
    """

    def __init__(self, inner: BaseCommunicationManager, faults: _RankFaults,
                 sleep=time.sleep):
        self.inner = inner
        self.faults = faults
        self._sleep = sleep
        self._send_index = 0
        self._held = None  # reorder buffer (at most one message)
        self._dead = False
        self._lock = audited_lock()  # kill() may race the sender thread

    # -- fault application -------------------------------------------------
    def send_message(self, msg: Message, **kw):
        with self._lock:
            if self._dead:
                return
            idx = self._send_index
            self._send_index += 1
            fired = self.faults.decide(idx, msg.get_type())
        actions = [r.action for r in fired]
        if "kill" in actions:
            self.kill()
            return
        if "drop" in actions:
            logging.info("faults: rank %d dropping send #%d (type=%s)",
                         self.faults.rank, idx, msg.get_type())
            self._flush_held(**kw)
            return
        for r in fired:
            if r.action in ("delay", "stall"):
                logging.info("faults: rank %d %sing send #%d by %.3fs",
                             self.faults.rank, r.action, idx, r.delay_s)
                self._sleep(r.delay_s)
        if "reorder" in actions:
            with self._lock:
                if self._held is None:
                    self._held = (msg, kw)
                    return
        self.inner.send_message(msg, **kw)
        if "duplicate" in actions:
            self.inner.send_message(msg, **kw)
        self._flush_held(**kw)

    def _flush_held(self, **kw):
        with self._lock:
            held, self._held = self._held, None
        if held is not None and not self._dead:
            msg, held_kw = held
            self.inner.send_message(msg, **(held_kw or kw))

    def kill(self):
        """Die abruptly: no GOODBYE, no STOP -- peers observe a crash."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._held = None
        logging.info("faults: rank %d killed", self.faults.rank)
        sever = getattr(self.inner, "abort", None)
        if sever is not None:
            sever()
        else:  # transports without an abrupt-death hook: best-effort close
            close = getattr(self.inner, "close", None)
            if close is not None:
                close()

    # -- pass-through ------------------------------------------------------
    def add_observer(self, observer):
        # interpose: a dead rank must not deliver inbound messages either
        self.inner.add_observer(_DeadFilter(self, observer))

    def remove_observer(self, observer):
        # remove the matching interposer (identity on the wrapped observer)
        for obs in list(getattr(self.inner, "_observers", [])):
            if isinstance(obs, _DeadFilter) and obs.wrapped is observer:
                self.inner.remove_observer(obs)
                return
        self.inner.remove_observer(observer)

    def handle_receive_message(self):
        self.inner.handle_receive_message()

    def stop_receive_message(self):
        self._flush_held()
        self.inner.stop_receive_message()

    def __getattr__(self, name):
        # byte counters, close(), transport extras: delegate untouched
        return getattr(self.inner, name)


# -- diurnal trace-driven load generation ------------------------------------
#
# The fault rules above model *point* failures; a production fleet's
# dominant signal is the *load curve* -- day/night arrival-rate swings,
# correlated dropouts (a region goes dark for hours, not per-message),
# latency outages, flash crowds (Bonawitz MLSys'19 S3). The classes
# below make that curve a seeded, replayable schedule: a
# :class:`DiurnalTrace` is a JSON-serializable list of phases, a
# :class:`TraceLoadGen` derives deterministic per-(rank, event)
# delay/dropout decisions from it, and :class:`TraceShapedCommManager`
# applies them to any transport at send time (same ``wrap(comm, rank)``
# surface as :class:`FaultPlan`, so ``run_tcp_fedavg``/
# ``run_async_tcp_fedavg`` consume a trace through their existing
# ``fault_plan=`` parameter), and :meth:`TraceLoadGen.sim_miss_fn` plugs
# the dropout curve into ``SimResilience`` for the wall-clock-free
# simulation rounds. Pace steering (resilience/steering.py) is proven
# against these traces.


@dataclass(frozen=True)
class LoadPhase:
    """One phase of a diurnal load curve.

    Args:
      dur_s: phase duration (trace-relative wall seconds).
      delay_s: mean client reply delay during the phase (the arrival
        curve: small = flash crowd / healthy day, large = outage).
      jitter: uniform multiplicative delay jitter -- an individual reply
        sleeps ``delay_s * (1 + jitter * U[-1, 1))``.
      dropout_p: fraction of ranks *dark* for this phase occurrence.
        Correlated by construction: a rank is dark (drops every shaped
        message) for the whole occurrence, decided once from
        ``(seed, cycle, phase_index, rank)`` -- the region-outage shape,
        not per-message coin flips.
      name: label for records/logs ("day", "night", "outage", ...).
    """

    dur_s: float
    delay_s: float = 0.0
    jitter: float = 0.5
    dropout_p: float = 0.0
    name: str = ""

    def __post_init__(self):
        if self.dur_s <= 0:
            raise ValueError("LoadPhase.dur_s must be > 0")
        if not 0.0 <= self.dropout_p <= 1.0:
            raise ValueError("LoadPhase.dropout_p must be in [0, 1]")


class DiurnalTrace:
    """A seeded, repeating (or one-shot) sequence of load phases,
    JSON-round-trippable so a measured curve replays bit-identically
    across runs and hosts."""

    def __init__(self, phases, repeat=True, seed=0):
        self.phases = tuple(phases)
        if not self.phases:
            raise ValueError("DiurnalTrace needs at least one phase")
        self.repeat = bool(repeat)
        self.seed = int(seed)
        self.total_s = float(sum(p.dur_s for p in self.phases))

    def locate(self, t):
        """Phase active at trace-relative time ``t``: returns
        ``(cycle, phase_index, phase)``. Past the end of a one-shot
        trace the last phase holds."""
        t = max(0.0, float(t))
        if self.repeat:
            cycle, t = divmod(t, self.total_s)
            cycle = int(cycle)
        else:
            cycle = 0
            t = min(t, self.total_s - 1e-9)
        acc = 0.0
        for i, p in enumerate(self.phases):
            acc += p.dur_s
            if t < acc:
                return cycle, i, p
        return cycle, len(self.phases) - 1, self.phases[-1]

    # -- JSON replay format --------------------------------------------------
    def to_dict(self) -> dict:
        return {"seed": self.seed, "repeat": self.repeat,
                "phases": [{"dur_s": p.dur_s, "delay_s": p.delay_s,
                            "jitter": p.jitter, "dropout_p": p.dropout_p,
                            "name": p.name} for p in self.phases]}

    @classmethod
    def from_dict(cls, d) -> "DiurnalTrace":
        return cls([LoadPhase(**p) for p in d["phases"]],
                   repeat=bool(d.get("repeat", True)),
                   seed=int(d.get("seed", 0)))

    def to_file(self, path):
        import json
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        return path

    @classmethod
    def from_file(cls, path) -> "DiurnalTrace":
        import json
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def example(cls, scale=1.0, dropout=0.5, seed=0) -> "DiurnalTrace":
        """The canonical day/outage/night/flash curve (scaled). The
        outage leads so a fixed short deadline meets it before the run
        ends; the night's correlated dropouts make the cohort target
        unreachable, so every fixed config pays its full deadline per
        night round."""
        s = float(scale)
        return cls([
            LoadPhase(dur_s=0.4 * s, delay_s=0.05, jitter=0.5,
                      name="day"),
            LoadPhase(dur_s=6.0 * s, delay_s=1.5, jitter=0.2,
                      name="outage"),
            LoadPhase(dur_s=15.0 * s, delay_s=0.3, jitter=0.5,
                      dropout_p=dropout, name="night"),
            LoadPhase(dur_s=0.4 * s, delay_s=0.02, jitter=0.5,
                      name="flash"),
        ], repeat=True, seed=seed)


class TraceLoadGen:
    """Deterministic decision stream over a :class:`DiurnalTrace`.

    Every decision is a pure function of ``(seed, keys)`` -- dark ranks
    are keyed ``(seed, cycle, phase_index, rank)`` (correlated for the
    whole phase occurrence), reply delays ``(seed, rank, event_index)``
    (reproducible given the same per-rank send sequence, exactly the
    :class:`FaultPlan` contract). ``wrap(comm, rank)`` matches
    ``FaultPlan.wrap`` so the run drivers take a trace through their
    ``fault_plan=`` parameter unchanged.
    """

    def __init__(self, trace: DiurnalTrace, seed=None,
                 msg_type: str = "res_report", clock=time.monotonic,
                 population=None):
        self.trace = trace
        self.seed = trace.seed if seed is None else int(seed)
        self.msg_type = msg_type
        self._clock = clock
        # LAZY epoch: trace time 0 is the FIRST shaped event, not
        # generator construction -- transport handshakes (hundreds of
        # ms at tens of ranks) must not eat the first phase, or two
        # configs compared "on the same trace" see different curves
        self._epoch = None
        # known population => dark sets are exact-count (a seeded
        # permutation's first round(p*n) ranks), not per-rank Bernoulli:
        # "half the fleet is dark" then means exactly half, which is
        # both the correlated-outage shape and what keeps quorum math
        # deterministic
        self.population = (tuple(sorted(int(r) for r in population))
                           if population is not None else None)

    def reset_epoch(self):
        """Re-arm the lazy epoch (t=0 becomes the next shaped event)."""
        self._epoch = None

    def trace_time(self):
        if self._epoch is None:
            self._epoch = self._clock()
        return self._clock() - self._epoch

    def dark(self, cycle, phase_index, rank, p) -> bool:
        if p <= 0:
            return False
        if p >= 1:
            return True
        if self.population is not None:
            k = int(round(p * len(self.population)))
            if k <= 0:
                return False
            perm = np.random.default_rng(
                (self.seed, int(cycle), int(phase_index))).permutation(
                    len(self.population))
            return int(rank) in {self.population[i] for i in perm[:k]}
        rng = np.random.default_rng(
            (self.seed, int(cycle), int(phase_index), int(rank)))
        return bool(rng.random() < p)

    def reply_delay(self, rank, event_index, phase: LoadPhase) -> float:
        if phase.delay_s <= 0:
            return 0.0
        u = np.random.default_rng(
            (self.seed, 7, int(rank), int(event_index))).random()
        return float(phase.delay_s * (1.0 + phase.jitter * (2.0 * u - 1.0)))

    def decide(self, rank, event_index, t):
        """``("drop", phase)`` or ``("delay", seconds, phase)`` for one
        shaped message at trace time ``t``."""
        cycle, idx, phase = self.trace.locate(t)
        if self.dark(cycle, idx, rank, phase.dropout_p):
            return ("drop", phase)
        return ("delay", self.reply_delay(rank, event_index, phase), phase)

    def wrap(self, comm: BaseCommunicationManager,
             rank: int) -> "TraceShapedCommManager":
        return TraceShapedCommManager(comm, self, rank)

    def sim_miss_fn(self, round_s=1.0):
        """Deadline-miss oracle for ``SimResilience(miss_fn=...)``: the
        simulation rounds have no wall clock, so round ``r`` maps to
        virtual trace time ``r * round_s`` and a client misses when its
        phase marks it dark. Pure function of (seed, round, client) --
        the bitwise-reproducible half of the steering determinism
        gate."""

        def miss(round_idx, attempt, client_id):
            del attempt  # an abandoned re-run re-samples, same phase
            cycle, idx, phase = self.trace.locate(
                float(round_idx) * float(round_s))
            return self.dark(cycle, idx, client_id, phase.dropout_p)

        return miss


class TraceShapedCommManager(BaseCommunicationManager):
    """Send-side trace shaper: only ``gen.msg_type`` messages (client
    reports, by default) are delayed/dropped -- control traffic (HELLO,
    syncs, GOODBYE) flows clean, exactly like a slow-uplink device whose
    downlink still works.

    Unlike :class:`FaultyCommManager`'s ``delay`` action (which stalls
    the *sender thread*, modelling a busy device), the trace delay is
    delivered by a timer -- it models network/uplink LATENCY: the
    client's handler thread is immediately free for the next sync, so
    consecutive round attempts see independent delays instead of one
    slow device serializing them (which would cascade abandons under a
    deadline prober). The decision stream stays on the sender thread
    (one sender per rank, the :class:`_RankFaults` contract); only the
    delivery hops threads."""

    def __init__(self, inner: BaseCommunicationManager, gen: TraceLoadGen,
                 rank: int, timer_factory=threading.Timer):
        self.inner = inner
        self.gen = gen
        self.rank = int(rank)
        self._timer_factory = timer_factory
        self._events = 0
        self.dropped = 0
        self.delayed_s = 0.0

    def send_message(self, msg: Message, **kw):
        if msg.get_type() != self.gen.msg_type:
            self.inner.send_message(msg, **kw)
            return
        idx = self._events
        self._events += 1
        action = self.gen.decide(self.rank, idx, self.gen.trace_time())
        if action[0] == "drop":
            self.dropped += 1
            logging.info("trace: rank %d dark in phase %r -- dropping "
                         "send #%d", self.rank, action[1].name, idx)
            return
        _, delay, _phase = action
        if delay <= 0:
            self.inner.send_message(msg, **kw)
            return
        self.delayed_s += delay
        t = self._timer_factory(delay, self._deliver, args=(msg, kw))
        t.daemon = True
        t.start()

    def _deliver(self, msg, kw):
        try:
            self.inner.send_message(msg, **kw)
        except (ConnectionError, OSError, KeyError):
            # the run ended (or the peer died) while this reply was in
            # flight: a real network would drop it on the floor too
            logging.debug("trace: rank %d delayed send arrived after "
                          "teardown", self.rank)

    # -- pass-through ------------------------------------------------------
    def add_observer(self, observer):
        self.inner.add_observer(observer)

    def remove_observer(self, observer):
        self.inner.remove_observer(observer)

    def handle_receive_message(self):
        self.inner.handle_receive_message()

    def stop_receive_message(self):
        self.inner.stop_receive_message()

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _DeadFilter:
    """Observer interposer: drops deliveries after the wrapper died (a
    crashed process cannot handle the messages already in its mailbox).
    ``MSG_TYPE_PEER_LOST`` still passes -- it is synthesized locally by the
    transport, not received, and tests assert on it."""

    def __init__(self, manager: FaultyCommManager, wrapped):
        self.manager = manager
        self.wrapped = wrapped

    def receive_message(self, msg_type, msg_params):
        if self.manager._dead and str(msg_type) != MSG_TYPE_PEER_LOST:
            return
        self.wrapped.receive_message(msg_type, msg_params)


__all__ = ["ACTIONS", "FaultRule", "FaultPlan", "FaultyCommManager",
           "LoadPhase", "DiurnalTrace", "TraceLoadGen",
           "TraceShapedCommManager"]
