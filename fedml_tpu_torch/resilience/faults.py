"""Diurnal load traces, the simulation half (counterpart of
``fedml_tpu/resilience/faults.py:256-455``; numpy, decision for
decision).

A production fleet's dominant signal is its load curve: day/night
arrival-rate swings, correlated dropouts (a region goes dark for the
whole phase, not per message), latency outages and flash crowds
(Bonawitz et al., MLSys 2019, section 3). A :class:`DiurnalTrace` makes
that curve a seeded, JSON-replayable list of :class:`LoadPhase`\\ s; a
:class:`TraceLoadGen` derives deterministic per-(rank, event)
delay/dropout decisions from it, and :meth:`TraceLoadGen.sim_miss_fn`
plugs the dropout curve into ``SimResilience`` for the wall-clock-free
simulation rounds.

The fault plans over a transport (``FaultPlan``, ``FaultyCommManager``)
and the send-side trace shaper (:class:`TraceShapedCommManager`,
:meth:`TraceLoadGen.wrap`) need the distributed control plane and wait
for ROADMAP A13.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_A13 = ("shaping a transport's sends waits for ROADMAP A13 (the "
        "distributed control plane)")


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
    (reproducible given the same per-rank send sequence).
    :meth:`sim_miss_fn` drives ``SimResilience``; :meth:`wrap` shapes a
    transport (with the reference's ``msg_type``, clock and lazy trace
    epoch) and waits for the control plane (ROADMAP A13).
    """

    def __init__(self, trace: DiurnalTrace, seed=None, population=None):
        self.trace = trace
        self.seed = trace.seed if seed is None else int(seed)
        # known population => dark sets are exact-count (a seeded
        # permutation's first round(p*n) ranks), not per-rank Bernoulli:
        # "half the fleet is dark" then means exactly half, which is
        # both the correlated-outage shape and what keeps quorum math
        # deterministic
        self.population = (tuple(sorted(int(r) for r in population))
                           if population is not None else None)

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

    def wrap(self, comm, rank):
        """Shape a transport's sends: needs the control plane."""
        raise NotImplementedError(_A13)

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


class TraceShapedCommManager:
    """Send-side trace shaper over a transport: waits for ROADMAP A13."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_A13)


__all__ = ["LoadPhase", "DiurnalTrace", "TraceLoadGen",
           "TraceShapedCommManager"]
