"""Closed-loop pace steering (counterpart of
``fedml_tpu/resilience/steering.py``; the same law, decision for
decision): the aggregator tunes its own round knobs -- report deadline,
over-selection, async buffer size and flush deadline -- from the
arrival distributions it observes (Bonawitz et al., MLSys 2019, section
3), within operator bounds.

:class:`PaceController` is deterministic: every decision is a pure
function of its configuration, its previous decision and the
observations handed to it, with no randomness and no wall-clock read
inside the law, so a replayed trace reproduces the identical decision
sequence. The ``seed`` is carried for parity and unused by the law.

Control law:

- **report deadline** (sync rounds): track the straggler tail. With a
  windowed report-latency p90 available, the target is
  ``latency_margin * p90``; the deadline moves toward it by at most
  ``step_up``x upward or ``step_down``x downward per decision and is
  clamped to ``bounds.deadline_s``. An *abandoned* round overrides the
  tracker: the deadline multiplies by ``abandon_backoff`` immediately
  (the tail escaped the histogram window -- back off first, re-track
  once reports flow again).
- **over-selection**: track the observed loss fraction
  ``1 - reporting/selected``. The target ``eps`` is the loss odds
  ``loss / (1 - loss)`` times ``overselect_safety``; eps moves by at
  most ``overselect_max_delta`` per decision within
  ``bounds.overselect``.
- **async buffer K**: size the buffer to what actually arrives within
  one flush deadline: ``arrival_rate * flush_deadline * fill_fraction``,
  geometric-rate-limited by ``step_up``/``step_down`` and clamped to
  ``bounds.buffer_k``. A flash crowd raises K (bigger, smoother server
  steps); a quiet night shrinks it (no waiting on reports that are not
  coming).
- **async flush deadline**: same tail tracker as the sync deadline,
  against ``bounds.flush_deadline_s``.

Quantized inputs, quantized outputs: the latency quantiles are
*histogram-bucket upper edges* over the window since the previous
decision (never the cumulative distribution -- a long sunny day must
not blind the controller to the night), so small timing noise lands on
the same bucket edge and the decision stream stays stable; outputs are
rounded (seconds to 1 ms, eps to 1e-4) so repeated runs compare
bitwise. Empty windows (round 0, or nothing arrived) hold every knob:
the controller never steps on no evidence, and never steps outside the
operator bounds.

Thread model: the controller is lock-free; the simulation path that
drives it is single-threaded.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from fedml_tpu_torch.observability.registry import get_registry


def _clamp(value, lo_hi):
    lo, hi = lo_hi
    return min(max(value, lo), hi)


def _parse_pair(text, cast):
    lo, hi = (cast(x) for x in str(text).split(","))
    if lo > hi:
        raise ValueError(f"bounds pair {text!r}: min exceeds max")
    return (lo, hi)


@dataclass(frozen=True)
class PaceBounds:
    """Operator-set hard bounds; the controller never steps outside
    them, for any knob, under any observation stream."""

    buffer_k: tuple = (1, 4096)
    flush_deadline_s: tuple = (0.05, 120.0)
    deadline_s: tuple = (0.05, 120.0)
    overselect: tuple = (0.0, 1.0)


@dataclass(frozen=True)
class PaceDecision:
    """One control decision (all knobs, even the unchanged ones)."""

    index: int
    buffer_k: int
    flush_deadline_s: float
    deadline_s: float
    overselect: float
    reason: str     # dominant rule this decision: hold | track-tail |
    #                 abandon-backoff | track-loss | track-arrival (comma-
    #                 joined when several moved)
    inputs: dict = field(default_factory=dict)

    def record(self, prefix="pace/") -> dict:
        return {prefix + "decision": self.index,
                prefix + "buffer_k": self.buffer_k,
                prefix + "flush_deadline_s": self.flush_deadline_s,
                prefix + "deadline_s": self.deadline_s,
                prefix + "overselect": self.overselect,
                prefix + "reason": self.reason}


#: Histograms the controller windows over (name -> obs key stem).
_WATCHED_HISTOGRAMS = (("fed_report_latency_seconds", "latency"),
                       ("fed_staleness_levels", "staleness"),
                       ("fed_buffer_depth_levels", "depth"))


def _window_quantile(edges, window_counts, q):
    """Quantile over a *delta* histogram (bucket counts since the last
    decision): the upper edge of the first bucket whose cumulative
    window count reaches ``q * total`` -- same conservative rule as
    ``MetricsRegistry.histogram_quantile`` (never under-reports a
    tail). None on an empty window."""
    total = sum(window_counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for le, c in zip(edges, window_counts):
        cum += c
        if cum >= target:
            return float(le)
    return math.inf


class PaceController:
    """Deterministic closed-loop pace controller (module docstring).

    One instance steers one server (or one simulated run): it carries
    the current knob values and the per-histogram window state. Call
    :meth:`observe_registry` to snapshot the live distributions, then
    :meth:`decide` once per round turnover / buffer flush.
    """

    def __init__(self, bounds: Optional[PaceBounds] = None, seed: int = 0,
                 buffer_k: int = 64, flush_deadline_s: float = 1.0,
                 deadline_s: float = 1.0, overselect: float = 0.0,
                 latency_margin: float = 1.25, step_up: float = 2.0,
                 step_down: float = 4.0, abandon_backoff: float = 3.0,
                 fill_fraction: float = 0.8, overselect_safety: float = 1.25,
                 overselect_max_delta: float = 0.5):
        self.bounds = bounds if bounds is not None else PaceBounds()
        self.seed = int(seed)
        self.latency_margin = float(latency_margin)
        self.step_up = float(step_up)
        self.step_down = float(step_down)
        self.abandon_backoff = float(abandon_backoff)
        self.fill_fraction = float(fill_fraction)
        self.overselect_safety = float(overselect_safety)
        self.overselect_max_delta = float(overselect_max_delta)
        # starting points are the operator's configured knobs, clamped
        # into the operator's own bounds (a start outside them is a
        # config contradiction resolved toward the bounds)
        self.buffer_k = int(_clamp(int(buffer_k), self.bounds.buffer_k))
        self.flush_deadline_s = float(_clamp(float(flush_deadline_s),
                                             self.bounds.flush_deadline_s))
        self.deadline_s = float(_clamp(float(deadline_s),
                                       self.bounds.deadline_s))
        self.overselect = float(_clamp(float(overselect),
                                       self.bounds.overselect))
        self.decisions = []
        self._hist_last = {}  # histogram name -> last cumulative counts

    @classmethod
    def from_args(cls, args) -> Optional["PaceController"]:
        """``--pace_steering`` switchboard: None when the flag is off
        (the disabled path is exactly today's code)."""
        if not int(getattr(args, "pace_steering", 0) or 0):
            return None
        bounds = PaceBounds(
            buffer_k=_parse_pair(
                getattr(args, "pace_k_bounds", "1,4096"), int),
            flush_deadline_s=_parse_pair(
                getattr(args, "pace_flush_bounds", "0.05,120"), float),
            deadline_s=_parse_pair(
                getattr(args, "pace_deadline_bounds", "0.05,120"), float),
            overselect=_parse_pair(
                getattr(args, "pace_overselect_bounds", "0,1"), float))
        return cls(
            bounds, seed=int(getattr(args, "seed", 0) or 0),
            buffer_k=int(getattr(args, "buffer_k", 64) or 64),
            flush_deadline_s=float(getattr(args, "flush_deadline", 0.0)
                                   or 1.0),
            deadline_s=float(getattr(args, "deadline", 0.0) or 1.0),
            overselect=float(getattr(args, "overselect", 0.0) or 0.0))

    # -- observation --------------------------------------------------------
    def observe_registry(self, reg=None) -> dict:
        """Snapshot the registry distributions as *windowed* statistics:
        p50/p90 of each watched histogram over the counts accumulated
        since this controller's previous snapshot, plus the rolling
        rounds/hour gauge. Returns {} when the registry is off or the
        windows are empty -- :meth:`decide` holds on missing keys."""
        if reg is None:
            reg = get_registry()
        if reg is None:
            return {}
        obs = {}
        for name, stem in _WATCHED_HISTOGRAMS:
            snap = reg.histogram_buckets(name)
            if snap is None:
                continue
            edges, counts = snap
            last = self._hist_last.get(name)
            if last is not None and len(last) == len(counts):
                window = [c - p for c, p in zip(counts, last)]
            else:
                window = list(counts)
            self._hist_last[name] = counts
            for q, tag in ((0.5, "p50"), (0.9, "p90")):
                v = _window_quantile(edges, window, q)
                if v is not None:
                    obs[f"{stem}_{tag}"] = v
        rph = reg.get("fed_rounds_per_hour")
        if isinstance(rph, (int, float)) and math.isfinite(rph):
            obs["rounds_per_hour"] = float(rph)
        return obs

    # -- the law ------------------------------------------------------------
    def _track_tail(self, current, p90, bounds):
        """Move ``current`` toward ``latency_margin * p90``, geometric-
        rate-limited, clamped. Returns (new, moved)."""
        if p90 is None or not math.isfinite(p90) or p90 <= 0:
            return current, False
        target = _clamp(self.latency_margin * p90, bounds)
        new = _clamp(target, (current / self.step_down,
                              current * self.step_up))
        new = round(_clamp(new, bounds), 3)
        return new, new != current

    def decide(self, outcome=None, selected=None, reporting=None,
               arrival_rate=None, flush_reason=None, flush_clients=None,
               obs=None) -> PaceDecision:
        """One control decision.

        Args (every one optional -- the law only moves knobs it has
        evidence for):
          outcome: last sync round outcome ("complete" | "degraded" |
            "abandoned").
          selected / reporting: last cohort size vs reports aggregated
            (feeds the over-selection loss tracker).
          arrival_rate: reports/second folded over the last flush
            window (feeds the async buffer-K sizing).
          flush_reason / flush_clients: the last async flush's reason
            and client count (a below-K deadline flush corroborates a
            shrinking K).
          obs: :meth:`observe_registry` snapshot (windowed quantiles).
        """
        obs = dict(obs or {})
        p90 = obs.get("latency_p90")
        reasons = []

        # report deadline (sync rounds). An abandon with ZERO reports is
        # a latency signal (nothing beat the deadline: back off before
        # re-tracking); an abandon WITH reports is a loss signal (the
        # cohort starved below quorum -- the over-selection tracker
        # below is the right actuator, and lengthening the deadline
        # would just make the starved re-run more expensive).
        if outcome == "abandoned" and not reporting:
            self.deadline_s = round(
                _clamp(self.deadline_s * self.abandon_backoff,
                       self.bounds.deadline_s), 3)
            reasons.append("abandon-backoff")
        else:
            self.deadline_s, moved = self._track_tail(
                self.deadline_s, p90, self.bounds.deadline_s)
            if moved:
                reasons.append("track-tail")

        # async flush deadline: same tail tracker, its own bounds
        self.flush_deadline_s, moved = self._track_tail(
            self.flush_deadline_s, p90, self.bounds.flush_deadline_s)
        if moved and "track-tail" not in reasons:
            reasons.append("track-tail")

        # over-selection: track the observed loss odds
        if selected and reporting is not None and selected > 0:
            loss = _clamp(1.0 - float(reporting) / float(selected),
                          (0.0, 1.0))
            target = _clamp(self.overselect_safety * loss
                            / max(1.0 - loss, 1e-6),
                            self.bounds.overselect)
            delta = _clamp(target - self.overselect,
                           (-self.overselect_max_delta,
                            self.overselect_max_delta))
            new = round(_clamp(self.overselect + delta,
                               self.bounds.overselect), 4)
            if new != self.overselect:
                self.overselect = new
                reasons.append("track-loss")

        # async buffer K: what actually arrives within one flush window
        if arrival_rate is not None and arrival_rate > 0:
            target = _clamp(arrival_rate * self.flush_deadline_s
                            * self.fill_fraction, self.bounds.buffer_k)
            new = _clamp(target, (self.buffer_k / self.step_down,
                                  self.buffer_k * self.step_up))
            new = int(_clamp(int(round(new)), self.bounds.buffer_k))
            if new != self.buffer_k:
                self.buffer_k = new
                reasons.append("track-arrival")

        dec = PaceDecision(
            index=len(self.decisions), buffer_k=self.buffer_k,
            flush_deadline_s=self.flush_deadline_s,
            deadline_s=self.deadline_s, overselect=self.overselect,
            reason=",".join(reasons) if reasons else "hold",
            inputs={"outcome": outcome, "selected": selected,
                    "reporting": reporting, "arrival_rate": arrival_rate,
                    "flush_reason": flush_reason,
                    "flush_clients": flush_clients, **obs})
        self.decisions.append(dec)
        self._emit(dec)
        return dec

    def _emit(self, dec: PaceDecision):
        """Decision series into the metrics registry (no-op when off).
        The ``reason`` label is drawn from the law's fixed vocabulary,
        never per-client identity."""
        reg = get_registry()
        if reg is None:
            return
        reg.set_gauge("fed_pace_deadline_seconds", dec.deadline_s,
                      help="steered sync report deadline")
        reg.set_gauge("fed_pace_flush_deadline_seconds",
                      dec.flush_deadline_s,
                      help="steered async flush deadline")
        reg.set_gauge("fed_pace_buffer_k", dec.buffer_k,
                      help="steered async buffer K")
        reg.set_gauge("fed_pace_overselect", dec.overselect,
                      help="steered cohort over-selection eps")
        reg.inc("fed_pace_decisions_total",
                help="pace-steering decisions by dominant rule",
                reason=dec.reason)

    # -- reporting ----------------------------------------------------------
    def status_fields(self) -> dict:
        """The ``pace`` block for a server's status.json snapshot."""
        out = {"decisions": len(self.decisions),
               "buffer_k": self.buffer_k,
               "flush_deadline_s": self.flush_deadline_s,
               "deadline_s": self.deadline_s,
               "overselect": self.overselect}
        if self.decisions:
            out["last_reason"] = self.decisions[-1].reason
        return out

    def record(self, prefix="pace/") -> dict:
        """Metrics-record fragment of the latest decision (rides round
        records on steered runs, like the async/* counters)."""
        if not self.decisions:
            return {prefix + "decision": -1}
        return self.decisions[-1].record(prefix)


def add_steering_args(parser):
    parser.add_argument(
        "--pace_steering", type=int, default=0,
        help="closed-loop pace steering (Bonawitz MLSys'19 S3, "
             "resilience/steering.py): the server adapts --buffer_k / "
             "--flush_deadline / --deadline / --overselect per decision "
             "from its own live report-latency/staleness/buffer-depth "
             "histograms, within the --pace_*_bounds. Default off; off "
             "is bitwise-identical to no flag. On these mains it steers "
             "the simulation's over-selection (needs --overselect or "
             "--straggler_p to arm the sampling loop)")
    parser.add_argument(
        "--pace_k_bounds", type=str, default="1,4096",
        help="pace steering: min,max async buffer K")
    parser.add_argument(
        "--pace_flush_bounds", type=str, default="0.05,120",
        help="pace steering: min,max async flush deadline seconds")
    parser.add_argument(
        "--pace_deadline_bounds", type=str, default="0.05,120",
        help="pace steering: min,max sync report deadline seconds")
    parser.add_argument(
        "--pace_overselect_bounds", type=str, default="0,1",
        help="pace steering: min,max over-selection eps")
    return parser


__all__ = ["PaceBounds", "PaceDecision", "PaceController",
           "add_steering_args"]
