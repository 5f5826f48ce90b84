"""Resilience wired into the simulation rounds (counterpart of
``fedml_tpu/resilience/integration.py``: :class:`SimResilience` and
:func:`add_resilience_args`; cohorts and records equal to the
reference's, bit for bit).

:class:`SimResilience` implements over-selection and simulated deadline
misses for the simulated rounds (``FedAvgAPI`` and everything built on
it). The round functions weight the aggregate by per-client sample
counts over the cohort they are given, so restricting the cohort to the
reporting subset IS the renormalised partial aggregate: no aggregation
math changes.

The distributed control plane (the resilient server and client FSMs,
``run_tcp_fedavg``) waits for ROADMAP A13.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from fedml_tpu_torch.observability.tracing import get_tracer
from fedml_tpu_torch.program.cohort import CohortPolicy, client_sampling


def add_resilience_args(parser):
    parser.add_argument(
        "--deadline", type=float, default=0.0,
        help="per-round report deadline in seconds for the distributed "
             "control plane (0 = wait for every report, the reference's "
             "block-on-slowest behavior). Simulation rounds have no wall "
             "clock; there --straggler_p models deadline misses")
    parser.add_argument(
        "--overselect", type=float, default=0.0,
        help="over-selection eps (Bonawitz MLSys'19 S3): select "
             "ceil((1+eps)*C) clients, aggregate the first C reports")
    parser.add_argument(
        "--quorum", type=float, default=0.5,
        help="minimum reporting fraction of the aggregation target for a "
             "deadline-bounded round to complete (degraded); below it the "
             "round is abandoned and re-run with a fresh cohort")
    parser.add_argument(
        "--straggler_p", type=float, default=0.0,
        help="simulation only: per-(round, client) probability of missing "
             "the report deadline, drawn from a seeded stream keyed on "
             "(seed, round, attempt, client) -- reproducible chaos for the "
             "simulated rounds")
    parser.add_argument(
        "--transport", type=str, default="tcp",
        choices=("tcp", "eventloop"),
        help="distributed control-plane transport: 'tcp' = the thread-"
             "per-client hub, 'eventloop' = the single-threaded selector "
             "event loop. The distributed control plane waits for ROADMAP "
             "A13; on these mains a value other than tcp refuses")
    parser.add_argument(
        "--race_audit", type=int, default=0,
        help="arm the concurrency race sanitizer over the control "
             "plane's locks (ROADMAP A16)")
    return parser


class SimResilience:
    """Over-selection + seeded deadline-miss simulation for the sim rounds.

    ``sample(round_idx, total, per_round)`` replaces the bare
    ``client_sampling`` call: it over-selects, removes simulated deadline
    misses, keeps the first C survivors ("first C reports win"), and
    re-runs below-quorum rounds with a fresh cohort (attempt folded into
    the sampling seed). Cumulative counters ride every round's metrics
    record so degraded rounds are visible in summary.json.
    """

    def __init__(self, policy: CohortPolicy, straggler_p: float = 0.0,
                 seed: int = 0, miss_fn=None):
        self.policy = policy
        self.straggler_p = float(straggler_p)
        self.seed = int(seed)
        self._miss_fn = miss_fn
        self.rounds_degraded = 0
        self.rounds_abandoned = 0
        self.clients_dropped = 0

    @classmethod
    def from_args(cls, args) -> Optional["SimResilience"]:
        over = float(getattr(args, "overselect", 0.0) or 0.0)
        sp = float(getattr(args, "straggler_p", 0.0) or 0.0)
        if over <= 0 and sp <= 0:
            return None
        policy = CohortPolicy(overselect=over,
                              quorum=float(getattr(args, "quorum", 0.5)))
        return cls(policy, straggler_p=sp,
                   seed=int(getattr(args, "seed", 0)))

    def sample(self, round_idx, client_num_in_total, client_num_per_round):
        """Returns ``(reporting_client_ids, round_record_dict)``."""
        with get_tracer().span("cohort-select", round=int(round_idx)) as sp:
            reporting, record = self._sample(
                round_idx, client_num_in_total, client_num_per_round)
            sp.set(selected=record["res/selected"],
                   reporting=record["res/reporting"],
                   attempts=record["res/attempts"])
            return reporting, record

    def misses_deadline(self, round_idx, attempt, client_id) -> bool:
        if self._miss_fn is not None:
            return bool(self._miss_fn(round_idx, attempt, client_id))
        if self.straggler_p <= 0:
            return False
        # keyed (not sequential) stream: order-independent, reproducible
        rng = np.random.default_rng(
            (self.seed, int(round_idx), int(attempt), int(client_id)))
        return bool(rng.random() < self.straggler_p)

    def _sample(self, round_idx, client_num_in_total, client_num_per_round):
        target = min(client_num_per_round, client_num_in_total)
        for attempt in range(self.policy.max_round_retries + 1):
            selected = client_sampling(
                round_idx, client_num_in_total,
                self.policy.select_count(target, client_num_in_total),
                attempt=attempt)
            # seeded permutation before the "first C win" trim: when
            # select_count reaches the total, client_sampling's
            # all-clients early-return is an ORDERED range, and trimming
            # that untouched would hand the lowest ids every round (a
            # silently biased cohort). The permutation models report
            # arrival order; the final subset is sorted so the packed
            # cohort (and thus the aggregate) has one canonical order.
            perm = np.random.default_rng(
                (self.seed, int(round_idx), int(attempt))).permutation(
                    len(selected))
            selected = [selected[i] for i in perm]
            reporting = [c for c in selected
                         if not self.misses_deadline(round_idx, attempt, c)]
            dropped = len(selected) - len(reporting)
            if len(reporting) >= self.policy.quorum_count(target):
                reporting = sorted(reporting[:target])
                self.clients_dropped += dropped
                degraded = len(reporting) < target
                self.rounds_degraded += int(degraded)
                return reporting, {
                    "res/selected": len(selected),
                    "res/reporting": len(reporting),
                    "res/degraded": int(degraded),
                    "res/attempts": attempt + 1,
                    "res/rounds_degraded": self.rounds_degraded,
                    "res/rounds_abandoned": self.rounds_abandoned,
                    "res/clients_dropped": self.clients_dropped,
                }
            # below quorum: abandon, re-run with a fresh cohort
            self.rounds_abandoned += 1
            self.clients_dropped += dropped
            logging.warning(
                "round %d attempt %d: %d/%d reports is below quorum %d -- "
                "abandoning and re-sampling", round_idx, attempt,
                len(reporting), len(selected),
                self.policy.quorum_count(target))
        raise RuntimeError(
            f"round {round_idx}: abandoned "
            f"{self.policy.max_round_retries + 1} consecutive attempts "
            "(straggler rate incompatible with the quorum; lower --quorum "
            "or --straggler_p)")


__all__ = ["SimResilience", "add_resilience_args"]
