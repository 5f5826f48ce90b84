"""Cohort selection (counterpart of ``fedml_tpu/program/cohort.py``;
byte-equal draws): the seeded client-index draw of the simulation, the
seeded transport-rank draw of a distributed server, and the
``CohortPolicy`` knobs (over-selection, quorum, deadline) of a
``RoundProgram``. Host numpy."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np


def attempt_seed(round_idx, attempt=0):
    """Cohort-sampling seed for ``(round, attempt)``; attempt 0 is the
    per-round seed."""
    return round_idx if attempt == 0 else round_idx + 1_000_003 * attempt


def client_sampling(round_idx, client_num_in_total, client_num_per_round,
                    attempt=0):
    """Seeded-by-round cohort sampling: the same round index draws the
    same clients."""
    num_clients = min(client_num_per_round, client_num_in_total)
    if client_num_in_total == num_clients:
        return list(range(client_num_in_total))
    np.random.seed(attempt_seed(round_idx, attempt))
    return list(np.random.choice(range(client_num_in_total),
                                 num_clients, replace=False))


def sample_ranks(round_idx, attempt, ranks, k):
    """``k`` transport ranks from ``ranks`` with the stream of
    :func:`client_sampling`, sorted; the candidates are sorted first, so
    the draw does not depend on their order. ``k >= len(ranks)`` selects
    every rank."""
    ranks = sorted(int(r) for r in ranks)
    if k >= len(ranks):
        return list(ranks)
    np.random.seed(attempt_seed(round_idx, attempt))
    return sorted(int(r) for r in np.random.choice(ranks, int(k),
                                                   replace=False))


@dataclass(frozen=True)
class CohortPolicy:
    """Server-side round knobs of a ``RoundProgram``: ``deadline_s``
    (report deadline per attempt, 0 = none), ``overselect`` (select
    ``ceil((1 + eps) * C)``), ``quorum`` (least reporting fraction of C
    for a deadline round to complete) and ``max_round_retries``."""

    deadline_s: float = 0.0
    overselect: float = 0.0
    quorum: float = 0.5
    max_round_retries: int = 3

    def select_count(self, target: int,
                     available: Optional[int] = None) -> int:
        n = int(math.ceil((1.0 + self.overselect) * target))
        return n if available is None else min(n, available)

    def quorum_count(self, target: int) -> int:
        return max(1, int(math.ceil(self.quorum * target)))


__all__ = ["attempt_seed", "client_sampling", "sample_ranks",
           "CohortPolicy"]
