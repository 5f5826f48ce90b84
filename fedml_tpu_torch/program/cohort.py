"""Cohort selection (counterpart of ``fedml_tpu/program/cohort.py``;
byte-equal draws). Host numpy."""

from __future__ import annotations

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


__all__ = ["attempt_seed", "client_sampling"]
