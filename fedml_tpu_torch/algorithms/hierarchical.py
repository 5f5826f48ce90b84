"""Hierarchical FL: client -> group -> global two-tier averaging
(counterpart of ``fedml_tpu/algorithms/hierarchical.py``).

Each global round samples the cohort, assigns it to ``group_num`` groups
round-robin (:func:`round_robin_groups`, the reference's rule), and every
group runs ``group_comm_round`` FedAvg sub-rounds from the same global
model over its clients' batches, packed once for the round: in each
sub-round the group's clients train at once and average by their sample
counts. The groups' models then average by their groups' sample counts.
A group shorter than the longest is padded with empty clients (weight 0,
fully masked), so no sampled client is dropped.

The reference runs the groups under one vmap; the port runs them one
after another through the host-packed client update, each over its own
steps. Draws (augmentation, dropout) of group ``g``'s sub-round ``r``
come from the client seeds ``client_seeds_for(fold_seed(fold_seed(
round_seed, g), r), C)``, with ``round_seed = fold_seed(seed, round)`` as
in every FedAvg round.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.parallel.engine import (_tree_map, _weighted_sum,
                                             client_seeds_for, fold_seed,
                                             make_client_update)
from fedml_tpu_torch.parallel.packing import pack_cohort
from fedml_tpu_torch.program.cohort import client_sampling


def round_robin_groups(ids, n_groups):
    """Element ``i`` joins group ``i % n_groups``; empty groups are
    dropped (the reference's ``net/fanin.py`` rule)."""
    ids = list(ids)
    groups = [ids[g::n_groups] for g in range(n_groups)]
    return [g for g in groups if g]


def _weighted_mean(stacked, w):
    """``sum_k w_k x_k / sum_k w_k`` over the leading axis in fp32, cast
    back; the plain mean when every weight is 0."""
    if float(w.sum()) <= 0:
        w = torch.ones_like(w)
    total = w.sum()
    return _tree_map(lambda s, x: (s / total).to(x.dtype),
                     _weighted_sum(stacked, w), stacked)


class HierarchicalFedAvgAPI(FedAvgAPI):
    """Extra args: ``group_num`` (default 2) and ``group_comm_round``
    (intra-group rounds a global round, default 1)."""

    def __init__(self, dataset, spec, args, mesh=None, metrics_logger=None,
                 device=None):
        super().__init__(dataset, spec, args, mesh=mesh,
                         metrics_logger=metrics_logger, device=device)
        self.group_num = getattr(args, "group_num", 2)
        self.group_comm_round = getattr(args, "group_comm_round", 1)
        self._client_update = make_client_update(spec, self.cfg)

    def _group_state(self, data, round_seed, g):
        """``group_comm_round`` sub-rounds of one group from the global
        model: ``(state, n_group, metric sums)``."""
        C = data["mask"].shape[0]
        state, msum = self.global_state, None
        with torch.no_grad():
            n = data["n"].float()
        for r in range(self.group_comm_round):
            seeds = client_seeds_for(fold_seed(fold_seed(round_seed, g), r),
                                     C)
            local, _, metrics = self._client_update(state, data, seeds)
            with torch.no_grad():
                state = _weighted_mean(local, n)
                part = _tree_map(lambda m: m.sum(), metrics)
                msum = part if msum is None else _tree_map(torch.add, msum,
                                                           part)
        return state, n.sum(), msum

    def train_one_round(self):
        t0 = time.time()
        client_indexes = client_sampling(
            self.round_idx, len(self.train_data_local_dict),
            self.args.client_num_per_round)
        groups = round_robin_groups(client_indexes, self.group_num)
        per_group = max(len(g) for g in groups)
        logging.info("hierarchical groups = %s", groups)
        first = self.train_data_local_dict[client_indexes[0]]
        empty = {"x": np.zeros((0,) + np.asarray(first["x"]).shape[1:],
                               np.asarray(first["x"]).dtype),
                 "y": np.zeros((0,), np.asarray(first["y"]).dtype)}
        # packed in group order, one draw from the shuffle stream each, as
        # the reference packs them
        packs = [pack_cohort(
            [self.train_data_local_dict[i] for i in g]
            + [empty] * (per_group - len(g)),
            self.args.batch_size, self.args.epochs, rng=self._data_rng)
            for g in groups]
        round_seed = int(fold_seed(self.seed, self.round_idx))
        states, ns, msum = [], [], None
        for g, p in enumerate(packs):
            # the group's true steps only: the padded tail is fully masked
            trip = max(1, int((p["mask"].sum(axis=2) > 0).sum(axis=1).max()))
            data = {k: torch.as_tensor(v[:, :trip] if v.ndim > 1 else v,
                                       device=self.device)
                    for k, v in p.items()}
            data["y"] = data["y"].long()
            state, n_group, m = self._group_state(data, round_seed, g)
            states.append(state)
            ns.append(n_group)
            msum = m if msum is None else _tree_map(torch.add, msum, m)
        with torch.no_grad():
            stacked = _tree_map(lambda *xs: torch.stack(xs), *states)
            self.global_state = _weighted_mean(stacked, torch.stack(ns))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        m = {k: float(v) for k, v in msum.items()}
        out = {"round": self.round_idx,
               "Train/Loss": m["loss_sum"] / max(m["count"], 1),
               "Train/Acc": m["correct"] / max(m["count"], 1),
               "round_time_s": time.time() - t0}
        self.round_idx += 1
        return out


__all__ = ["round_robin_groups", "HierarchicalFedAvgAPI"]
