"""Centralized (non-FL) baseline on the pooled dataset (counterpart of
``fedml_tpu/algorithms/centralized.py``).

The pooled data trains as one client through the same client update
FedAvg runs, so full-batch FedAvg with one local epoch over all clients
equals centralized training by an identity of the shared engine: the
gradient of the pooled mean loss is the sample-weighted mean of the
clients' full-batch gradients. A round's draws come from the client seed
``client_seeds_for(fold_seed(seed, round), 1)``, as a FedAvg round's
first cohort slot.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from fedml_tpu_torch.core.trainer import TrainSpec
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                             client_seeds_for, fold_seed,
                                             make_client_update,
                                             make_eval_fn)
from fedml_tpu_torch.parallel.packing import pack_cohort, pack_eval
from fedml_tpu_torch.utils.device import resolve_device


class CentralizedTrainer:
    """Epoch-loop trainer on the pooled (global) train set: a "round" is
    ``args.epochs`` epochs, and ``comm_round`` rounds make a run, so run
    lengths compare with federated runs. ``device`` as ``FedAvgAPI``'s:
    the card unless ``"cpu"``."""

    def __init__(self, dataset, spec: TrainSpec, args, metrics_logger=None,
                 device=None):
        (self.train_data_num, self.test_data_num, self.train_data_global,
         self.test_data_global, _, _, _, self.class_num) = dataset
        self.spec, self.args = spec, args
        self.device = resolve_device(device)
        self.metrics_logger = metrics_logger or (
            lambda d: logging.info("%s", d))
        cfg = ClientUpdateConfig(
            optimizer=getattr(args, "client_optimizer", "sgd"),
            lr=args.lr,
            weight_decay=getattr(args, "wd", 0.0),
            momentum=getattr(args, "momentum", 0.0))
        self._update = make_client_update(spec, cfg)
        self.eval_fn = make_eval_fn(spec)
        self.seed = int(getattr(args, "seed", 0))
        self.global_state = spec.init_fn(self.seed, self.device)
        self.server_state = ()
        self._data_rng = np.random.default_rng(self.seed)
        self.round_idx = 0
        self.history = []

    def train_one_round(self):
        """``args.epochs`` epochs over the pooled data as one client."""
        t0 = time.time()
        packed = pack_cohort([self.train_data_global], self.args.batch_size,
                             self.args.epochs, rng=self._data_rng)
        data = {k: torch.as_tensor(v, device=self.device)
                for k, v in packed.items()}
        data["y"] = data["y"].long()
        seeds = client_seeds_for(fold_seed(self.seed, self.round_idx), 1)
        local, _, metrics = self._update(self.global_state, data, seeds)
        self.global_state = {k: {n: t[0] for n, t in v.items()}
                             for k, v in local.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        m = {k: float(v.sum()) for k, v in metrics.items()}
        out = {"round": self.round_idx,
               "Train/Loss": m["loss_sum"] / max(m["count"], 1),
               "Train/Acc": m["correct"] / max(m["count"], 1),
               "round_time_s": time.time() - t0}
        self.round_idx += 1
        return out

    def evaluate_global(self):
        m = self.eval_fn(self.global_state,
                         pack_eval(self.test_data_global,
                                   self.args.batch_size))
        count = max(float(m["count"]), 1)
        return {"Test/Loss": float(m["loss_sum"]) / count,
                "Test/Acc": float(m["correct"]) / count}

    def train(self, on_round=None):
        """Rounds until ``comm_round``, evaluating every
        ``frequency_of_the_test`` rounds and on the last; ``on_round(self,
        metrics)`` runs after each."""
        freq = getattr(self.args, "frequency_of_the_test", 5)
        while self.round_idx < self.args.comm_round:
            metrics = self.train_one_round()
            last = self.round_idx == self.args.comm_round
            if self.round_idx % freq == 0 or last:
                metrics.update(self.evaluate_global())
            self.metrics_logger(metrics)
            self.history.append(metrics)
            if on_round is not None:
                on_round(self, metrics)
        return self.global_state


__all__ = ["CentralizedTrainer"]
