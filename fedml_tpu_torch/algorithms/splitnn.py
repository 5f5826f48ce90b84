"""SplitNN: split learning with the activation and gradient exchange of
every batch (counterpart of ``fedml_tpu/algorithms/splitnn.py``; the
reference's ``fedml_api/distributed/split_nn/``: the client half forwards
a batch and sends its activations and labels, the server half computes
the loss, backpropagates and returns the activation gradient, clients
take turns in a relay ring -- ``client_manager.py:35-70``,
``server.py:40-60``).

The activation handoff is a seam inside one autograd graph: one step
runs the client half's forward, the server half's forward and backward
and the client half's backward by the chain rule. The relay ring is kept:
within a round the clients train one after another, in ring order,
against the one server half and its optimizer state, which every client's
steps move. Client halves are personal: stacked ``[N, ...]``, each with
its own optimizer state. A fully masked step (the padding of a shorter
client) leaves both halves and both optimizer states untouched; the
batches are packed on the host, so such a step is skipped there.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.compression.compressors import tree_map
from fedml_tpu_torch.models.layers import lecun_init_
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig, fold_seed,
                                             make_optimizer)
from fedml_tpu_torch.parallel.packing import pack_cohort, pack_eval
from fedml_tpu_torch.utils.device import resolve_device


def _init_params(module, seed, device):
    """``module``'s parameters (the module on the CPU), drawn from
    ``seed`` with the reference's flax defaults, detached on
    ``device``."""
    lecun_init_(module.cpu(), torch.Generator().manual_seed(int(seed)))
    return {k: v.detach().clone().to(device)
            for k, v in module.named_parameters()}


class SplitNNAPI:
    """Args: the dataset 8-tuple and the two halves, ``client_model``
    (``x -> activations``) and ``server_model`` (``activations ->
    logits``), both ``nn.Module``s applied functionally over parameter
    dicts; ``args`` as the reference's (``lr``, ``wd``, ``momentum``,
    ``client_optimizer``, ``batch_size``, ``epochs``, ``comm_round``,
    ``seed``). ``device``: ``None`` runs on the GPU and raises without
    one; ``"cpu"`` runs on the CPU."""

    def __init__(self, dataset, client_model, server_model, args,
                 metrics_logger=None, device=None):
        (_, _, _, self.test_data_global, _, self.train_data_local_dict,
         self.test_data_local_dict, self.class_num) = dataset
        self.args = args
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        self.metrics_logger = metrics_logger or (
            lambda d: logging.info("%s", d))
        self.n_clients = len(self.train_data_local_dict)
        self.tx = make_optimizer(ClientUpdateConfig(
            optimizer=getattr(args, "client_optimizer", "sgd"),
            lr=args.lr, weight_decay=getattr(args, "wd", 0.0),
            momentum=getattr(args, "momentum", 0.0)))

        self.seed = int(getattr(args, "seed", 0))
        halves = [_init_params(client_model,
                               fold_seed(fold_seed(self.seed, 1), i),
                               self.device)
                  for i in range(self.n_clients)]
        self.client_params = {k: torch.stack([h[k] for h in halves])
                              for k in halves[0]}
        self.server_params = _init_params(server_model,
                                          fold_seed(self.seed, 2),
                                          self.device)
        # drawn on the host (the generators are CPU ones), then moved
        self.client_model = client_model.to(self.device)
        self.server_model = server_model.to(self.device)
        self.client_opt = self.tx.init(self.client_params, (self.n_clients,))
        self.server_opt = self.tx.init(self.server_params)
        self._data_rng = np.random.default_rng(self.seed)
        self.round_idx = 0

    def _logits(self, cp, sp, x):
        acts = functional_call(self.client_model, cp, (x,))
        return functional_call(self.server_model, sp, (acts,))

    def _step(self, cp, c_opt, sp, s_opt, batch):
        """One split step of one client: both halves' gradients through
        the seam, both optimizers' updates; the batch's summed metrics."""
        c_req = {k: v.detach().requires_grad_(True) for k, v in cp.items()}
        s_req = {k: v.detach().requires_grad_(True) for k, v in sp.items()}
        logits = self._logits(c_req, s_req, batch["x"])
        logp = F.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(1, batch["y"][:, None]).squeeze(1)
        mask = batch["mask"]
        loss_sum = (-ll * mask).sum()
        loss = loss_sum / mask.sum().clamp_min(1.0)
        grads = torch.autograd.grad(loss, list(c_req.values())
                                    + list(s_req.values()))
        g_c = dict(zip(c_req, grads[:len(c_req)]))
        g_s = dict(zip(s_req, grads[len(c_req):]))
        with torch.no_grad():
            cp, c_opt = self.tx.update(g_c, c_opt, cp)
            sp, s_opt = self.tx.update(g_s, s_opt, sp)
            correct = ((logits.argmax(dim=-1) == batch["y"]).float()
                       * mask).sum()
        return cp, c_opt, sp, s_opt, torch.stack(
            [loss_sum.detach(), correct, mask.sum()])

    def train_one_round(self):
        packed = pack_cohort(
            [self.train_data_local_dict[i] for i in range(self.n_clients)],
            self.args.batch_size, self.args.epochs, rng=self._data_rng)
        valid = packed["mask"].sum(axis=2) > 0   # [C, S] on the host
        dev = {k: torch.as_tensor(packed[k], device=self.device)
               for k in ("x", "y", "mask")}
        dev["y"] = dev["y"].long()
        sp, s_opt = self.server_params, self.server_opt
        totals = torch.zeros(3, dtype=torch.float32, device=self.device)
        for c in range(self.n_clients):   # ring order
            cp = {k: v[c] for k, v in self.client_params.items()}
            c_opt = tree_map(lambda v: v[c], self.client_opt)
            for s in np.flatnonzero(valid[c]):
                batch = {k: v[c, s] for k, v in dev.items()}
                cp, c_opt, sp, s_opt, m = self._step(cp, c_opt, sp, s_opt,
                                                     batch)
                totals = totals + m
            with torch.no_grad():
                for k, v in cp.items():
                    self.client_params[k][c] = v
                tree_map(lambda all_, one: all_[c].copy_(one),
                         self.client_opt, c_opt)
        self.server_params, self.server_opt = sp, s_opt
        loss_sum, correct, count = (float(v) for v in totals.cpu())
        out = {"round": self.round_idx,
               "Train/Loss": loss_sum / max(count, 1),
               "Train/Acc": correct / max(count, 1)}
        self.round_idx += 1
        self.metrics_logger(out)
        return out

    def evaluate(self, client_idx=0):
        """Test accuracy through client ``client_idx``'s half and the
        shared server half (the reference's ``run_eval``,
        ``client_manager.py:40-55``)."""
        packed = pack_eval(self.test_data_global, self.args.batch_size)
        cp = {k: v[client_idx] for k, v in self.client_params.items()}
        correct = torch.zeros((), device=self.device)
        with torch.no_grad():
            for s in range(packed["mask"].shape[0]):
                x = torch.as_tensor(packed["x"][s], device=self.device)
                y = torch.as_tensor(packed["y"][s],
                                    device=self.device).long()
                mask = torch.as_tensor(packed["mask"][s],
                                       device=self.device)
                logits = self._logits(cp, self.server_params, x)
                correct += ((logits.argmax(dim=-1) == y).float()
                            * mask).sum()
        count = float(packed["mask"].sum())
        return {"Test/Acc": float(correct) / max(count, 1)}

    def train(self):
        out = None
        for _ in range(self.args.comm_round):
            out = self.train_one_round()
        return out


__all__ = ["SplitNNAPI"]
