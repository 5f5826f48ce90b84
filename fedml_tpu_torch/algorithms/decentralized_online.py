"""Decentralized *online* learning over streaming data, DSGD and PushSum
(counterpart of ``fedml_tpu/algorithms/decentralized_online.py``).

Online logistic regression over per-node streams (SUSY, Room Occupancy
or the synthetic stream of ``data/uci.py``), one sample a node a time
step, gossip over a fixed or time-varying topology, scored by the
average online loss and the regret (the reference's
``decentralized_fl_api.py:20-99``, ``client_pushsum.py:7-129``,
``client_dsgd.py``).

The horizon is one loop over time on the device: node states stacked
``[N, d]``, streams ``[N, T, d]``. Each step predicts first, then
updates, which gives the true online loss the regret needs. DSGD gossips
push-style, ``x' = W_t^T x`` (sender ``i`` ships ``x_i`` weighted by its
own row entry); PushSum runs on the column-stochastic support matrix,
``x' = W_t x``, and carries the de-biasing weights ``omega``.

``time_varying`` relabels the nodes of ``W`` by a fresh permutation each
step (``W[perm][:, perm]``). The permutations come from
``np.random.default_rng(seed)``, or are handed in (``train(perms=)``, a
``[T, N]`` array), so a test can pass in another package's draws.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from fedml_tpu_torch.core.topology import mixing_matrix
from fedml_tpu_torch.utils.device import resolve_device


class DecentralizedOnlineAPI:
    """Online DSGD / PushSum over per-node streams.

    Args:
      streams: ``{node_id: {"x": [T_i, d], "y": [T_i]}}`` (``data/uci.py``
        loaders). The horizon T is the shortest stream.
      args: ``lr``, ``seed``, ``topology_neighbors``; ``time_varying``
        (bool) permutes the gossip matrix's nodes each step.
      algorithm: ``"dsgd"`` (row-stochastic, push mixing) or
        ``"pushsum"`` (column-stochastic with de-biasing weights).
      device: ``None`` runs on the GPU and raises without one; ``"cpu"``
        runs on the CPU.
    """

    def __init__(self, streams, args, topology=None, algorithm="dsgd",
                 metrics_logger=None, device=None):
        self.n_nodes = len(streams)
        self.algorithm = algorithm
        self.args = args
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        self.metrics_logger = metrics_logger or (
            lambda d: logging.info("%s", d))
        T = min(len(s["y"]) for s in streams.values())
        self.T, self.d = T, streams[0]["x"].shape[1]
        self.x = torch.as_tensor(np.stack(
            [np.asarray(streams[i]["x"][:T], np.float32)
             for i in range(self.n_nodes)]), device=self.device)
        self.y = torch.as_tensor(np.stack(
            [np.asarray(streams[i]["y"][:T], np.float32)
             for i in range(self.n_nodes)]), device=self.device)
        self.seed = int(getattr(args, "seed", 0))
        W = mixing_matrix(self.n_nodes, algorithm, topology,
                          getattr(args, "topology_neighbors", 2), self.seed)
        self.W = torch.as_tensor(W, device=self.device)
        self.time_varying = bool(getattr(args, "time_varying", False))
        self.lr = float(args.lr)

    def draw_perms(self):
        """The ``[T, N]`` node permutations of a time-varying run, one a
        step from ``np.random.default_rng(seed)``."""
        rng = np.random.default_rng(self.seed)
        return np.stack([rng.permutation(self.n_nodes)
                         for _ in range(self.T)])

    def run(self, w0, omega0, perms=None):
        """The horizon from ``w0 [N, d]`` and ``omega0 [N]``: returns
        ``(w_T, omega_T, losses [T, N], corrects [T, N])``. ``perms``
        ``[T, N]`` relabels ``W``'s nodes each step (time-varying)."""
        pushsum = self.algorithm == "pushsum"
        w, omega = w0, omega0
        if perms is not None:
            perms = torch.as_tensor(np.asarray(perms, np.int64),
                                    device=self.device)
        losses, corrects = [], []
        with torch.no_grad():
            for t in range(self.T):
                x_t, y_t = self.x[:, t], self.y[:, t]
                # predict with the de-biased iterate (PushSum) or the raw
                z = w / omega[:, None] if pushsum else w
                probs = torch.sigmoid((z * x_t).sum(dim=1))
                losses.append(-(y_t * torch.log(probs + 1e-8)
                                + (1 - y_t) * torch.log(1 - probs + 1e-8)))
                corrects.append(((probs > 0.5) == (y_t > 0.5)).float())
                grad = (probs - y_t)[:, None] * x_t
                W_t = (self.W if perms is None
                       else self.W[perms[t]][:, perms[t]])
                stepped = w - self.lr * grad
                if pushsum:
                    # omega rides as one more column: one product a step
                    mixed = W_t @ torch.cat([stepped, omega[:, None]], 1)
                    w, omega = mixed[:, :-1], mixed[:, -1]
                else:
                    w = W_t.T @ stepped
        return w, omega, torch.stack(losses), torch.stack(corrects)

    def train(self, perms=None):
        """Run the whole horizon; returns the node models ``[N, d]``
        (de-biased under PushSum) as numpy and logs the average online
        loss, accuracy, regret a step and the final consensus.
        ``perms`` hands in the time-varying permutations (default
        :meth:`draw_perms`); a fixed topology takes none."""
        if self.time_varying and perms is None:
            perms = self.draw_perms()
        elif not self.time_varying and perms is not None:
            raise ValueError("perms= needs a time-varying run "
                             "(args.time_varying)")
        w0 = torch.zeros((self.n_nodes, self.d), device=self.device)
        omega0 = torch.ones(self.n_nodes, device=self.device)
        wT, omegaT, losses, corrects = self.run(w0, omega0, perms)
        if self.algorithm == "pushsum":
            wT = wT / omegaT[:, None]
        self.w = wT.cpu().numpy()
        losses = losses.cpu().numpy()      # [T, N]
        corrects = corrects.cpu().numpy()  # [T, N]
        self.history = {
            "Online/AvgLoss": float(losses.mean()),
            "Online/AvgAcc": float(corrects.mean()),
            # the reference's ``cal_regret`` (decentralized_fl_api.py:
            # 11-17): cumulative loss / (client_number * (t+1)) at the
            # final step
            "Online/Regret": float(losses.sum() /
                                   (losses.shape[1] * losses.shape[0])),
            "Online/FinalConsensus": float(
                np.linalg.norm(self.w - self.w.mean(0, keepdims=True)) /
                max(1, self.n_nodes)),
        }
        self.metrics_logger(self.history)
        return self.w

    def consensus_distance(self):
        w = self.w
        return float(np.mean(np.linalg.norm(
            w - w.mean(0, keepdims=True), axis=1)))


__all__ = ["DecentralizedOnlineAPI"]
