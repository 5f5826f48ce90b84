"""Classical vertical (feature-partitioned) FL (counterpart of
``fedml_tpu/algorithms/vertical.py``; the reference's
``classical_vertical_fl/guest_trainer.py:59-80`` and
``standalone/classical_vertical_fl/vfl.py:21-56``).

The label-holding *guest* (party 0) and the feature-only *hosts* each run
a local model that gives one logit contribution a row; the hosts send
theirs to the guest, the guest sums them, computes the binary
cross-entropy on the summed logit and sends back the gradient with
respect to it, and each party backpropagates locally. The values that
cross the seam are exactly what autograd routes through the sum, so one
step is one backward over the party list; each party's parameters and
optimizer state stay its own, and labels and loss stay with the guest.

Minibatch order comes from ``np.random.default_rng(seed).permutation``
each epoch, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from fedml_tpu_torch.models.layers import lecun_init_
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig, fold_seed,
                                             make_optimizer)
from fedml_tpu_torch.utils.device import resolve_device


def bce_with_logits(logit, y):
    """Mean binary cross-entropy of ``y`` on ``logit``, in the stable
    form the reference writes out."""
    return torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))


class VerticalFLAPI:
    """Args:
      party_models: ``nn.Module``s, one a party, index 0 the guest; each
        maps its party's features ``[n, d_k]`` to one logit a row.
      party_data: the parties' feature matrices ``x_k [n, d_k]``, rows in
        the same order (record linkage done, as in the reference
        loaders).
      labels: ``y [n]`` binary (or ``[n, 1]``), held by the guest.
      args: ``lr``, ``wd``, ``client_optimizer``, ``batch_size``,
        ``epochs``, ``seed``.
      device: ``None`` runs on the GPU and raises without one; ``"cpu"``
        runs on the CPU.
    """

    def __init__(self, party_models, party_data, labels, args,
                 test_party_data=None, test_labels=None, device=None):
        if len(party_models) != len(party_data):
            raise ValueError(f"{len(party_models)} party models for "
                             f"{len(party_data)} feature blocks")
        self.args = args
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        self.n_parties = len(party_models)
        dev = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device)
        self.x_parts = [dev(x) for x in party_data]
        self.y = dev(labels).reshape(-1)
        self.x_test = ([dev(x) for x in test_party_data]
                       if test_party_data is not None else None)
        self.y_test = (dev(test_labels).reshape(-1)
                       if test_labels is not None else None)
        self.tx = make_optimizer(ClientUpdateConfig(
            optimizer=getattr(args, "client_optimizer", "sgd"),
            lr=args.lr, weight_decay=getattr(args, "wd", 0.0)))
        seed = int(getattr(args, "seed", 0))
        # drawn on the host (CPU generators), then moved to the device
        self.params = []
        for i, m in enumerate(party_models):
            lecun_init_(m.cpu(), torch.Generator().manual_seed(
                int(fold_seed(seed, i))))
            self.params.append({k: v.detach().clone().to(self.device)
                                for k, v in m.named_parameters()})
        self.models = [m.to(self.device) for m in party_models]
        self.opts = [self.tx.init(p) for p in self.params]
        self._data_rng = np.random.default_rng(seed)
        self.history = []

    def _loss(self, params_list, xs, y):
        """The guest's loss and correct count on the summed logit."""
        logit = sum(functional_call(m, p, (x,)).reshape(-1)
                    for m, p, x in zip(self.models, params_list, xs))
        correct = ((logit > 0) == (y > 0.5)).sum()
        return bce_with_logits(logit, y), correct

    def _train_step(self, xs, y):
        reqs = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                for p in self.params]
        loss, correct = self._loss(reqs, xs, y)
        grads = torch.autograd.grad(
            loss, [v for r in reqs for v in r.values()])
        with torch.no_grad():
            i = 0
            for k, (p, o, r) in enumerate(zip(self.params, self.opts, reqs)):
                g = dict(zip(r, grads[i:i + len(r)]))
                i += len(r)
                self.params[k], self.opts[k] = self.tx.update(g, o, p)
        return loss.detach(), correct

    def fit(self):
        """The epoch loop over joined minibatches (the reference's
        ``vfl_fixture.py`` fit loop); one record an epoch."""
        n = int(self.y.shape[0])
        bs = self.args.batch_size
        for epoch in range(self.args.epochs):
            order = self._data_rng.permutation(n)
            losses, correct = [], torch.zeros((), device=self.device)
            for s in range(0, n, bs):
                idx = torch.as_tensor(order[s:s + bs], device=self.device)
                loss, c = self._train_step([x[idx] for x in self.x_parts],
                                           self.y[idx])
                losses.append(loss)
                correct = correct + c
            rec = {"epoch": epoch,
                   "Train/Loss": float(np.mean(
                       torch.stack(losses).cpu().numpy().astype(np.float64))),
                   "Train/Acc": float(correct) / n}
            if self.x_test is not None:
                rec.update(self.evaluate())
            self.history.append(rec)
        return self.history

    def evaluate(self):
        with torch.no_grad():
            loss, correct = self._loss(self.params, self.x_test, self.y_test)
        return {"Test/Loss": float(loss),
                "Test/Acc": float(correct) / len(self.y_test)}


__all__ = ["VerticalFLAPI", "bce_with_logits"]
