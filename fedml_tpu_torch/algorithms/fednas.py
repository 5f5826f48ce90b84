"""FedNAS: federated architecture search over the DARTS space
(counterpart of ``fedml_tpu/algorithms/fednas.py``).

Each client alternates an architecture step on its validation half with
a weight step on its training half; the server takes the sample-weighted
mean of the weights, the BatchNorm statistics and the alphas, and the
genotype is derived every round.

- The architecture step differentiates ``L_val(w - xi * grad_w
  L_train(w, alpha), alpha)`` with respect to alpha exactly (second
  order, ``arch_order=2``): ``torch.autograd.grad(...,
  create_graph=True)`` through the inner weight gradient, where the
  reference takes one ``jax.grad``. ``arch_order=1`` drops the inner
  step. The inner and validation passes' BatchNorm statistics are
  thrown away; only the weight step's are kept.
- The arch optimizer is L2 decay then Adam (b1 0.5, b2 0.999, optax's
  eps 1e-8 and bias correction); the weight optimizer is the global-norm
  clip at 5.0, then decay 3e-4, then SGD with momentum 0.9
  (``parallel/engine.py`` ``ClipByGlobalNorm``).
- A step whose training batch is fully masked (a short client's
  padding) leaves the client untouched and is skipped.

Clients of a cohort train one after another (the second-order step
keeps a double-backward graph of one client at a time).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.models.darts import DARTSNetwork, derive_genotype
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                             _tree_map, _weighted_sum,
                                             make_eval_fn, make_optimizer)
from fedml_tpu_torch.parallel.packing import pack_cohort, pack_eval
from fedml_tpu_torch.program.cohort import client_sampling
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.profiling import end_of_round_sync


@dataclasses.dataclass(frozen=True)
class FedNASConfig:
    """Search-stage hyperparameters (the reference's FedNAS flags and
    optimizers)."""
    lr: float = 0.025            # weight SGD lr
    momentum: float = 0.9
    weight_decay: float = 3e-4
    grad_clip: float = 5.0
    arch_lr: float = 3e-4        # arch Adam
    arch_weight_decay: float = 1e-3
    arch_order: int = 2          # 2 = unrolled (second order), 1 = first
    unrolled_xi: float = 0.025   # inner-step lr of the unrolled term


class ArchAdam:
    """``optax.chain(add_decayed_weights(wd), adam(lr, b1, b2))`` over a
    dict of tensors: ``g' = g + wd*a``, ``mu = (1-b1) g' + b1 mu``, ``nu
    = (1-b2) g'^2 + b2 nu``, ``a <- a - lr * mu_hat / (sqrt(nu_hat) +
    eps)`` with the bias corrections ``1 - b^count``."""

    def __init__(self, lr, weight_decay, b1=0.5, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (
            lr, weight_decay, b1, b2, eps)

    def init(self, params):
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": zeros(), "nu": zeros()}

    def update(self, grads, state, params):
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        new, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            mu[k] = (1 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            new[k] = p + (-self.lr) * u
        return new, {"count": count, "mu": mu, "nu": nu}


def _req(tree):
    return {k: v.detach().requires_grad_(True) for k, v in tree.items()}


def _loss(spec, params, rest, arch, batch):
    st = dict(rest)
    st["params"], st["arch"] = params, arch
    return spec.loss_fn(st, batch, True)


def make_arch_grad_fn(spec, cfg: FedNASConfig):
    """``fn(params, rest, arch, train_batch, val_batch) -> {name: grad}``:
    the gradient of the validation loss with respect to the alphas, at
    the unrolled weights ``w - xi * grad_w L_train(w, alpha)`` for
    ``arch_order=2`` (differentiated through the inner gradient), at
    ``w`` for ``arch_order=1``. ``rest`` holds the BatchNorm statistics,
    which both passes use and neither keeps."""

    def arch_grads(params, rest, arch, train_b, val_b):
        a_req = _req(arch)
        if cfg.arch_order == 2:
            p_req = _req(params)
            l_train = _loss(spec, p_req, rest, a_req, train_b)[0]
            g = torch.autograd.grad(l_train, list(p_req.values()),
                                    create_graph=True)
            p2 = {k: p - cfg.unrolled_xi * g_k
                  for (k, p), g_k in zip(p_req.items(), g)}
        else:
            p2 = params
        l_val = _loss(spec, p2, rest, a_req, val_b)[0]
        # a network without reduction cells never reads alphas_reduce:
        # its gradient is zeros, as jax.grad gives it
        return dict(zip(a_req, torch.autograd.grad(
            l_val, list(a_req.values()), allow_unused=True,
            materialize_grads=True)))

    return arch_grads


def make_search_client_update(spec, cfg: FedNASConfig):
    """One client's local search: for every step, the arch step on the
    validation batch, then the weight step on the training batch.

    Returns ``fn(global_state, client_data) -> (local_state, metrics
    sum)``; ``client_data`` holds one client's ``x [S, B, ...]``, ``y``,
    ``mask [S, B]`` and the parallel ``val_x``/``val_y`` streams
    (:func:`_pack_search_cohort`) as tensors on the state's device."""
    w_opt = make_optimizer(ClientUpdateConfig(
        optimizer="sgd", lr=cfg.lr, weight_decay=cfg.weight_decay,
        momentum=cfg.momentum, grad_clip=cfg.grad_clip))
    a_opt = ArchAdam(cfg.arch_lr, cfg.arch_weight_decay)
    arch_grads = make_arch_grad_fn(spec, cfg)

    def client_update(global_state, data):
        params = dict(global_state["params"])
        arch = dict(global_state["arch"])
        rest = {k: v for k, v in global_state.items()
                if k not in ("params", "arch")}
        w_state = w_opt.init(params)
        a_state = a_opt.init(arch)
        msum = None
        valid = (data["mask"].sum(dim=1) > 0).tolist()
        for s in range(data["mask"].shape[0]):
            if not valid[s]:
                continue
            train_b = {"x": data["x"][s], "y": data["y"][s],
                       "mask": data["mask"][s]}
            val_b = {"x": data["val_x"][s], "y": data["val_y"][s],
                     "mask": torch.ones_like(data["mask"][s])}
            a_grads = arch_grads(params, rest, arch, train_b, val_b)
            with torch.no_grad():
                arch, a_state = a_opt.update(a_grads, a_state, arch)
            p_req = _req(params)
            loss, (new_state, metrics) = _loss(spec, p_req, rest, arch,
                                               train_b)
            grads = dict(zip(p_req, torch.autograd.grad(
                loss, list(p_req.values()))))
            with torch.no_grad():
                params, w_state = w_opt.update(grads, w_state, params)
            rest = {k: {n: t.detach() for n, t in new_state[k].items()}
                    for k in rest}
            metrics = {k: v.detach() for k, v in metrics.items()}
            msum = metrics if msum is None else {k: msum[k] + metrics[k]
                                                 for k in msum}
        local = dict(rest)
        local["params"], local["arch"] = params, arch
        return local, msum

    return client_update


def _pack_search_cohort(datasets, batch_size, epochs, rng):
    """Each client's shard split 50/50 into train and val halves: the
    train half packed with mask and pad (``pack_cohort``), the val half
    cycled into a parallel ``[S, B]`` stream (wrap-around sampling, so
    every val batch is full and carries no mask)."""
    train_sets, val_sets = [], []
    for d in datasets:
        n = len(d["y"])
        split = max(1, n // 2)
        train_sets.append({"x": d["x"][:split], "y": d["y"][:split]})
        val_sets.append({"x": d["x"][split:] if n - split > 0
                         else d["x"][:split],
                         "y": d["y"][split:] if n - split > 0
                         else d["y"][:split]})
    packed = pack_cohort(train_sets, batch_size, epochs, rng=rng)
    S, B = packed["mask"].shape[1], packed["mask"].shape[2]
    val_x, val_y = [], []
    for d in val_sets:
        n = len(d["y"])
        if n == 0:
            # an empty shard's all-zero train mask skips every step
            val_x.append(np.zeros((S, B) + d["x"].shape[1:], d["x"].dtype))
            val_y.append(np.zeros((S, B) + d["y"].shape[1:], d["y"].dtype))
            continue
        idx = np.concatenate([rng.permutation(n) for _ in range(
            int(np.ceil(S * B / n)) + 1)])[:S * B]
        val_x.append(d["x"][idx].reshape((S, B) + d["x"].shape[1:]))
        val_y.append(d["y"][idx].reshape((S, B) + d["y"].shape[1:]))
    packed["val_x"] = np.stack(val_x)
    packed["val_y"] = np.stack(val_y)
    return packed


def weighted_mean(states, weights):
    """The sample-weighted mean of same-structured states (dicts of
    tensors), in fp32 (``parallel/engine.py`` ``_weighted_sum``): weights
    normalised by their total, a uniform mean when every weight is 0."""
    w = torch.as_tensor(np.asarray(weights, np.float32))
    total = float(w.sum())
    norm = w / total if total > 0 else torch.full_like(w, 1.0 / len(w))
    leaf = states[0]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    stacked = _tree_map(lambda *xs: torch.stack(xs), *states)
    return _tree_map(lambda m, x: m.to(x.dtype),
                     _weighted_sum(stacked, norm.to(leaf.device)), states[0])


class FedNASAPI:
    """Federated DARTS search (``main_fednas.py --stage search``).

    ``dataset`` is the 8-tuple contract; the model is the DARTS search
    network. Every round: draw the cohort, search locally on each
    client, average weights and alphas by samples, derive the genotype.
    ``device`` (or ``args.device``): None runs on the card and raises
    without one; ``"cpu"`` runs on the CPU.
    """

    def __init__(self, dataset, args, model=None, cfg: FedNASConfig = None,
                 metrics_logger=None, device=None):
        (self.train_data_num, self.test_data_num, self.train_data_global,
         self.test_data_global, self.train_data_local_num_dict,
         self.train_data_local_dict, self.test_data_local_dict,
         self.class_num) = dataset
        self.args = args
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        self.cfg = cfg or FedNASConfig(
            lr=getattr(args, "lr", 0.025),
            arch_order=getattr(args, "arch_order", 2))
        self.model = model or DARTSNetwork(
            C=getattr(args, "init_channels", 16),
            layers=getattr(args, "layers", 8), num_classes=self.class_num)
        self.spec = make_classification_spec(self.model, name="fednas")
        self.metrics_logger = metrics_logger or (
            lambda d: logging.info("%s", d))
        seed = getattr(args, "seed", 0)
        self.global_state = self.spec.init_fn(seed, self.device)
        self._data_rng = np.random.default_rng(seed)
        self.round_idx = 0
        self.history = []
        self.client_update = make_search_client_update(self.spec, self.cfg)
        self.eval_fn = make_eval_fn(self.spec)

    def _client_data(self, packed, c):
        out = {k: torch.as_tensor(packed[k][c], device=self.device)
               for k in ("x", "y", "mask", "val_x", "val_y")}
        out["y"], out["val_y"] = out["y"].long(), out["val_y"].long()
        return out

    def train_one_round(self):
        t0 = time.time()
        idxs = client_sampling(self.round_idx,
                               len(self.train_data_local_dict),
                               self.args.client_num_per_round)
        datasets = [self.train_data_local_dict[i] for i in idxs]
        packed = _pack_search_cohort(datasets, self.args.batch_size,
                                     self.args.epochs, self._data_rng)
        locals_, msums = [], []
        for c in range(len(datasets)):
            local, msum = self.client_update(self.global_state,
                                             self._client_data(packed, c))
            locals_.append(local)
            if msum is not None:
                msums.append(msum)
        self.global_state = weighted_mean(locals_, packed["n"])
        end_of_round_sync(self.global_state, self.device)
        m = {k: sum(float(ms[k]) for ms in msums) for k in
             ("loss_sum", "correct", "count")}
        out = {"round": self.round_idx,
               "Train/Loss": m["loss_sum"] / max(m["count"], 1),
               "Train/Acc": m["correct"] / max(m["count"], 1),
               "genotype": self.genotype(),
               "round_time_s": time.time() - t0}
        self.metrics_logger({k: v for k, v in out.items()
                             if k != "genotype"})
        self.history.append(out)
        self.round_idx += 1
        return out

    def genotype(self):
        return derive_genotype(self.global_state["arch"])

    def evaluate(self):
        data = pack_eval(self.test_data_global, self.args.batch_size)
        m = {k: float(v) for k, v in self.eval_fn(self.global_state,
                                                  data).items()}
        count = max(m["count"], 1)
        return {"Test/Acc": m["correct"] / count,
                "Test/Loss": m["loss_sum"] / count}

    def train(self):
        for _ in range(self.args.comm_round):
            self.train_one_round()
        return self.genotype()


__all__ = ["FedNASConfig", "ArchAdam", "make_arch_grad_fn",
           "make_search_client_update",
           "_pack_search_cohort", "weighted_mean", "FedNASAPI"]
