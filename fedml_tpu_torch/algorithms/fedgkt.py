"""FedGKT: Group Knowledge Transfer (counterpart of
``fedml_tpu/algorithms/fedgkt.py``).

Every client trains a small edge model with cross-entropy plus
``alpha`` times the temperature KL against its teacher logits, then
extracts feature maps and logits of each of its batches (eval mode);
the server trains a large model on every client's features with the
same distillation loss against the client logits and hands back fresh
per-sample teacher logits.

- Each round packs every client's shard (``pack_cohort(...,
  return_indices=True)``); the teacher logits live per client and per
  sample (``[C, max_n, classes]``), gathered into the round's slots and
  scattered back by slot index, so the next round's reshuffled packing
  reads the teacher of the same sample.
- The server phase runs over all clients' batches in client-major
  order; its loss is summed over the batch and divided by the count
  after the sum (the reference's form, kept for its sharded variant).
- Batches are zero-padded to the batch size and BatchNorm normalises
  over the padded slots, as in the reference; a fully padded batch
  changes nothing and is skipped.
- ``evaluate`` scores the edge-to-server pipeline through every
  client's own extractor on its local test shard.
- Given a ``mesh`` with a ``model`` axis of ``n > 1`` ranks
  (``parallel.mesh.make_client_mesh(1, n)``, one process a rank, every
  rank running the whole API), each server batch splits over ``model``
  when ``batch_size`` divides by ``n`` (else a warning, and the phase
  runs unsharded, as in the reference): a rank trains on its rows, the
  loss sums, counts and gradients are summed over ``model`` and the
  BatchNorm statistics averaged, so every rank takes the same step (the
  reference's ``nn.DataParallel`` semantics); the fresh logits are
  gathered back in row order. A BN-free server equals the unsharded
  phase; a BN server normalises each rank's rows apart, as DataParallel
  does.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.func import functional_call

from fedml_tpu_torch.models.layers import lecun_init_
from fedml_tpu_torch.parallel.engine import ClientUpdateConfig, make_optimizer
from fedml_tpu_torch.parallel.mesh import MODEL_AXIS
from fedml_tpu_torch.parallel.multihost import all_reduce_sum
from fedml_tpu_torch.parallel.packing import pack_cohort, pack_eval
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.torch_import import module_state


def kl_divergence(student_logits, teacher_logits, T):
    """``KL(softmax(teacher/T) || softmax(student/T)) * T^2`` per
    sample (Hinton distillation)."""
    t_logits = teacher_logits.float() / T
    t = torch.softmax(t_logits, dim=-1)
    log_s = torch.log_softmax(student_logits.float() / T, dim=-1)
    log_t = torch.log_softmax(t_logits, dim=-1)
    return (t * (log_t - log_s)).sum(dim=-1) * (T * T)


def _masked_ce(logits, y, mask):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, y.long()[..., None])[..., 0] * mask


def _apply(model, state, x, train):
    """``model`` on ``state`` (``{"params", "batch_stats"}``): the output
    and the new statistics (the caller's stay untouched)."""
    stats = {k: v.clone() for k, v in state["batch_stats"].items()}
    out = functional_call(model, {**state["params"], **stats}, (x,),
                          {"train": train})
    return out, stats


def _stack(states):
    return {k: {n: torch.stack([s[k][n] for s in states])
                for n in states[0][k]} for k in states[0]}


def _index(stacked, i):
    return {k: {n: t[i] for n, t in v.items()} for k, v in stacked.items()}


class FedGKTAPI:
    """Args: ``temperature`` (default 3.0), ``alpha_distill`` (KL weight,
    default 1.0), ``epochs`` (client), ``server_epochs``, ``lr``, ``wd``,
    ``client_optimizer``, ``server_optimizer_gkt``, ``server_lr``.
    ``client_states`` holds every client's state stacked on a leading
    client axis. ``device`` (or ``args.device``): None runs on the card
    and raises without one; ``"cpu"`` runs on the CPU."""

    def __init__(self, dataset, client_model, server_model, args,
                 mesh=None, metrics_logger=None, device=None):
        (_, _, _, self.test_data_global, _, self.train_data_local_dict,
         self.test_data_local_dict, self.class_num) = dataset
        self.args = args
        self.mesh = None
        n_shards = dict(getattr(mesh, "shape", {})).get(MODEL_AXIS, 1)
        if n_shards > 1 and args.batch_size % n_shards:
            logging.warning(
                "fedgkt: batch_size %d not divisible by %d model shards; "
                "server phase runs unsharded", args.batch_size, n_shards)
        elif n_shards > 1:
            self.mesh = mesh
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        self.client_model, self.server_model = client_model, server_model
        self.metrics_logger = metrics_logger or (lambda d: None)
        self.n_clients = len(self.train_data_local_dict)
        self.T = getattr(args, "temperature", 3.0)
        self.alpha = getattr(args, "alpha_distill", 1.0)
        self.server_epochs = getattr(args, "server_epochs", 1)
        self.client_tx = make_optimizer(ClientUpdateConfig(
            optimizer=getattr(args, "client_optimizer", "sgd"),
            lr=args.lr, weight_decay=getattr(args, "wd", 0.0)))
        self.server_tx = make_optimizer(ClientUpdateConfig(
            optimizer=getattr(args, "server_optimizer_gkt", "sgd"),
            lr=getattr(args, "server_lr", args.lr),
            weight_decay=getattr(args, "wd", 0.0)))

        gen = torch.Generator().manual_seed(int(getattr(args, "seed", 0)))
        states = []
        for _ in range(self.n_clients):
            lecun_init_(client_model, gen)
            states.append(self._to_device(module_state(client_model)))
        self.client_states = _stack(states)
        lecun_init_(server_model, gen)
        self.server_state = self._to_device(module_state(server_model))
        self.server_opt = self.server_tx.init(self.server_state["params"])
        self._data_rng = np.random.default_rng(getattr(args, "seed", 0))
        self.round_idx = 0
        # per-sample teacher logits, aligned to each client's sample order
        self._max_n = max(len(d["y"])
                          for d in self.train_data_local_dict.values())
        self.teacher_logits = np.zeros(
            (self.n_clients, self._max_n, self.class_num), np.float32)
        self.server_logits = None  # the last round's per-slot logits

    def _to_device(self, state):
        return {k: {n: t.to(self.device) for n, t in v.items()}
                for k, v in state.items()}

    def _tensor(self, a, long=False):
        t = torch.as_tensor(a, device=self.device)
        return t.long() if long else t

    # -- client phase --------------------------------------------------
    def _client_loss(self, state, x, y, mask, t_logits):
        (_, logits), stats = _apply(self.client_model, state, x, True)
        ce = _masked_ce(logits, y, mask)
        kl = kl_divergence(logits, t_logits, self.T) * mask
        count = torch.clamp(mask.sum(), min=1.0)
        loss = (ce.sum() + self.alpha * kl.sum()) / count
        correct = ((logits.argmax(dim=-1) == y).float() * mask).sum()
        return loss, stats, {"loss_sum": ce.sum().detach(),
                             "correct": correct, "count": mask.sum()}

    def _one_client(self, state, x, y, mask, teacher, valid):
        """One client's local epochs, then its extraction pass: ``(state,
        features [S, B, ...], logits [S, B, classes], metrics sum)``;
        the features and logits of a fully padded batch are zeros."""
        params = state["params"]
        stats = state["batch_stats"]
        opt = self.client_tx.init(params)
        msum = None
        for s in np.flatnonzero(valid):
            p_req = {k: v.detach().requires_grad_(True)
                     for k, v in params.items()}
            loss, new_stats, metrics = self._client_loss(
                {"params": p_req, "batch_stats": stats}, x[s], y[s],
                mask[s], teacher[s])
            grads = dict(zip(p_req, torch.autograd.grad(
                loss, list(p_req.values()))))
            with torch.no_grad():
                params, opt = self.client_tx.update(grads, opt, params)
            stats = {k: v.detach() for k, v in new_stats.items()}
            msum = metrics if msum is None else {k: msum[k] + metrics[k]
                                                 for k in msum}
        state = {"params": params, "batch_stats": stats}
        feats, logits = [], []
        with torch.no_grad():
            for s in range(x.shape[0]):
                if valid[s]:
                    (f, lg), _ = _apply(self.client_model, state, x[s],
                                        False)
                else:
                    f, lg = None, None
                feats.append(f)
                logits.append(lg)
        return state, feats, logits, msum

    # -- server phase --------------------------------------------------
    def _server_shard(self):
        """``(rows, group, n)`` of this rank's slice of every server
        batch over ``model``, or ``(slice(None), None, 1)`` unsharded."""
        if self.mesh is None:
            return slice(None), None, 1
        n = self.mesh.shape[MODEL_AXIS]
        b = self.args.batch_size // n
        me = self.mesh.index(MODEL_AXIS)
        return slice(me * b, (me + 1) * b), self.mesh.group(MODEL_AXIS), n

    def _server_round(self, feats, client_logits, ys, masks, valid):
        """Train the server on every client's valid batches (client-major)
        for ``server_epochs``, then infer fresh logits for each; returns
        ``[C, S, B, classes]`` logits (zeros for padded batches). Over a
        ``model`` axis each rank takes its rows of every batch and the
        ranks meet in the sums (module docstring)."""
        sm, tx = self.server_model, self.server_tx
        rows, group, n = self._server_shard()
        order = [(c, s) for c in range(valid.shape[0])
                 for s in range(valid.shape[1]) if valid[c, s]]
        state, opt = self.server_state, self.server_opt
        for _ in range(self.server_epochs):
            for c, s in order:
                m = masks[c, s][rows]
                p_req = {k: v.detach().requires_grad_(True)
                         for k, v in state["params"].items()}
                logits, stats = _apply(
                    sm, {"params": p_req,
                         "batch_stats": state["batch_stats"]},
                    feats[c][s][rows], True)
                ce = _masked_ce(logits, ys[c, s][rows], m)
                kl = kl_divergence(logits, client_logits[c][s][rows],
                                   self.T) * m
                loss_sum = ce.sum() + self.alpha * kl.sum()
                grads = dict(zip(p_req, torch.autograd.grad(
                    loss_sum, list(p_req.values()))))
                cnt = m.sum()
                stats = {k: v.detach() for k, v in stats.items()}
                if group is not None:
                    cnt, grads, stats = all_reduce_sum((cnt, grads, stats),
                                                       group)
                    stats = {k: v / n for k, v in stats.items()}
                cnt = torch.clamp(cnt, min=1.0)
                grads = {k: g / cnt for k, g in grads.items()}
                with torch.no_grad():
                    params, opt = tx.update(grads, opt, state["params"])
                state = {"params": params, "batch_stats": stats}
        self.server_state, self.server_opt = state, opt
        C, S, B = masks.shape
        out = torch.zeros((C, S, B, self.class_num), device=self.device)
        with torch.no_grad():
            for c, s in order:
                lg = _apply(sm, state, feats[c][s][rows], False)[0]
                if group is not None:
                    parts = [torch.empty_like(lg) for _ in range(n)]
                    torch.distributed.all_gather(parts, lg.contiguous(),
                                                 group=group)
                    lg = torch.cat(parts)
                out[c, s] = lg
        return out

    def train_one_round(self):
        packed = pack_cohort(
            [self.train_data_local_dict[i] for i in range(self.n_clients)],
            self.args.batch_size, self.args.epochs, rng=self._data_rng,
            return_indices=True)
        ci = np.arange(self.n_clients)[:, None, None]
        teacher = self._tensor(self.teacher_logits[ci, packed["idx"]])
        x = self._tensor(packed["x"])
        ys = self._tensor(packed["y"], long=True)
        masks = self._tensor(packed["mask"])
        valid = packed["mask"].sum(axis=2) > 0
        states, feats, logits, msums = [], [], [], []
        for c in range(self.n_clients):
            st, f, lg, ms = self._one_client(
                _index(self.client_states, c), x[c], ys[c], masks[c],
                teacher[c], valid[c])
            states.append(st)
            feats.append(f)
            logits.append(lg)
            if ms is not None:
                msums.append(ms)
        self.client_states = _stack(states)
        self.server_logits = self._server_round(feats, logits, ys, masks,
                                                valid)
        # scatter the fresh server logits back to per-sample alignment
        sl = self.server_logits.cpu().numpy()
        m = packed["mask"] > 0
        client_ids = np.broadcast_to(ci, m.shape)[m]
        self.teacher_logits[client_ids, packed["idx"][m]] = sl[m]
        tot = {k: sum(float(ms[k]) for ms in msums)
               for k in ("loss_sum", "correct", "count")}
        out = {"round": self.round_idx,
               "Train/Loss": tot["loss_sum"] / max(tot["count"], 1),
               "Train/Acc": tot["correct"] / max(tot["count"], 1)}
        self.round_idx += 1
        self.metrics_logger(out)
        return out

    def evaluate(self):
        """The edge-to-server pipeline over every client's own extractor
        on its local test shard (the global test set through every
        extractor when no client has one): ``Test/Acc``,
        ``Test/Samples`` and ``Test/Correct``."""
        shards, sel = [], []
        for i in range(self.n_clients):
            d = self.test_data_local_dict.get(i)
            if d is not None and len(d["y"]):
                shards.append(d)
                sel.append(i)
        if not shards:
            shards = [self.test_data_global] * self.n_clients
            sel = list(range(self.n_clients))
        correct = count = 0.0
        with torch.no_grad():
            for i, d in zip(sel, shards):
                state = _index(self.client_states, i)
                p = pack_eval(d, self.args.batch_size)
                for s in range(p["mask"].shape[0]):
                    xb = self._tensor(p["x"][s])
                    yb = self._tensor(p["y"][s], long=True)
                    mb = self._tensor(p["mask"][s])
                    (f, _), _ = _apply(self.client_model, state, xb, False)
                    lg, _ = _apply(self.server_model, self.server_state, f,
                                   False)
                    correct += float(((lg.argmax(dim=-1) == yb).float()
                                      * mb).sum())
                    count += float(mb.sum())
        return {"Test/Acc": correct / max(count, 1),
                "Test/Samples": count, "Test/Correct": correct}

    def train(self):
        out = None
        for _ in range(self.args.comm_round):
            out = self.train_one_round()
        logging.info("fedgkt: %d rounds, last %s", self.round_idx, out)
        return out


__all__ = ["kl_divergence", "FedGKTAPI"]
