"""The federated round engine (counterpart of
``fedml_tpu/parallel/engine.py``; the packed-lane path only).

``LaneRunner(packed=True)`` runs a round's cohort as ``L`` packed lanes:
:func:`~fedml_tpu_torch.parallel.packing.pack_lanes` lays the clients'
step schedules end to end into LPT-balanced lanes, and every step trains
all lanes at once through the spec's lane-packed loss (lane axis folded
into channels). Per lane the semantics are those of one client at a
time: a fully masked step leaves params, BN stats and optimizer state
untouched; a client's last step flushes its weighted payload into an
fp32 accumulator and resets the lane to the global model. Updates are
made on fresh tensors each step (nothing is modified in place), so the
caller's global state is never written.

Random draws (augmentation) come from a ``torch.Generator`` seeded per
(client, local step) by :func:`fold_step_seeds`, the counterpart of the
reference's ``fold_step_keys``. Other runners (vmap lanes, waves, flat,
sharded) wait for ROADMAP A6/A15.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.core.trainer import TrainSpec
from fedml_tpu_torch.parallel.packing import pack_lanes

_LANE_KEYS = ("idx", "mask", "slot", "flush", "flush_n", "flush_steps")


@dataclasses.dataclass(frozen=True)
class ClientUpdateConfig:
    """Local-training hyperparameters (``--client_optimizer --lr --wd``):
    plain SGD, weight decay coupled into the gradient before momentum,
    fresh optimizer state every round."""
    optimizer: str = "sgd"
    lr: float = 0.03
    weight_decay: float = 0.0
    momentum: float = 0.0
    grad_clip: Optional[float] = None


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured dicts/tuples."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


class SGD:
    """``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))`` over
    dicts of tensors: ``g' = g + wd*p``, ``buf = g' + momentum*buf``,
    ``p <- p - lr*buf``. Optimizer state is ``{name: buf}`` (empty
    without momentum)."""

    def __init__(self, cfg: ClientUpdateConfig):
        self.lr, self.wd, self.momentum = (cfg.lr, cfg.weight_decay,
                                           cfg.momentum)

    def init(self, params):
        if not self.momentum:
            return {}
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, grads, opt_state, params):
        """Returns ``(new_params, new_opt_state)``; inputs untouched."""
        new_params, new_state = {}, {}
        for k, p in params.items():
            g = grads[k]
            if self.wd:
                g = g + self.wd * p
            if self.momentum:
                g = g + self.momentum * opt_state[k]
                new_state[k] = g
            new_params[k] = p + (-self.lr) * g
        return new_params, new_state


def make_optimizer(cfg: ClientUpdateConfig) -> SGD:
    if cfg.grad_clip:
        raise NotImplementedError(
            "grad_clip waits for ROADMAP A14 (fednas)")
    if cfg.optimizer != "sgd":
        raise NotImplementedError(
            f"client optimizer {cfg.optimizer!r} waits for ROADMAP A5 "
            "(only sgd is ported)")
    return SGD(cfg)


_U64 = np.uint64
_GOLDEN = _U64(0x9E3779B97F4A7C15)


def _splitmix64(z):
    with np.errstate(over="ignore"):
        z = np.asarray(z, _U64) + _GOLDEN
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        return z ^ (z >> _U64(31))


def fold_seed(seed, data):
    """Deterministic 63-bit seed from ``(seed, data)`` (elementwise over
    numpy arrays); the port's ``jax.random.fold_in``."""
    with np.errstate(over="ignore"):
        z = _splitmix64(seed) ^ _splitmix64(np.asarray(data, np.int64)
                                            .astype(_U64) + _U64(1))
    return (_splitmix64(z) >> _U64(1)).astype(np.int64)


def fold_step_seeds(client_seeds, slot, local_step):
    """Per-step generator seeds for packed lanes:
    ``seeds[k, i] = fold_seed(client_seeds[slot[k, i]], local_step[k, i])``
    -- one stream per (client, local step), whatever lane runs it."""
    client_seeds = np.asarray(client_seeds, np.int64)
    return fold_seed(client_seeds[np.asarray(slot)], local_step)


def _default_payload(local_state, global_state, aux):
    return local_state


def _default_server(global_state, avg_payload, server_state, rng):
    return avg_payload, server_state


def payload_dtype_template(payload_fn, global_state):
    """The payload's dtypes (accumulators run in fp32; the average is
    cast back through this template)."""
    aux = {"n": torch.zeros(()), "steps": torch.zeros((), dtype=torch.int32)}
    return _tree_map(lambda t: t.dtype,
                     payload_fn(global_state, global_state, aux))


def make_packed_lane_update(spec: TrainSpec, cfg: ClientUpdateConfig,
                            payload_fn):
    """All lanes advance in one packed program per step.

    Returns ``packed_update(global_state, data_x, data_y, n_max, rows,
    lanes, step_seeds, trip) -> (payload_sum [L, ...] fp32, weight [L],
    metrics [L])``: ``data_x/data_y`` are the device-resident stacks
    flattened on their first two axes, ``rows`` maps a cohort slot to a
    device row, ``lanes`` the ``pack_lanes`` arrays as device tensors
    ``[L, T, ...]`` and ``step_seeds [L, T]`` host int64 seeds.
    ``payload_fn`` takes lane-stacked local state and per-lane aux; the
    lane count comes from the arrays."""
    optimizer = make_optimizer(cfg)
    if spec.lane_loss_builder is None:
        raise ValueError(
            f"spec '{spec.name}' has no lane_loss_builder: the packed lane "
            "path (wave_mode=3) needs a model family with a lane-packed "
            "lowering (models/lane_packed.py)")

    def packed_update(global_state, data_x, data_y, n_max, rows, lanes,
                      step_seeds, trip):
        L = lanes["idx"].shape[0]
        lane_loss_fn = spec.lane_loss_builder(L)
        dev = data_x.device

        def select(pred, new, old):
            return _tree_map(lambda a, b: torch.where(
                pred.reshape((L,) + (1,) * (a.dim() - 1)), a, b), new, old)

        stack = lambda t: _tree_map(
            lambda a: a.unsqueeze(0).expand((L,) + a.shape).clone(), t)
        g_params = stack(global_state["params"])
        g_rest = stack({k: v for k, v in global_state.items()
                        if k != "params"})
        g_opt = optimizer.init(g_params)
        params, rest, opt = g_params, g_rest, g_opt
        pay = w = msum = None
        gens = ([torch.Generator(device=dev) for _ in range(L)]
                if spec.augment_fn is not None else None)

        for i in range(int(trip)):
            idx_b, mask_b = lanes["idx"][:, i], lanes["mask"][:, i]
            flat = rows[lanes["slot"][:, i]][:, None] * n_max + idx_b
            x, y = data_x[flat], data_y[flat]  # [L, B, ...]
            if spec.augment_fn is not None:
                B, H, W = x.shape[1], x.shape[2], x.shape[3]
                draws = [spec.augment_fn.draw(
                    B, H, W, gens[l].manual_seed(int(step_seeds[l, i])))
                    for l in range(L)]
                cat = {k: torch.cat([d[k] for d in draws]) for k in draws[0]}
                x = spec.augment_fn(x.reshape((L * B,) + x.shape[2:]),
                                    cat).reshape(x.shape)
            p_req = {k: v.detach().requires_grad_(True)
                     for k, v in params.items()}
            state = dict(rest)
            state["params"] = p_req
            loss, (new_state, metrics) = lane_loss_fn(
                state, {"x": x, "y": y, "mask": mask_b}, None, True)
            grads = dict(zip(p_req, torch.autograd.grad(
                loss, list(p_req.values()))))
            with torch.no_grad():
                new_params, new_opt = optimizer.update(grads, opt, params)
                new_rest = {k: _tree_map(torch.Tensor.detach, new_state[k])
                            for k in rest}
                valid = mask_b.sum(dim=1) > 0
                params, rest, opt = select(valid, (new_params, new_rest,
                                                   new_opt),
                                           (params, rest, opt))
                msum = (metrics if msum is None
                        else _tree_map(torch.add, msum, metrics))

                f = lanes["flush"][:, i]
                f_n = lanes["flush_n"][:, i]
                f_steps = lanes["flush_steps"][:, i]
                local_state = dict(rest)
                local_state["params"] = params
                payload = payload_fn(local_state, global_state,
                                     {"n": f_n, "steps": f_steps.int()})
                scale = f * f_n
                contrib = _tree_map(lambda p: scale.reshape(
                    (L,) + (1,) * (p.dim() - 1)) * p.float(), payload)
                pay = (contrib if pay is None
                       else _tree_map(torch.add, pay, contrib))
                w = scale if w is None else w + scale
                params, rest, opt = select(f > 0, (g_params, g_rest, g_opt),
                                           (params, rest, opt))
        return pay, w, msum

    return packed_update


class LaneRunner:
    """Packed-lane execution of one round (``packed=True``; the vmap lane
    path, ``packed=False``, waits for ROADMAP A6).

    ``run_round`` packs the cohort into ``n_lanes`` lanes, trains them
    for the max lane load of steps, and finishes with the weighted
    average ``sum_c n_c * payload_c / sum_c n_c`` and ``server_fn``."""

    def __init__(self, spec: TrainSpec, cfg: ClientUpdateConfig,
                 payload_fn=None, server_fn=None, n_lanes=8, packed=False):
        if not packed:
            raise NotImplementedError(
                "vmap lanes (wave_mode=2) wait for ROADMAP A6")
        self.payload_fn = payload_fn or _default_payload
        self.server_fn = server_fn or _default_server
        self.n_lanes = int(n_lanes or 8)
        self.packed = True
        self._update = make_packed_lane_update(spec, cfg, self.payload_fn)
        self._dtypes = None

    def run_round(self, global_state, server_state, device_data, ids, sched,
                  round_seed):
        """Cohort ``ids`` (rows of ``device_data``), the full
        ``pack_schedule`` output and the round's seed. Returns
        ``(new_global, new_server_state, {"aux", "metrics", "trip"})``."""
        dx, dy = device_data["x"], device_data["y"]
        dev = dx.device
        C = len(np.asarray(sched["n"]))
        lanes = pack_lanes(sched, self.n_lanes)
        trip = max(lanes.pop("trip"), 1)
        client_seeds = fold_seed(fold_seed(round_seed, 1), np.arange(C))
        step_seeds = fold_step_seeds(client_seeds, lanes["slot"],
                                     lanes["local_step"])
        lane_t = {k: torch.as_tensor(lanes[k], device=dev)
                  for k in _LANE_KEYS}
        lane_t["idx"] = lane_t["idx"].long()
        lane_t["slot"] = lane_t["slot"].long()
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        R, n_max = dx.shape[0], dx.shape[1]
        pay, w, msum = self._update(
            global_state, dx.reshape((R * n_max,) + dx.shape[2:]),
            dy.reshape((R * n_max,) + dy.shape[2:]), n_max, rows, lane_t,
            step_seeds, trip)
        if self._dtypes is None:
            self._dtypes = payload_dtype_template(self.payload_fn,
                                                  global_state)
        w_sum = torch.clamp(w.sum(), min=1e-12)
        avg = _tree_map(lambda s, d: (s.sum(dim=0) / w_sum).to(d), pay,
                        self._dtypes)
        new_global, new_server = self.server_fn(
            global_state, avg, server_state, int(fold_seed(round_seed, 2)))
        metrics = _tree_map(lambda m: m.sum(dim=0), msum)
        steps_pc = (np.asarray(sched["mask"]).sum(axis=2) > 0).sum(axis=1)
        aux = {"n": np.asarray(sched["n"], np.float32),
               "steps": steps_pc.astype(np.int64)}
        return new_global, new_server, {"aux": aux, "metrics": metrics,
                                        "trip": trip}


__all__ = ["ClientUpdateConfig", "SGD", "make_optimizer", "fold_seed",
           "fold_step_seeds", "make_packed_lane_update", "LaneRunner",
           "payload_dtype_template"]
