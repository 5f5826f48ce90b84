"""The federated round engine (counterpart of
``fedml_tpu/parallel/engine.py``): every single-device round path.

Each client update trains K clients at once over a leading client axis
(the spec's ``stacked_loss_fn``; :func:`_make_trip_loop_core`), where the
reference vmaps one client's update: a fully masked step leaves a
client's params, state and optimizer state untouched, and updates are
made on fresh tensors (nothing is modified in place), so the caller's
global state is never written. The runners:

- ``WaveRunner`` (``wave_mode=1``): size-sorted waves over
  device-resident shards, each running its own maximum of steps;
- :func:`make_indexed_sim_round` (``wave_mode=0``): the flat round, every
  client over the whole padded schedule, in chunks;
- ``LaneRunner`` (``wave_mode=2`` and ``3``): the cohort's step schedules
  laid end to end into LPT-balanced lanes (``pack_lanes``); a client's
  last step flushes its weighted payload and resets its lane. Vmap lanes
  train over a lane axis, packed lanes fold it into channels;
- :func:`make_sim_round`: the host-packed round over a ``pack_cohort``
  upload;
- ``BucketedStreamRunner``: a cohort of any size streamed in chunks
  sorted by step count, folded on the host in fp64, synchronously or
  through a buffered async aggregator that flushes server updates in the
  middle of the round.

Random draws (augmentation, dropout) come from ``torch.Generator``s
seeded per (client, local step): a client's seed is derived from its
cohort slot the same way in every runner (:func:`client_seeds_for`), so
the paths agree to float reassociation. The bucketed runner streams
error feedback under a compressor (``compression/``).

Sharded rounds run over a ``clients`` mesh (``parallel/mesh.py``), one
process a device: :func:`make_sharded_round` (the host-packed round,
each rank training its block of the cohort) and ``ShardedLaneRunner``
(each rank's resident rows as lanes). A client's seed comes from its
global cohort slot, as on one device, and each rank's weighted payload
sum meets the others' in one fp32 ``all_reduce`` with the weight total;
the server step then runs replicated on every rank.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.compression.compressors import ErrorFeedback
from fedml_tpu_torch.compression.integration import ef_reconstruct
from fedml_tpu_torch.core.trainer import TrainSpec
from fedml_tpu_torch.observability.costmodel import (FLOPS_SOURCE,
                                                     get_cost_model,
                                                     train_step_flops)
from fedml_tpu_torch.observability.tracing import get_tracer
from fedml_tpu_torch.parallel.mesh import CLIENT_AXIS
from fedml_tpu_torch.parallel.multihost import (Sharded, all_reduce_sum,
                                                global_cohort)
from fedml_tpu_torch.parallel.packing import (_steps_for, bucket_edge_for,
                                              gather_batches, pack_lanes,
                                              pack_schedule, zero_pad_leading)

_LANE_KEYS = ("idx", "mask", "slot", "flush", "flush_n", "flush_steps")


@dataclasses.dataclass(frozen=True)
class ClientUpdateConfig:
    """Local-training hyperparameters (``--client_optimizer --lr --wd``):
    plain SGD or AMSGrad (``"adam"``), weight decay coupled into the
    gradient first, fresh optimizer state every round."""
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


def _neg_lr(lr, count):
    """``-lr``, or ``-lr(count)`` on ``count``'s device for a schedule
    (read before the count is incremented, as optax's
    ``scale_by_schedule`` reads it)."""
    return -lr(count).to(count.device) if callable(lr) else -lr


def _per_client(step, p):
    """A step size of one a stacked client, broadcast over ``p``'s
    trailing axes (a float passes through)."""
    if isinstance(step, torch.Tensor):
        return step.reshape(step.shape + (1,) * (p.dim() - step.dim()))
    return step


class SGD:
    """``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))`` over
    dicts of tensors: ``g' = g + wd*p``, ``buf = g' + momentum*buf``,
    ``p <- p - lr*buf``. Optimizer state is ``{name: buf}`` (empty
    without momentum). A callable ``lr`` (a schedule,
    ``utils/schedules.py``) adds a step ``"count"`` of ``count_shape``
    (one a client when K clients are stacked), read by the schedule
    before it is incremented and 0 at each ``init``, as optax's
    ``scale_by_schedule`` counts."""

    def __init__(self, cfg: ClientUpdateConfig):
        self.lr, self.wd, self.momentum = (cfg.lr, cfg.weight_decay,
                                           cfg.momentum)

    def init(self, params, count_shape=()):
        """Fresh state; ``count_shape`` shapes the schedule's count."""
        state = {}
        if self.momentum:
            state = {k: torch.zeros_like(v) for k, v in params.items()}
        if callable(self.lr):
            dev = next(iter(params.values())).device
            state["count"] = torch.zeros(count_shape, dtype=torch.int32,
                                         device=dev)
        return state

    def update(self, grads, opt_state, params):
        """Returns ``(new_params, new_opt_state)``; inputs untouched."""
        new_params, new_state = {}, {}
        if callable(self.lr):
            new_state["count"] = opt_state["count"] + 1
        neg_lr = _neg_lr(self.lr, opt_state.get("count"))
        for k, p in params.items():
            g = grads[k]
            if self.wd:
                g = g + self.wd * p
            if self.momentum:
                g = g + self.momentum * opt_state[k]
                new_state[k] = g
            new_params[k] = p + _per_client(neg_lr, p) * g
        return new_params, new_state


class ClipByGlobalNorm:
    """``optax.chain(clip_by_global_norm(max_norm), <inner>)``: each
    client's gradient scaled by ``max_norm / norm`` where its global norm
    (over all of its leaves) reaches ``max_norm``, before the inner
    optimizer's weight decay. With K clients stacked on a leading axis
    (``init(params, count_shape=(K,))``) each client's norm is its own;
    the state keeps a ``"lead"`` tensor of ``count_shape`` that says so."""

    def __init__(self, max_norm, inner):
        self.max_norm, self.inner = float(max_norm), inner

    def init(self, params, count_shape=()):
        dev = next(iter(params.values())).device
        return {"lead": torch.zeros(count_shape, device=dev),
                "inner": self.inner.init(params, count_shape)}

    def clip(self, grads, lead):
        """``grads`` clipped by each client's global norm; ``lead`` is
        the number of leading client axes."""
        sq = None
        for g in grads.values():
            s = (g.float() * g.float()).sum(
                dim=tuple(range(lead, g.dim()))) if g.dim() > lead else (
                g.float() * g.float())
            sq = s if sq is None else sq + s
        norm = torch.sqrt(sq)
        out = {}
        for k, g in grads.items():
            n = norm.reshape(norm.shape + (1,) * (g.dim() - norm.dim()))
            out[k] = torch.where(n < self.max_norm, g,
                                 (g / n.to(g.dtype)) * self.max_norm)
        return out

    def update(self, grads, opt_state, params):
        grads = self.clip(grads, opt_state["lead"].dim())
        new_params, inner = self.inner.update(grads, opt_state["inner"],
                                              params)
        return new_params, {"lead": opt_state["lead"], "inner": inner}


class AMSGrad:
    """``optax.chain(add_decayed_weights(wd), amsgrad(lr))`` over dicts of
    tensors (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): ``g' = g + wd*p``,
    ``mu = (1-b1) g' + b1 mu``, ``nu = (1-b2) g'^2 + b2 nu``, bias
    corrections ``1 - b^count``, ``nu_max = max(nu_max, nu_hat)`` of the
    CORRECTED second moment, ``p <- p - lr * mu_hat / (sqrt(nu_max) +
    eps)``. (``torch.optim.Adam(amsgrad=True)`` takes the maximum of the
    raw moment and corrects afterwards: a different optimizer from step 2
    on.) The count is per client: ``init(params, count_shape=(K,))`` for
    K stacked clients, whose bias corrections broadcast over each leaf's
    trailing axes. A callable ``lr`` (a schedule) reads the count before
    its increment, as ``optax.amsgrad(schedule)`` does."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: ClientUpdateConfig):
        self.lr, self.wd = cfg.lr, cfg.weight_decay

    def init(self, params, count_shape=()):
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return {"count": torch.zeros(count_shape, dtype=torch.int32,
                                     device=dev),
                "mu": zeros(), "nu": zeros(), "nu_max": zeros()}

    def update(self, grads, opt_state, params):
        """Returns ``(new_params, new_opt_state)``; inputs untouched."""
        b1, b2 = self.b1, self.b2
        neg_lr = _neg_lr(self.lr, opt_state["count"])
        count = opt_state["count"] + 1
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        new_params, mu, nu, nu_max = {}, {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            if self.wd:
                g = g + self.wd * p
            lead = bc1.shape + (1,) * (p.dim() - bc1.dim())
            mu[k] = (1 - b1) * g + b1 * opt_state["mu"][k]
            nu[k] = (1 - b2) * (g * g) + b2 * opt_state["nu"][k]
            nu_max[k] = torch.maximum(opt_state["nu_max"][k],
                                      nu[k] / bc2.reshape(lead))
            u = (mu[k] / bc1.reshape(lead)) / (torch.sqrt(nu_max[k])
                                               + self.eps)
            new_params[k] = p + _per_client(neg_lr, p) * u
        return new_params, {"count": count, "mu": mu, "nu": nu,
                            "nu_max": nu_max}


def make_optimizer(cfg: ClientUpdateConfig):
    """The local optimizer of ``cfg``: SGD or AMSGrad, behind the global
    norm clip when ``grad_clip`` is set (the reference's chain order)."""
    if cfg.optimizer == "sgd":
        opt = SGD(cfg)
    elif cfg.optimizer == "adam":
        opt = AMSGrad(cfg)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    return ClipByGlobalNorm(cfg.grad_clip, opt) if cfg.grad_clip else opt


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


def _select(pred, new, old):
    """Per-client ``torch.where`` over same-structured trees whose leaves
    lead with the client axis of ``pred [K]``."""
    return _tree_map(lambda a, b: torch.where(
        pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b), new, old)


def _default_payload(local_state, global_state, aux):
    return local_state


def _default_server(global_state, avg_payload, server_state, rng):
    return avg_payload, server_state


def payload_dtype_template(payload_fn, global_state):
    """The payload's dtypes (accumulators run in fp32; the average is
    cast back through this template). The probe's aux lies on the global
    state's device, as the runners' aux does."""
    dev = next(iter(global_state["params"].values())).device
    aux = {"n": torch.zeros((), device=dev),
           "steps": torch.zeros((), dtype=torch.int32, device=dev)}
    return _tree_map(lambda t: t.dtype,
                     payload_fn(global_state, global_state, aux))


def client_seeds_for(round_seed, C):
    """The ``C`` client seeds of a round, by cohort slot:
    ``fold_seed(fold_seed(round_seed, 1), slot)``. Every runner derives
    them so, and a client's step ``i`` draws from ``fold_seed(client_seed,
    i)``, so waves, flat, lanes and the host-packed round see the same
    draws (the reference's ``split(fold_in(rng, 1), C)``)."""
    return fold_seed(fold_seed(round_seed, 1), np.arange(C))


def _stack(tree, K):
    """Every leaf repeated on a new leading axis of ``K``."""
    return _tree_map(lambda a: a.unsqueeze(0).expand((K,) + a.shape).clone(),
                     tree)


def _augment(spec, x, seeds):
    """``spec.augment_fn`` on ``x [K, B, H, W, C]``: client ``k``'s draws
    from a generator on ``x``'s device seeded with ``seeds[k]``."""
    K, B, H, W = x.shape[:4]
    gen = torch.Generator(device=x.device)
    draws = [spec.augment_fn.draw(B, H, W, gen.manual_seed(int(s)))
             for s in seeds]
    cat = {k: torch.cat([d[k] for d in draws]) for k in draws[0]}
    return spec.augment_fn(x.reshape((K * B,) + x.shape[2:]),
                           cat).reshape(x.shape)


def _step(optimizer, loss_fn, params, rest, opt, batch):
    """One optimizer step of K stacked clients (or lanes) through
    ``loss_fn(state, batch) -> (loss_sum, (new_state, metrics))``; a
    client whose batch is fully masked keeps its params, state and
    optimizer state. Returns ``(params, rest, opt, metrics)``, detached."""
    p_req = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    state = dict(rest)
    state["params"] = p_req
    loss, (new_state, metrics) = loss_fn(state, batch)
    grads = dict(zip(p_req, torch.autograd.grad(loss,
                                                list(p_req.values()))))
    with torch.no_grad():
        new_params, new_opt = optimizer.update(grads, opt, params)
        new_rest = {k: _tree_map(torch.Tensor.detach, new_state[k])
                    for k in rest}
        valid = batch["mask"].sum(dim=1) > 0
        params, rest, opt = _select(valid, (new_params, new_rest, new_opt),
                                    (params, rest, opt))
    return params, rest, opt, _tree_map(torch.Tensor.detach, metrics)


def _make_trip_loop_core(spec: TrainSpec, cfg: ClientUpdateConfig):
    """The training loop of K clients at once, shared by every client
    update: ``run(states, batch_at, trip, seeds_at=None) -> (params, rest,
    metrics_sum)`` runs exactly ``trip`` steps of the spec's
    ``stacked_loss_fn`` from ``states``, whose leaves lead with the K
    clients (a broadcast global state, or one state a gossip node);
    ``batch_at(i)`` gives step ``i``'s ``{"x", "y", "mask"}`` (leading K)
    and ``seeds_at(i)`` the clients' host seeds for that step
    (augmentation and dropout draws).
    The steps make new tensors, so the caller's leaves stay as given."""
    optimizer = make_optimizer(cfg)
    if spec.stacked_loss_fn is None:
        raise ValueError(
            f"spec '{spec.name}' has no stacked_loss_fn: the client "
            "updates train K clients at once over a client axis "
            "(algorithms/specs.py)")

    def run(states, batch_at, trip, seeds_at=None):
        if int(trip) < 1:
            raise ValueError(f"trip={trip}: a client update runs at least "
                             "one step")
        params = dict(states["params"])
        rest = {k: v for k, v in states.items() if k != "params"}
        K = next(iter(params.values())).shape[0]
        opt = optimizer.init(params, (K,))
        msum = None
        for i in range(int(trip)):
            batch = batch_at(i)
            seeds = None if seeds_at is None else seeds_at(i)
            if spec.augment_fn is not None:
                if seeds is None:
                    raise ValueError("augmentation needs the clients' "
                                     "step seeds")
                batch = dict(batch)
                batch["x"] = _augment(spec, batch["x"], seeds)
            loss_fn = lambda st, b: spec.stacked_loss_fn(st, b, True,
                                                         seeds=seeds)
            params, rest, opt, metrics = _step(optimizer, loss_fn, params,
                                               rest, opt, batch)
            msum = (metrics if msum is None
                    else _tree_map(torch.add, msum, metrics))
        return params, rest, msum

    return run


def _local(params, rest):
    local_state = dict(rest)
    local_state["params"] = params
    return local_state


def make_node_update(spec: TrainSpec, cfg: ClientUpdateConfig):
    """Local training of K clients over their packed batches, each from
    its own state (the reference's vmap over node states in its gossip
    rounds).

    Returns ``fn(states, client_data, client_seeds) -> (local_states,
    aux, metrics_sum)``: every leaf of ``states`` leads with K;
    ``client_data`` is ``{"x": [K, S, B, ...], "y": [K, S, B, ...],
    "mask": [K, S, B], "n": [K]}``, all S steps run (fully masked ones
    leave a client untouched), and ``aux`` is ``{"n", "steps"}`` per
    client. Every leaf leads with K."""
    run = _make_trip_loop_core(spec, cfg)

    def node_update(states, client_data, client_seeds):
        S = client_data["mask"].shape[1]
        params, rest, msum = run(
            states,
            lambda i: {k: client_data[k][:, i] for k in ("x", "y", "mask")},
            S, lambda i: fold_seed(client_seeds, i))
        steps = (client_data["mask"] > 0).any(dim=-1).sum(dim=1)
        return _local(params, rest), {"n": client_data["n"],
                                      "steps": steps}, msum

    return node_update


def make_client_update(spec: TrainSpec, cfg: ClientUpdateConfig):
    """Local training of K clients over their packed batches (the
    host-packed round): :func:`make_node_update` with every client
    starting from ``global_state``.
    ``fn(global_state, client_data, client_seeds)``."""
    update = make_node_update(spec, cfg)

    def client_update(global_state, client_data, client_seeds):
        return update(_stack(global_state, client_data["mask"].shape[0]),
                      client_data, client_seeds)

    return client_update


def make_loop_client_update(spec: TrainSpec, cfg: ClientUpdateConfig):
    """Local training of K clients over device-resident data for exactly
    ``steps`` steps (the wave unit).

    Returns ``fn(global_state, data, sched, steps, client_seeds) ->
    (local_states, aux, metrics_sum)``: ``data`` is the resident stacks
    flattened on their first two axes, ``{"x": [R * n_max, ...], "y",
    "n_max", "rows": [K] device rows}``; ``sched`` the clients' index
    schedule ``{"idx": [K, S, B], "mask": [K, S, B], "n": [K]}`` on the
    device. Each step gathers its batch on the device."""
    run = _make_trip_loop_core(spec, cfg)

    def client_update(global_state, data, sched, steps, client_seeds):
        K = sched["mask"].shape[0]
        base = data["rows"][:, None] * data["n_max"]

        def batch_at(i):
            flat = base + sched["idx"][:, i]
            return {"x": data["x"][flat], "y": data["y"][flat],
                    "mask": sched["mask"][:, i]}

        params, rest, msum = run(_stack(global_state, K), batch_at, steps,
                                 lambda i: fold_seed(client_seeds, i))
        stepped = (sched["mask"] > 0).any(dim=-1).sum(dim=1)
        return _local(params, rest), {"n": sched["n"],
                                      "steps": stepped}, msum

    return client_update


def make_indexed_client_update(spec: TrainSpec, cfg: ClientUpdateConfig):
    """:func:`make_loop_client_update` over the whole schedule: all S
    steps run (the flat round's fixed-length client update).
    ``fn(global_state, data, sched, client_seeds)``."""
    loop = make_loop_client_update(spec, cfg)

    def client_update(global_state, data, sched, client_seeds):
        return loop(global_state, data, sched, sched["mask"].shape[1],
                    client_seeds)

    return client_update


def _weighted_sum(payloads, w):
    """``sum_k w[k] * payload[k]`` in fp32 over the leading axis."""
    return _tree_map(lambda x: torch.tensordot(w, x.float(),
                                               dims=([0], [0])), payloads)


def _flat_data(device_data):
    """Resident stacks ``[R, n_max, ...]`` flattened to ``[R * n_max,
    ...]``, as the loop update reads them."""
    dx, dy = device_data["x"], device_data["y"]
    R, n_max = dx.shape[0], dx.shape[1]
    return {"x": dx.reshape((R * n_max,) + dx.shape[2:]),
            "y": dy.reshape((R * n_max,) + dy.shape[2:]), "n_max": n_max}


def _sched_tensors(sched, dev):
    return {"idx": torch.as_tensor(np.asarray(sched["idx"]),
                                   device=dev).long(),
            "mask": torch.as_tensor(np.asarray(sched["mask"]), device=dev),
            "n": torch.as_tensor(np.asarray(sched["n"], np.float32),
                                 device=dev)}


def _mean_payload(pay_sum, plain_sum, w_sum, count, dtypes):
    """The weighted mean ``pay_sum / w_sum`` cast to the payload's dtypes;
    with no weight at all (every client empty) the plain mean, as the
    reference's ``tree_weighted_mean`` falls back."""
    if float(w_sum) > 0:
        return _tree_map(lambda s, d: (s / w_sum).to(d), pay_sum, dtypes)
    return _tree_map(lambda s, d: (s / count).to(d), plain_sum, dtypes)


class WaveRunner:
    """Size-sorted waves over device-resident data (``wave_mode=1``).

    The cohort is sorted by true step count (descending, stable) and
    trained ``client_chunk`` clients at a time; each wave runs exactly its
    own maximum of steps, so steps past it never run. A ragged last wave
    trains only its real clients. Weighted payload sums accumulate in fp32
    on the device; one ``server-update`` divides and applies
    ``server_fn``. Consumes the same ``pack_schedule`` draw as every other
    runner, with the same per-slot seeds, so waves, flat and lanes agree
    to float reassociation."""

    def __init__(self, spec: TrainSpec, cfg: ClientUpdateConfig,
                 payload_fn=None, server_fn=None, client_chunk=8):
        self.payload_fn = payload_fn or _default_payload
        self.server_fn = server_fn or _default_server
        self.client_chunk = int(client_chunk or 8)
        self._update = make_loop_client_update(spec, cfg)
        self._dtypes = None

    def run_round(self, global_state, server_state, device_data, ids, sched,
                  round_seed):
        """One round: ``device_data`` the resident ``{"x": [R, n_max,
        ...], "y"}``, ``ids`` the cohort's rows (cohort order), ``sched``
        the full ``pack_schedule`` output (numpy, cohort order) and the
        round's seed. Returns ``(new_global, new_server_state, {"aux",
        "metrics", "trip"})``; ``trip`` is the waves' steps summed."""
        mask = np.asarray(sched["mask"])
        C = mask.shape[0]
        steps_pc = (mask.sum(axis=2) > 0).sum(axis=1).astype(np.int64)
        order = np.argsort(-steps_pc, kind="stable")
        chunk = min(self.client_chunk, C)
        seeds = client_seeds_for(round_seed, C)
        dev = device_data["x"].device
        data = _flat_data(device_data)
        ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        sched_t = _sched_tensors(sched, dev)
        if self._dtypes is None:
            self._dtypes = payload_dtype_template(self.payload_fn,
                                                  global_state)
        acc, trips = None, 0
        for w0 in range(0, C, chunk):
            pos = order[w0:w0 + chunk]
            k, trip = len(pos), int(steps_pc[pos].max())
            pos_t = torch.as_tensor(pos, device=dev)
            ws = {key: v[pos_t] for key, v in sched_t.items()}
            # the span measures the enqueue: the device work lands in the
            # caller's end-of-round synchronize
            with get_tracer().span("wave", clients=int(k), trip=trip):
                local, aux, msum = self._update(
                    global_state, dict(data, rows=ids_t[pos_t]), ws,
                    max(trip, 1), seeds[pos])
                with torch.no_grad():
                    payloads = self.payload_fn(local, global_state, aux)
                    w = aux["n"].float()
                    part = (_weighted_sum(payloads, w), w.sum(),
                            _tree_map(lambda m: m.sum(dim=0), msum))
            acc = part if acc is None else _tree_map(torch.add, acc, part)
            trips += max(trip, 1)
        pay_sum, w_sum, metrics = acc
        with get_tracer().span("server-update"):
            with torch.no_grad():
                avg = _tree_map(
                    lambda s, d: (s / torch.clamp(w_sum, min=1e-12)).to(d),
                    pay_sum, self._dtypes)
                new_global, new_server = self.server_fn(
                    global_state, avg, server_state,
                    int(fold_seed(round_seed, 2)))
        aux = {"n": np.asarray(sched["n"], np.float32), "steps": steps_pc}
        return new_global, new_server, {"aux": aux, "metrics": metrics,
                                        "trip": trips}


def _make_lane_update(spec, cfg, payload_fn, packed):
    """All lanes advance at once, each training its clients back to back:
    a fully masked step leaves a lane untouched; a client's last step
    flushes its weighted payload into an fp32 accumulator and resets the
    lane to the global model. ``packed`` trains through the spec's
    lane-packed loss (lane axis folded into channels), otherwise through
    its ``stacked_loss_fn`` over the lane axis.

    Returns ``update(global_state, data_x, data_y, n_max, rows, lanes,
    step_seeds, trip) -> (payload_sum [L, ...] fp32, weight [L], metrics
    [L])``: ``data_x/data_y`` are the resident stacks flattened on their
    first two axes, ``rows`` maps a cohort slot to a device row, ``lanes``
    the ``pack_lanes`` arrays as device tensors ``[L, T, ...]`` and
    ``step_seeds [L, T]`` host int64 seeds. ``payload_fn`` takes
    lane-stacked local state and per-lane aux; the lane count comes from
    the arrays."""
    optimizer = make_optimizer(cfg)
    if packed and spec.lane_loss_builder is None:
        raise ValueError(
            f"spec '{spec.name}' has no lane_loss_builder: the packed lane "
            "path (wave_mode=3) needs a model family with a lane-packed "
            "lowering (models/lane_packed.py); wave_mode=2 runs vmap lanes")
    if not packed and spec.stacked_loss_fn is None:
        raise ValueError(f"spec '{spec.name}' has no stacked_loss_fn: vmap "
                         "lanes train over a lane axis")

    def update(global_state, data_x, data_y, n_max, rows, lanes,
               step_seeds, trip):
        L = lanes["idx"].shape[0]
        if packed:
            lane_loss_fn = spec.lane_loss_builder(L)
            loss_for = lambda seeds: (
                lambda st, b: lane_loss_fn(st, b, None, True))
        else:
            loss_for = lambda seeds: (
                lambda st, b: spec.stacked_loss_fn(st, b, True, seeds=seeds))
        g_params = _stack(global_state["params"], L)
        g_rest = _stack({k: v for k, v in global_state.items()
                         if k != "params"}, L)
        g_opt = optimizer.init(g_params, (L,))
        params, rest, opt = g_params, g_rest, g_opt
        pay = w = msum = None

        for i in range(int(trip)):
            idx_b, mask_b = lanes["idx"][:, i], lanes["mask"][:, i]
            flat = rows[lanes["slot"][:, i]][:, None] * n_max + idx_b
            x, y = data_x[flat], data_y[flat]  # [L, B, ...]
            if spec.augment_fn is not None:
                x = _augment(spec, x, step_seeds[:, i])
            params, rest, opt, metrics = _step(
                optimizer, loss_for(step_seeds[:, i]), params, rest, opt,
                {"x": x, "y": y, "mask": mask_b})
            with torch.no_grad():
                msum = (metrics if msum is None
                        else _tree_map(torch.add, msum, metrics))
                f = lanes["flush"][:, i]
                f_n = lanes["flush_n"][:, i]
                f_steps = lanes["flush_steps"][:, i]
                payload = payload_fn(_local(params, rest), global_state,
                                     {"n": f_n, "steps": f_steps.int()})
                scale = f * f_n
                contrib = _tree_map(lambda p: scale.reshape(
                    (L,) + (1,) * (p.dim() - 1)) * p.float(), payload)
                pay = (contrib if pay is None
                       else _tree_map(torch.add, pay, contrib))
                w = scale if w is None else w + scale
                params, rest, opt = _select(f > 0, (g_params, g_rest, g_opt),
                                            (params, rest, opt))
        return pay, w, msum

    return update


def make_lane_update(spec: TrainSpec, cfg: ClientUpdateConfig, payload_fn):
    """vmap lanes (``wave_mode=2``): see :func:`_make_lane_update`; the
    lanes train through the spec's ``stacked_loss_fn``."""
    return _make_lane_update(spec, cfg, payload_fn, packed=False)


def make_packed_lane_update(spec: TrainSpec, cfg: ClientUpdateConfig,
                            payload_fn):
    """Packed lanes (``wave_mode=3``): see :func:`_make_lane_update`; the
    lanes train through the spec's lane-packed loss, lane axis folded
    into channels."""
    return _make_lane_update(spec, cfg, payload_fn, packed=True)


def make_streamed_client_update(spec: TrainSpec, cfg: ClientUpdateConfig):
    """Local training of K clients at once over pre-gathered batches with
    a dynamic trip count (the bucketed chunk).

    Returns ``fn(global_state, batches, n, trip, client_seeds) ->
    (local_states, aux, metrics_sum)``, every leaf leading with the
    client axis: ``batches`` is ``{"x": [K, S, B, ...], "y": [K, S, B,
    ...], "mask": [K, S, B]}`` padded to a bucket edge S, exactly
    ``trip`` steps run, ``client_seeds [K]`` are the clients' host seeds
    (client ``k`` draws its step ``i`` augmentation and dropout from
    ``fold_seed(client_seeds[k], i)``) and ``aux`` is ``{"n": n,
    "steps": [K]}``."""
    run = _make_trip_loop_core(spec, cfg)

    def client_update(global_state, batches, n, trip, client_seeds):
        K = batches["mask"].shape[0]
        params, rest, msum = run(
            _stack(global_state, K),
            lambda i: {k: batches[k][:, i] for k in ("x", "y", "mask")},
            trip, lambda i: fold_seed(client_seeds, i))
        steps_done = (batches["mask"] > 0).any(dim=-1).sum(dim=1)
        return _local(params, rest), {"n": n, "steps": steps_done}, msum

    return client_update


class BucketedStreamRunner:
    """Bucketed ragged streaming: one device, a cohort of any size.

    The cohort is sorted ASCENDING by local step count (stable argsort)
    and cut into chunks of ``client_chunk``. Each chunk's schedule pads to
    the smallest bucket edge covering it, while its trip is the chunk's
    true maximum, so steps past it never run. A ragged final chunk is
    padded with inert clients (``n`` = 0, fully masked; they reuse the
    chunk's first seed). Each chunk trains its clients at once and
    returns only its weighted payload sum (fp32, on the device). Up to
    ``async_window`` chunks stay in flight before their first host read.

    Synchronously the partials fold on the host in fp64 in chunk order
    and ``server_fn`` applies the average once. With a
    :class:`~fedml_tpu_torch.program.aggregation.BufferedAggregator`
    (FedBuff) each chunk folds at its first host read as a pre-weighted
    partial whose staleness is the server versions flushed since it was
    dispatched; every ``buffer_k`` buffered clients flush a server step
    in the middle of the round, chunks dispatched after it train from
    the new global state, and what is left drains at the round's end.
    With ``buffer_k`` the cohort and decay 0 the async round is the
    synchronous one bit for bit.

    Streaming error feedback (``compressor=``): the chunk additionally
    runs the client->server half of the wire for each lane -- compress
    its params delta plus its residual, reconstruct the server's view and
    aggregate the reconstructed states
    (:func:`~fedml_tpu_torch.compression.integration.ef_reconstruct`).
    Residual rows are gathered by stable client id from a
    ``ResidualStore`` at dispatch and written back at the chunk's fold
    point; padded lanes carry zero rows whose updates are dropped.

    With a cost model armed (``observability.costmodel``), one client's
    local step is counted once (``train_step_flops``; its FLOPs do not
    depend on the bucket edge) and the round info carries per-bucket and
    FLOP-weighted waste accounting, as the reference's does."""

    def __init__(self, spec: TrainSpec, cfg: ClientUpdateConfig,
                 payload_fn=None, server_fn=None, client_chunk=256,
                 batch_size=32, epochs=1, edges=(8,), compressor=None):
        self.compressor = compressor
        self._ef = None if compressor is None else ErrorFeedback(compressor)
        self.payload_fn = payload_fn or _default_payload
        self.server_fn = server_fn or _default_server
        self.client_chunk = max(1, int(client_chunk))
        self.batch_size = int(batch_size)
        self.epochs = int(epochs)
        self.edges = sorted(int(e) for e in edges)
        self.spec, self.cfg = spec, cfg
        self._update = make_streamed_client_update(spec, cfg)
        self._dtypes = None
        self._step_flops = None  # FLOPs of one client's local step

    def step_flops(self, batches):
        """FLOPs of one client's local step at the chunk's batch shape,
        counted once per runner (``train_step_flops`` on the CPU)."""
        if self._step_flops is None:
            self._step_flops = train_step_flops(
                self.spec, self.cfg,
                {k: (tuple(v.shape[2:]), v.dtype) for k, v in batches.items()})
        return self._step_flops

    def _chunk(self, global_state, batches, ns, trip, seeds, residuals=None,
               comp_seeds=None):
        """One chunk's weighted payload sum, weight and metrics (and,
        under a compressor, the lanes' new residuals), on the device."""
        local_states, aux, metrics = self._update(global_state, batches, ns,
                                                  trip, seeds)
        with torch.no_grad():
            new_res = None
            if self._ef is not None:
                with get_tracer().span("ef-compress",
                                       clients=len(comp_seeds)):
                    local_states, new_res = ef_reconstruct(
                        self._ef, local_states, global_state, residuals,
                        comp_seeds)
            payloads = self.payload_fn(local_states, global_state, aux)
            w = aux["n"].float()
            pay_sum = _tree_map(lambda x: torch.tensordot(
                w, x.float(), dims=([0], [0])), payloads)
            return (pay_sum, w.sum(),
                    _tree_map(lambda m: m.sum(dim=0), metrics), new_res)

    def run_round(self, global_state, server_state, datasets, round_seed,
                  data_rng=None, aggregator=None, async_window=4,
                  client_ids=None, residual_store=None):
        """One round over ``datasets`` (the cohort's raw client shards,
        ``{"x", "y"}`` each), streamed chunk by chunk; ``aggregator`` (a
        ``BufferedAggregator``) switches the fold to buffered async, and
        ``async_window`` is the chunks in flight. Under a compressor,
        ``residual_store`` (a ``ResidualStore``, required) carries each
        client's residual across rounds keyed by ``client_ids`` (stable
        ids aligned with ``datasets``; cohort ordinals by default), and
        the compression seeds are ``client_seeds_for(fold_seed(round_seed,
        3), C)`` by cohort slot. Returns
        ``(new_global, new_server_state, info)`` with ``info["bucket"]``
        (the reference's waste accounting), ``info["aux"]``, the
        fp64-summed ``info["metrics"]`` and, async, ``info["async"]``
        (the aggregator's counters and ``async/flushes_this_round``).
        Flush ``f`` of a round steps the server with the seed
        ``fold_seed(fold_seed(round_seed, 2), f)``; the synchronous
        round's one step takes ``fold_seed(round_seed, 2)``, as every
        other runner's does."""
        data_rng = data_rng or np.random.default_rng(0)
        C = len(datasets)
        if C == 0:
            raise ValueError("bucketed round over an empty cohort")
        if self.compressor is not None and residual_store is None:
            raise ValueError(
                "streaming-EF needs a residual_store: the error-feedback "
                "accumulator is keyed by stable client id across rounds "
                "(compression.ResidualStore; FedAvgAPI owns one)")
        ns = [len(d["y"]) for d in datasets]
        if sum(ns) == 0:
            raise ValueError("bucketed round: every client shard is empty")
        if self.batch_size in (-1, 0):
            self.batch_size = max(1, max(ns))
        bs = self.batch_size
        steps_pc = np.asarray(
            [_steps_for(max(n, 1), bs, self.epochs) for n in ns], np.int64)
        bucket_edge_for(steps_pc.max(), self.edges)  # top-edge guard
        if self._dtypes is None:
            self._dtypes = payload_dtype_template(self.payload_fn,
                                                  global_state)
        dev = next(iter(global_state["params"].values())).device
        seeds = client_seeds_for(round_seed, C)
        flush_seed = fold_seed(round_seed, 2)
        comp_seeds = None
        if self.compressor is not None:
            comp_seeds = client_seeds_for(fold_seed(round_seed, 3), C)
            if client_ids is None:
                client_ids = list(range(C))
        gs, ss = global_state, server_state
        num, w_total, metrics_acc = None, 0.0, None
        flushes = 0
        inflight = deque()
        tracer = get_tracer()
        cm = get_cost_model()  # one global read when attribution is off

        def to_device(avg):
            return _tree_map(lambda x, d: torch.as_tensor(
                np.asarray(x, np.float32), device=dev).to(d), avg,
                self._dtypes)

        def fold_oldest():
            # the first host read of a chunk's outputs: the sync point
            nonlocal num, w_total, metrics_acc, gs, ss, flushes
            ordinal, born, k_real, ids, (pay, w, msum, new_res) = (
                inflight.popleft())
            if ids is not None:
                # the residuals' write-back at the fold point (the dense
                # store's is device work; padded lanes are dropped)
                residual_store.scatter(
                    ids, _tree_map(lambda x: x[:len(ids)], new_res))
            pay = _tree_map(lambda x: x.cpu().numpy(), pay)
            w = float(w)
            m_host = _tree_map(lambda m: np.float64(m.item()), msum)
            metrics_acc = (m_host if metrics_acc is None
                           else _tree_map(np.add, metrics_acc, m_host))
            if aggregator is None:
                contrib = _tree_map(lambda x: x.astype(np.float64), pay)
                num = (contrib if num is None
                       else _tree_map(np.add, num, contrib))
                w_total += w
                return
            aggregator.fold(ordinal, w, pay,
                            staleness=aggregator.version - born,
                            clients=k_real, preweighted=True)
            if aggregator.ready():
                res = aggregator.flush("buffer_k")
                gs, ss = self.server_fn(gs, to_device(res.params), ss,
                                        int(fold_seed(flush_seed, flushes)))
                flushes += 1

        order = np.argsort(steps_pc, kind="stable")
        b_stats = {e: {"clients": 0, "chunks": 0, "executed_steps": 0,
                       "true_steps": 0} for e in self.edges}
        chunks = exec_steps = 0
        for c0 in range(0, C, self.client_chunk):
            chunk = [int(i) for i in order[c0:c0 + self.client_chunk]]
            k = len(chunk)
            trip = int(steps_pc[chunk].max())
            edge = int(bucket_edge_for(trip, self.edges))
            sched = pack_schedule([ns[i] for i in chunk], bs, self.epochs,
                                  rng=data_rng, s_max=edge)
            xb, yb = gather_batches(datasets, sched, chunk)
            maskb, n_arr = sched["mask"], sched["n"]
            pad = self.client_chunk - k
            xb, yb, maskb, n_arr = zero_pad_leading(
                (xb, yb, maskb, n_arr), pad)
            # client i of the sorted chunk draws from its cohort slot's
            # seed; padded clients reuse the first
            chunk_seeds = np.concatenate([seeds[chunk],
                                          np.repeat(seeds[chunk[:1]], pad)])
            batches = {"x": torch.as_tensor(xb, device=dev),
                       "y": torch.as_tensor(yb, device=dev),
                       "mask": torch.as_tensor(maskb, device=dev)}
            n_dev = torch.as_tensor(n_arr, device=dev)
            born = aggregator.version if aggregator is not None else 0
            ids = res = c_seeds = None
            if self.compressor is not None:
                # residual rows by stable client id; padded lanes carry
                # zero rows and the first lane's compression seed
                ids = [client_ids[i] for i in chunk]
                res = _tree_map(lambda x: torch.cat(
                    [x, x.new_zeros((pad,) + x.shape[1:])]),
                    residual_store.gather(ids))
                c_seeds = np.concatenate([comp_seeds[chunk],
                                          np.repeat(comp_seeds[chunk[:1]],
                                                    pad)])
            with tracer.span("bucket-chunk", edge=edge, clients=int(k),
                             trip=trip):
                inflight.append((chunks, born, k, ids,
                                 self._chunk(gs, batches, n_dev, trip,
                                             chunk_seeds, res, c_seeds)))
            if cm is not None:
                # one step of the chunk across its lanes, as the
                # reference's cost analysis charges a loop body once
                cm.note(f"bucket_chunk_s{edge}",
                        self.step_flops(batches) * self.client_chunk)
            chunks += 1
            st = b_stats[edge]
            st["clients"] += k
            st["chunks"] += 1
            # the padded clients of a ragged final chunk run too
            st["executed_steps"] += trip * self.client_chunk
            st["true_steps"] += int(steps_pc[chunk].sum())
            exec_steps += trip * self.client_chunk
            while len(inflight) > max(1, int(async_window)):
                fold_oldest()
        while inflight:
            fold_oldest()
        async_info = None
        if aggregator is not None:
            if aggregator.depth:
                # the round's end drains whatever is buffered, even below
                # buffer_k (held across rounds it would starve the last
                # window)
                res = aggregator.flush("drain")
                gs, ss = self.server_fn(gs, to_device(res.params), ss,
                                        int(fold_seed(flush_seed, flushes)))
                flushes += 1
            async_info = aggregator.record()
            async_info["async/flushes_this_round"] = flushes
        else:
            if num is None or w_total <= 0:
                raise ValueError("bucketed round folded zero weight (every "
                                 "cohort shard empty?)")
            gs, ss = self.server_fn(
                gs, to_device(_tree_map(lambda x: x / w_total, num)), ss,
                int(flush_seed))
        per_bucket = []
        flops_exec = flops_true = 0.0
        for e in self.edges:
            st = b_stats[e]
            row = {"edge": int(e), "skipped": int(st["chunks"] == 0), **st}
            if cm is not None and st["chunks"]:
                step = self._step_flops
                row["flops_per_step"] = step
                row["executed_flops"] = step * st["executed_steps"]
                row["true_flops"] = step * st["true_steps"]
                flops_exec += row["executed_flops"]
                flops_true += row["true_flops"]
            per_bucket.append(row)
        true_steps = int(steps_pc.sum())
        info = {
            "aux": {"n": np.asarray(ns, np.float32),
                    "steps": steps_pc.astype(np.int64)},
            "metrics": metrics_acc,
            "bucket": {
                "edges": list(self.edges),
                "buckets_used": sum(1 for b in per_bucket
                                    if not b["skipped"]),
                "clients": C, "chunks": chunks,
                "executed_steps": int(exec_steps),
                "true_steps": true_steps,
                "waste_frac": round(1.0 - true_steps / max(exec_steps, 1),
                                    4),
                "per_bucket": per_bucket,
            },
        }
        if flops_exec > 0:
            # padded waste in FLOPs
            info["bucket"].update({
                "executed_flops": flops_exec, "true_flops": flops_true,
                "flops_waste_frac": round(1.0 - flops_true / flops_exec, 4),
                "flops_source": FLOPS_SOURCE})
        if async_info is not None:
            info["async"] = async_info
        return gs, ss, info


class LaneRunner:
    """Lane execution of one round: ``packed=True`` folds the lane axis
    into channels (``wave_mode=3``), ``packed=False`` trains the lanes
    over a lane axis through the spec's ``stacked_loss_fn`` (vmap lanes,
    ``wave_mode=2``).

    ``run_round`` packs the cohort into ``n_lanes`` LPT-balanced lanes,
    trains them for the max lane load of steps, and finishes with the
    weighted average ``sum_c n_c * payload_c / sum_c n_c`` and
    ``server_fn``."""

    def __init__(self, spec: TrainSpec, cfg: ClientUpdateConfig,
                 payload_fn=None, server_fn=None, n_lanes=8, packed=False):
        self.payload_fn = payload_fn or _default_payload
        self.server_fn = server_fn or _default_server
        self.n_lanes = int(n_lanes or 8)
        self.packed = bool(packed)
        self._update = _make_lane_update(spec, cfg, self.payload_fn,
                                         self.packed)
        self._dtypes = None

    def _lanes(self, sched, seeds, dev):
        """``sched`` packed into lanes on ``dev``, with each step's seed
        from its client's entry of ``seeds``: ``(lanes, step_seeds,
        trip)``, the trip at least one step."""
        lanes = pack_lanes(sched, self.n_lanes)
        trip = max(lanes.pop("trip"), 1)
        step_seeds = fold_step_seeds(seeds, lanes["slot"],
                                     lanes["local_step"])
        lane_t = {k: torch.as_tensor(lanes[k], device=dev)
                  for k in _LANE_KEYS}
        lane_t["idx"] = lane_t["idx"].long()
        lane_t["slot"] = lane_t["slot"].long()
        return lane_t, step_seeds, trip

    def _dtypes_for(self, global_state):
        if self._dtypes is None:
            self._dtypes = payload_dtype_template(self.payload_fn,
                                                  global_state)
        return self._dtypes

    def run_round(self, global_state, server_state, device_data, ids, sched,
                  round_seed):
        """Cohort ``ids`` (rows of ``device_data``), the full
        ``pack_schedule`` output and the round's seed. Returns
        ``(new_global, new_server_state, {"aux", "metrics", "trip"})``."""
        dev = device_data["x"].device
        C = len(np.asarray(sched["n"]))
        lane_t, step_seeds, trip = self._lanes(
            sched, client_seeds_for(round_seed, C), dev)
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        data = _flat_data(device_data)
        dtypes = self._dtypes_for(global_state)
        # the reference's one jitted round program: the trip, the
        # weighted average and the server step
        with get_tracer().span("lanes", clients=int(C),
                               n_lanes=int(self.n_lanes), trip=int(trip)):
            pay, w, msum = self._update(
                global_state, data["x"], data["y"], data["n_max"], rows,
                lane_t, step_seeds, trip)
            with torch.no_grad():
                w_sum = torch.clamp(w.sum(), min=1e-12)
                avg = _tree_map(lambda s, d: (s.sum(dim=0) / w_sum).to(d),
                                pay, dtypes)
                new_global, new_server = self.server_fn(
                    global_state, avg, server_state,
                    int(fold_seed(round_seed, 2)))
                metrics = _tree_map(lambda m: m.sum(dim=0), msum)
        return new_global, new_server, {"aux": _cohort_aux(sched),
                                        "metrics": metrics, "trip": trip}


def _cohort_aux(sched):
    """The cohort's per-client ``n`` and true step counts (host)."""
    steps_pc = (np.asarray(sched["mask"]).sum(axis=2) > 0).sum(axis=1)
    return {"n": np.asarray(sched["n"], np.float32),
            "steps": steps_pc.astype(np.int64)}


class ShardedLaneRunner(LaneRunner):
    """Lanes over a ``clients`` mesh: the resident client rows are
    sharded in contiguous blocks over the mesh's client axis
    (``device_data`` is this rank's :class:`Sharded` block), each rank
    trains the cohort members it owns as LPT-packed lanes (vmap lanes, or
    ``packed=True`` folding the lane axis into channels), and the ranks'
    weighted payload sums, weight totals and metric sums meet in one
    fp32 ``all_reduce``; the server step runs replicated.

    Each rank runs its own lane load: there is no common trip, a rank
    with no member of the cohort runs one fully masked step (its sums are
    zeros), and every rank enters the collective once a round. A
    client's step seeds come from its global cohort slot, so the round
    equals the flat round on one device to float reassociation."""

    def __init__(self, spec: TrainSpec, cfg: ClientUpdateConfig, mesh,
                 payload_fn=None, server_fn=None, n_lanes=8, packed=False):
        super().__init__(spec, cfg, payload_fn, server_fn, n_lanes=n_lanes,
                         packed=packed)
        self.mesh = mesh

    def run_round(self, global_state, server_state, device_data, ids, sched,
                  round_seed):
        """``device_data`` is this rank's :class:`Sharded` block of the
        resident stacks and ``ids`` the cohort's global rows; otherwise
        the contract of :meth:`LaneRunner.run_round`. ``trip`` is this
        rank's executed lane steps."""
        local = device_data.local
        dev = local["x"].device
        block = local["x"].shape[0]
        lo = device_data.start
        ids = np.asarray(ids, np.int64)
        C = len(ids)
        members = np.nonzero((ids >= lo) & (ids < lo + block))[0]
        seeds = client_seeds_for(round_seed, C)
        if len(members):
            sub = {k: np.asarray(sched[k])[members]
                   for k in ("idx", "mask", "n")}
            rows = ids[members] - lo
        else:
            # one inert client: a fully masked step, zero sums
            mask = np.asarray(sched["mask"])
            sub = {"idx": np.zeros((1,) + mask.shape[1:], np.int32),
                   "mask": np.zeros((1,) + mask.shape[1:], np.float32),
                   "n": np.zeros((1,), np.float32)}
            members, rows = np.zeros(1, np.int64), np.zeros(1, np.int64)
        lane_t, step_seeds, trip = self._lanes(sub, seeds[members], dev)
        data = _flat_data(local)
        dtypes = self._dtypes_for(global_state)
        with get_tracer().span("sharded-lanes", clients=int(C),
                               shards=int(self.mesh.shape[CLIENT_AXIS]),
                               trip=int(trip)):
            pay, w, msum = self._update(
                global_state, data["x"], data["y"], data["n_max"],
                torch.as_tensor(rows, device=dev), lane_t, step_seeds, trip)
            with torch.no_grad():
                w_sum, pay_sum, metrics = all_reduce_sum(
                    (w.sum(), _tree_map(lambda p: p.sum(dim=0), pay),
                     _tree_map(lambda m: m.sum(dim=0), msum)),
                    self.mesh.group(CLIENT_AXIS))
                w_sum = torch.clamp(w_sum, min=1e-12)
                avg = _tree_map(lambda s, d: (s / w_sum).to(d), pay_sum,
                                dtypes)
                new_global, new_server = self.server_fn(
                    global_state, avg, server_state,
                    int(fold_seed(round_seed, 2)))
        return new_global, new_server, {"aux": _cohort_aux(sched),
                                        "metrics": metrics, "trip": trip}


def _finish_round(payload_fn, server_fn, global_state, server_state, parts,
                  count, round_seed):
    """Weighted mean of the accumulated ``(pay_sum, plain_sum, w_sum)``
    parts and the server step."""
    pay_sum, plain_sum, w_sum = parts
    dtypes = payload_dtype_template(payload_fn, global_state)
    avg = _mean_payload(pay_sum, plain_sum, w_sum, count, dtypes)
    return server_fn(global_state, avg, server_state,
                     int(fold_seed(round_seed, 2)))


def make_indexed_sim_round(spec: TrainSpec, cfg: ClientUpdateConfig,
                           payload_fn=None, server_fn=None,
                           client_chunk=None):
    """The flat round over device-resident data (``wave_mode=0``):
    ``round_fn(global_state, server_state, device_data, sched,
    round_seed)`` with ``device_data`` the cohort's stacks ``{"x": [C,
    n_max, ...], "y"}`` and ``sched`` its ``pack_schedule`` output as
    device tensors. Every client runs all S steps of the padded schedule;
    ``client_chunk`` clients train at a time (the activation-memory knob).
    Returns ``(new_global, new_server_state, {"aux", "metrics"})`` with
    per-client aux and metrics."""
    update = make_indexed_client_update(spec, cfg)
    payload_fn = payload_fn or _default_payload
    server_fn = server_fn or _default_server

    def round_fn(global_state, server_state, device_data, sched, round_seed):
        C = sched["mask"].shape[0]
        seeds = client_seeds_for(round_seed, C)
        dev = device_data["x"].device
        data = _flat_data(device_data)
        chunk = (int(client_chunk) if client_chunk and client_chunk < C
                 else C)
        parts, auxes, metrics = None, [], []
        for c0 in range(0, C, chunk):
            sl = slice(c0, min(c0 + chunk, C))
            rows = torch.arange(sl.start, sl.stop, device=dev)
            local, aux, msum = update(
                global_state, dict(data, rows=rows),
                {k: v[sl] for k, v in sched.items()}, seeds[sl])
            with torch.no_grad():
                payloads = payload_fn(local, global_state, aux)
                w = aux["n"].float()
                part = (_weighted_sum(payloads, w),
                        _tree_map(lambda x: x.float().sum(dim=0), payloads),
                        w.sum())
            parts = part if parts is None else _tree_map(torch.add, parts,
                                                         part)
            auxes.append(aux)
            metrics.append(msum)
        cat = lambda *xs: torch.cat(xs)
        with torch.no_grad():
            new_global, new_server = _finish_round(
                payload_fn, server_fn, global_state, server_state, parts, C,
                round_seed)
        return new_global, new_server, {"aux": _tree_map(cat, *auxes),
                                        "metrics": _tree_map(cat, *metrics)}

    return round_fn


def make_sim_round(spec: TrainSpec, cfg: ClientUpdateConfig,
                   payload_fn=None, server_fn=None):
    """The host-packed round: ``round_fn(global_state, server_state,
    cohort_data, round_seed) -> (new_global, new_server_state, {"aux",
    "metrics"})`` with ``cohort_data`` the ``pack_cohort`` output on the
    device; the cohort's clients train at once over a client axis."""
    update = make_client_update(spec, cfg)
    payload_fn = payload_fn or _default_payload
    server_fn = server_fn or _default_server

    def round_fn(global_state, server_state, cohort_data, round_seed):
        C = cohort_data["mask"].shape[0]
        local, aux, metrics = update(global_state, cohort_data,
                                     client_seeds_for(round_seed, C))
        with torch.no_grad():
            payloads = payload_fn(local, global_state, aux)
            w = aux["n"].float()
            parts = (_weighted_sum(payloads, w),
                     _tree_map(lambda x: x.float().sum(dim=0), payloads),
                     w.sum())
            new_global, new_server = _finish_round(
                payload_fn, server_fn, global_state, server_state, parts, C,
                round_seed)
        return new_global, new_server, {"aux": aux, "metrics": metrics}

    return round_fn


def make_sharded_round(spec: TrainSpec, cfg: ClientUpdateConfig, mesh,
                       payload_fn=None, server_fn=None):
    """The host-packed round over a ``clients`` mesh:
    ``round_fn(global_state, server_state, cohort_data, round_seed)``
    with ``cohort_data`` the host-replicated ``pack_cohort`` output (this
    rank places its block, padded with zero-weight dummy clients) or its
    :class:`Sharded` block from ``global_cohort``. Every rank trains its
    block's clients at once, each from its global slot's seed, builds its
    weighted payload sum in fp32 and ``all_reduce``s it with the weight
    total; the server step runs replicated. Works on a mesh of one rank
    too, through the same collective. Returns ``(new_global,
    new_server_state, {"aux", "metrics"})`` with per-client aux and
    metrics as :class:`Sharded` blocks (``multihost.gather_metrics``
    reads them)."""
    update = make_client_update(spec, cfg)
    payload_fn = payload_fn or _default_payload
    server_fn = server_fn or _default_server
    group = mesh.group(CLIENT_AXIS)

    def round_fn(global_state, server_state, cohort_data, round_seed):
        sh = (cohort_data if isinstance(cohort_data, Sharded)
              else global_cohort(mesh, cohort_data))
        block = sh.local["mask"].shape[0]
        seeds = client_seeds_for(round_seed, sh.total)[
            sh.start:sh.start + block]
        local, aux, metrics = update(global_state, sh.local, seeds)
        with torch.no_grad():
            payloads = payload_fn(local, global_state, aux)
            w = aux["n"].float()
            w_sum, pay_sum = all_reduce_sum(
                (w.sum(), _weighted_sum(payloads, w)), group)
            w_sum = torch.clamp(w_sum, min=1e-12)
            avg = _tree_map(lambda s, d: (s / w_sum).to(d), pay_sum,
                            payload_dtype_template(payload_fn,
                                                   global_state))
            new_global, new_server = server_fn(
                global_state, avg, server_state,
                int(fold_seed(round_seed, 2)))
        shard = lambda tree: Sharded(tree, sh.start, sh.total, mesh,
                                     CLIENT_AXIS)
        return new_global, new_server, {"aux": shard(aux),
                                        "metrics": shard(metrics)}

    return round_fn


def make_eval_fn(spec: TrainSpec):
    """Evaluation over packed masked batches (``pack_eval`` output, numpy
    or device tensors): ``eval_fn(state, data) -> {metric: 0-d tensor}``,
    each summed over the batches on the state's device; the host divides
    once it reads them."""

    def eval_fn(state, data):
        dev = next(iter(state["params"].values())).device
        totals = None
        with torch.no_grad():
            for s in range(data["mask"].shape[0]):
                batch = {k: torch.as_tensor(data[k][s], device=dev)
                         for k in ("x", "y", "mask")}
                m = spec.metrics_fn(state, batch)
                totals = m if totals is None else _tree_map(torch.add,
                                                            totals, m)
        return totals

    return eval_fn


__all__ = ["ClientUpdateConfig", "SGD", "AMSGrad", "ClipByGlobalNorm",
           "make_optimizer",
           "fold_seed", "fold_step_seeds", "client_seeds_for",
           "make_client_update", "make_indexed_client_update",
           "make_loop_client_update", "make_lane_update",
           "make_packed_lane_update", "make_streamed_client_update",
           "WaveRunner", "LaneRunner", "ShardedLaneRunner",
           "BucketedStreamRunner", "make_indexed_sim_round",
           "make_sim_round", "make_sharded_round", "make_eval_fn",
           "payload_dtype_template"]
