"""FedOpt: server-side adaptive optimization (counterpart of
``fedml_tpu/algorithms/fedopt.py``).

The server averages the clients' states, treats ``global - avg`` as a
pseudo-gradient and steps a server optimizer on it. The optimizers are
explicit functions on dicts of tensors that compute what the reference's
optax transformations compute, defaults included (they are not
``torch.optim``'s):

- ``sgd``/``fedavgm``: ``optax.sgd(lr, momentum)``, a trace ``t = g +
  momentum * t`` from zero, ``p - lr * t``;
- ``adam``/``fedadam``: ``optax.adam(lr, b1=0.9, b2=0.99, eps=1e-3)``,
  eps outside the square root of the bias-corrected second moment;
- ``adagrad``/``fedadagrad``: ``optax.adagrad(lr, eps=1e-3)``, the sum of
  squares from 0.1 and ``where(sum > 0, rsqrt(sum + eps), 0)``;
- ``yogi``/``fedyogi``: ``optax.yogi(lr)`` (b1 0.9, b2 0.999, eps 1e-3,
  moments from 1e-6), ``nu - (1 - b2) * sign(nu - g^2) * g^2``.

A server state is a dict: ``{"trace"}``, ``{"count", "mu", "nu"}`` or
``{"sum_of_squares"}``, each moment a dict like the params
(``utils/torch_import.py`` carries the reference's optax states over).
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI


def _like(params, value):
    return {k: torch.full_like(v, value) for k, v in params.items()}


class ServerSGD:
    """``optax.sgd(lr, momentum)``."""

    def __init__(self, lr, momentum=0.9):
        self.lr, self.momentum = float(lr), float(momentum)

    def init(self, params):
        return {"trace": _like(params, 0.0)}

    def update(self, grads, state, params):
        """``(new_params, new_state)``; inputs untouched."""
        trace = {k: g + self.momentum * state["trace"][k]
                 for k, g in grads.items()}
        return ({k: p + trace[k] * -self.lr for k, p in params.items()},
                {"trace": trace})


class _Moments:
    """The shared shape of the Adam-family states: ``count`` (int32, 0-d)
    and ``mu``/``nu`` started at ``init_value``."""
    init_value = 0.0

    def __init__(self, lr, b1, b2, eps):
        self.lr, self.b1, self.b2, self.eps = (float(lr), float(b1),
                                               float(b2), float(eps))

    def init(self, params):
        dev = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": _like(params, self.init_value),
                "nu": _like(params, self.init_value)}

    def _nu(self, g, nu):
        raise NotImplementedError

    def update(self, grads, state, params):
        """``(new_params, new_state)``; inputs untouched."""
        count = state["count"] + 1
        bc1 = 1 - self.b1 ** count.float()
        bc2 = 1 - self.b2 ** count.float()
        mu, nu, new_params = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = self._nu(g, state["nu"][k])
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            new_params[k] = p + u * -self.lr
        return new_params, {"count": count, "mu": mu, "nu": nu}


class ServerAdam(_Moments):
    """``optax.adam(lr, b1, b2, eps)``."""

    def _nu(self, g, nu):
        return (1 - self.b2) * (g * g) + self.b2 * nu


class ServerYogi(_Moments):
    """``optax.yogi(lr, b1, b2, eps)`` (moments start at 1e-6)."""
    init_value = 1e-6

    def _nu(self, g, nu):
        g2 = g * g
        return nu - (1 - self.b2) * torch.sign(nu - g2) * g2


class ServerAdagrad:
    """``optax.adagrad(lr, initial_accumulator_value=0.1, eps)``."""

    def __init__(self, lr, eps=1e-3, initial_accumulator_value=0.1):
        self.lr, self.eps = float(lr), float(eps)
        self.initial = float(initial_accumulator_value)

    def init(self, params):
        return {"sum_of_squares": _like(params, self.initial)}

    def update(self, grads, state, params):
        """``(new_params, new_state)``; inputs untouched."""
        sos, new_params = {}, {}
        for k, p in params.items():
            g = grads[k]
            sos[k] = g * g + state["sum_of_squares"][k]
            inv = torch.where(sos[k] > 0, torch.rsqrt(sos[k] + self.eps),
                              torch.zeros_like(sos[k]))
            new_params[k] = p + (inv * g) * -self.lr
        return new_params, {"sum_of_squares": sos}


def get_server_optimizer(name, lr, momentum=0.9, **kw):
    """``--server_optimizer`` name -> server optimizer (FedAvgM = sgd with
    momentum, FedAdam, FedAdagrad, FedYogi), with the reference's
    defaults; ``kw`` overrides ``b1``, ``b2`` and ``eps`` where the
    reference takes them."""
    name = name.lower()
    if name in ("sgd", "fedavgm"):
        return ServerSGD(lr, momentum=momentum)
    if name in ("adam", "fedadam"):
        return ServerAdam(lr, kw.get("b1", 0.9), kw.get("b2", 0.99),
                          kw.get("eps", 1e-3))
    if name in ("adagrad", "fedadagrad"):
        return ServerAdagrad(lr, eps=kw.get("eps", 1e-3))
    if name in ("yogi", "fedyogi"):
        return ServerYogi(lr, 0.9, 0.999, 1e-3)
    raise ValueError(f"unknown server optimizer: {name}")


def make_fedopt_hooks(server_tx):
    """The pseudo-gradient server step as aggregator hooks: the payload
    is the local state; the server steps ``params`` on ``global - avg``,
    and the other entries (``batch_stats``) take the average."""

    def payload_fn(local_state, global_state, aux):
        return local_state

    def server_fn(global_state, avg_state, server_opt_state, rng):
        g_params = global_state["params"]
        pseudo_grad = {k: g_params[k] - avg_state["params"][k]
                       for k in g_params}
        new_params, new_opt_state = server_tx.update(
            pseudo_grad, server_opt_state, g_params)
        new_global = dict(avg_state)
        new_global["params"] = new_params
        return new_global, new_opt_state

    return payload_fn, server_fn


class FedOptAPI(FedAvgAPI):
    """The FedAvg round loop with a server optimizer. Extra args:
    ``server_optimizer`` (default ``sgd``), ``server_lr`` (default 1.0),
    ``server_momentum`` (default 0.9). The server state starts from the
    initial global params. ``compressor=`` composes: the server optimizer
    steps on the pseudo-gradient that survived compression."""

    def __init__(self, dataset, spec, args, mesh=None, metrics_logger=None,
                 device=None, compressor=None):
        server_tx = get_server_optimizer(
            getattr(args, "server_optimizer", "sgd"),
            getattr(args, "server_lr", 1.0),
            momentum=getattr(args, "server_momentum", 0.9))
        payload_fn, server_fn = make_fedopt_hooks(server_tx)
        super().__init__(dataset, spec, args, mesh=mesh,
                         payload_fn=payload_fn, server_fn=server_fn,
                         metrics_logger=metrics_logger, device=device,
                         compressor=compressor)
        self.server_tx = server_tx
        self.server_state = server_tx.init(self.global_state["params"])


__all__ = ["get_server_optimizer", "make_fedopt_hooks", "FedOptAPI",
           "ServerSGD", "ServerAdam", "ServerAdagrad", "ServerYogi"]
