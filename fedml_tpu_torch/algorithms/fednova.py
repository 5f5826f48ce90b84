"""FedNova: normalized averaging (counterpart of
``fedml_tpu/algorithms/fednova.py``).

Each client reports its normalized update direction ``d_i = (global -
local) / tau_i`` (``tau_i`` its executed local steps, at least 1); the
server applies ``global -= tau_eff * sum_i p_i d_i`` with ``tau_eff =
sum_i p_i tau_i``. Both flow through the runners' one weighted mean: the
payload ``{"d", "tau", "rest"}`` averaged by sample counts is ``{sum_i
p_i d_i, tau_eff, the average of the other entries}``.

The port's ``payload_fn`` takes client- or lane-stacked local state, so
``tau`` is ``[K]`` and broadcasts over each leaf's leading axis (the
reference's is a scalar under vmap).
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI


def fednova_payload(local_state, global_state, aux):
    tau = torch.clamp(aux["steps"].float(), min=1.0)
    inv = 1.0 / tau

    def direction(g, lo):
        return (g - lo) * inv.reshape(inv.shape + (1,) * (lo.dim()
                                                          - inv.dim()))

    g_params = global_state["params"]
    d = {k: direction(g_params[k], v)
         for k, v in local_state["params"].items()}
    rest = {k: v for k, v in local_state.items() if k != "params"}
    return {"d": d, "tau": tau, "rest": rest}


def fednova_server(global_state, avg_payload, server_state, rng):
    tau_eff = avg_payload["tau"]
    new_global = dict(avg_payload["rest"])
    new_global["params"] = {k: p - avg_payload["d"][k] * tau_eff
                            for k, p in global_state["params"].items()}
    return new_global, server_state


class FedNovaAPI(FedAvgAPI):
    def __init__(self, dataset, spec, args, mesh=None, metrics_logger=None,
                 device=None):
        super().__init__(dataset, spec, args, mesh=mesh,
                         payload_fn=fednova_payload,
                         server_fn=fednova_server,
                         metrics_logger=metrics_logger, device=device)


__all__ = ["fednova_payload", "fednova_server", "FedNovaAPI"]
