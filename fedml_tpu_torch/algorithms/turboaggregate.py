"""TurboAggregate: FedAvg with a secure aggregate (counterpart of
``fedml_tpu/algorithms/turboaggregate.py``; the reference's
``fedml_api/distributed/turboaggregate/``: the Lagrange/BGW MPC
primitives of ``mpc_function.py`` beside a weighted-average aggregator,
``TA_Aggregator.py:56-85``).

Local training runs on the device through the engine's host-packed
client update; the aggregate runs on the host through the
additive-masking secure sum (``core/mpc.py`` ``secure_aggregate``): the
server only ever combines masked shares, never one client's update. Each
leaf of the clients' ``n_i``-weighted states -- the non-param state
(BatchNorm statistics) included, as in the reference -- comes to the host
in float64, is summed in the field at the fixed-point scale
``args.mpc_scale`` (default ``2**16``) and goes back to the device in the
leaf's dtype. The fixed point costs at most ``C / (2 * mpc_scale)`` a
value against the plain FedAvg round of the same cohort.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.compression.compressors import tree_build, tree_items
from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.parallel.engine import (client_seeds_for, fold_seed,
                                             make_client_update)


class TurboAggregateAPI(FedAvgAPI):
    """The FedAvg round loop with the aggregate replaced by a secure
    masked sum; every round takes the host-packed path. Extra args:
    ``mpc_scale`` (the fixed-point scale)."""

    def __init__(self, dataset, spec, args, metrics_logger=None,
                 device=None):
        super().__init__(dataset, spec, args, metrics_logger=metrics_logger,
                         device=device)
        self._client_update = make_client_update(spec, self.cfg)
        self.mpc_scale = getattr(args, "mpc_scale", 2 ** 16)
        # the masking stream: derived from the run seed through the MPC
        # salt (mpc.mask_rng), never an unseeded or constant default
        self._mpc_rng = mpc.mask_rng(getattr(args, "seed", 0))

    def train_one_round(self):
        t0 = time.time()
        _, packed = self._cohort(self.round_idx)
        C = packed["mask"].shape[0]
        round_seed = int(fold_seed(self.seed, self.round_idx))
        local_states, aux, metrics = self._client_update(
            self.global_state, packed, client_seeds_for(round_seed, C))

        # float64 on the host: the sample counts are exact integers and
        # the fixed-point encode/decode needs the 53-bit mantissa for the
        # weight normalization to round-trip
        ns = aux["n"].cpu().numpy().astype(np.float64)
        total_n = max(ns.sum(), 1e-12)
        agg = []
        for path, leaf in tree_items(local_states):
            host = leaf.detach().cpu().numpy().astype(np.float64)
            weighted = [host[c] * (ns[c] / total_n) for c in range(C)]
            s = mpc.secure_aggregate(weighted, scale=self.mpc_scale,
                                     rng=self._mpc_rng)
            agg.append((path, torch.as_tensor(s, device=self.device)
                        .to(leaf.dtype)))
        self.global_state = tree_build(agg)

        m = {k: float(v.sum()) for k, v in metrics.items()}
        out = {"round": self.round_idx,
               "Train/Loss": m["loss_sum"] / max(m["count"], 1),
               "Train/Acc": m["correct"] / max(m["count"], 1),
               "round_time_s": time.time() - t0}
        self.round_idx += 1
        return out


__all__ = ["TurboAggregateAPI"]
