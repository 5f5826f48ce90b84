"""Robust FedAvg: defenses against poisoning (counterpart of
``fedml_tpu/algorithms/fedavg_robust.py``).

Each client's update is clipped to an L2 ball around the global model
before the weighted average (the payload), and weak-DP Gaussian noise
goes on the average (the server hook, seeded from the round's server
seed). The attack success rate is measured on the poisoned test set of
``data/poison.py`` through the packed evaluation.
"""

from __future__ import annotations

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.robust import add_gaussian_noise, norm_diff_clipping
from fedml_tpu_torch.parallel.packing import pack_eval


def make_robust_hooks(norm_bound, stddev):
    def payload_fn(local_state, global_state, aux):
        return norm_diff_clipping(local_state, global_state, norm_bound)

    def server_fn(global_state, avg_state, server_state, rng):
        if stddev and stddev > 0:
            avg_state = add_gaussian_noise(avg_state, stddev, rng)
        return avg_state, server_state

    return payload_fn, server_fn


class FedAvgRobustAPI(FedAvgAPI):
    """Extra args: ``norm_bound`` (the clip radius, default 30) and
    ``stddev`` (the noise, default 0.025); the poisoned data comes from
    ``data/poison.py``."""

    def __init__(self, dataset, spec, args, mesh=None, metrics_logger=None,
                 poisoned_test_data=None, device=None):
        payload_fn, server_fn = make_robust_hooks(
            getattr(args, "norm_bound", 30.0),
            getattr(args, "stddev", 0.025))
        super().__init__(dataset, spec, args, mesh=mesh,
                         payload_fn=payload_fn, server_fn=server_fn,
                         metrics_logger=metrics_logger, device=device)
        self.poisoned_test_data = poisoned_test_data

    def evaluate_backdoor(self):
        """Attack success rate on the poisoned test set: ``{"Backdoor/Acc"}``,
        or ``{}`` without one."""
        if self.poisoned_test_data is None:
            return {}
        m = self.eval_fn(self.global_state,
                         pack_eval(self.poisoned_test_data,
                                   self.args.batch_size))
        return {"Backdoor/Acc": float(m["correct"])
                / max(float(m["count"]), 1)}


__all__ = ["make_robust_hooks", "FedAvgRobustAPI"]
