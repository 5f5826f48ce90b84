"""FedAvg round loop (counterpart of ``fedml_tpu/algorithms/fedavg.py``),
restricted to the single-device, device-resident, packed-lane path
(``wave_mode=3``).

Every client's padded shard is uploaded to the device once; a round is
a seeded cohort draw, an index schedule on the host, and one
``LaneRunner(packed=True)`` pass. The other round paths (waves, vmap
lanes, flat, bucketed streaming, compression, resilience, meshes) and
the ``RoundProgram`` object wait for ROADMAP A6, A8, A11, A12 and A15.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from fedml_tpu_torch.core.trainer import TrainSpec
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig, LaneRunner,
                                             fold_seed)
from fedml_tpu_torch.parallel.packing import (pack_eval, pack_schedule,
                                              stack_clients)
from fedml_tpu_torch.program.cohort import client_sampling
from fedml_tpu_torch.utils.device import resolve_device

# reference args whose non-default values select a path not ported yet
_UNPORTED = {
    "compressor": "ROADMAP A12 (compression)",
    "bucket_edges": "ROADMAP A10 (bucketed streaming)",
    "async_agg": "ROADMAP A10 (bucketed streaming)",
    "overselect": "ROADMAP A11 (SimResilience)",
    "straggler_p": "ROADMAP A11 (SimResilience)",
    "pace_steering": "ROADMAP A11 (pace steering)",
}


class FedAvgAPI:
    """Round-loop orchestrator.

    Args:
      dataset: the 8-tuple contract ``[train_num, test_num, train_global,
        test_global, train_local_num_dict, train_local_dict,
        test_local_dict, class_num]`` with NHWC numpy shards.
      spec: a :class:`TrainSpec` with a ``lane_loss_builder``.
      args: the reference's hyperparameter namespace (``lr``, ``wd``,
        ``batch_size``, ``epochs``, ``client_chunk`` lanes,
        ``wave_mode=3``, ``device_data_cap_gb``, ``device_dtype``, ...).
      device: ``None`` runs on the GPU and raises without one; pass
        ``"cpu"`` to run on the CPU.
      payload_fn / server_fn / server_state: aggregator hooks; payload_fn
        takes lane-stacked local state.
    """

    def __init__(self, dataset, spec: TrainSpec, args, mesh=None,
                 payload_fn=None, server_fn=None, server_state=None,
                 metrics_logger=None, device=None):
        (self.train_data_num, self.test_data_num, self.train_data_global,
         self.test_data_global, self.train_data_local_num_dict,
         self.train_data_local_dict, self.test_data_local_dict,
         self.class_num) = dataset
        self.spec, self.args = spec, args
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        self.metrics_logger = metrics_logger or (
            lambda d: logging.info("%s", d))
        if mesh is not None:
            raise NotImplementedError("mesh rounds wait for ROADMAP A15")
        for name, item in _UNPORTED.items():
            if getattr(args, name, None) not in (None, 0, 0.0, False,
                                                 "none"):
                raise NotImplementedError(f"--{name} waits for {item}")
        if int(getattr(args, "wave_mode", 1)) != 3:
            raise NotImplementedError(
                "only wave_mode=3 (packed lanes) is ported; the other "
                "round paths wait for ROADMAP A6")
        if spec.lane_loss_builder is None:
            raise NotImplementedError(
                "wave_mode=3 needs a model family with a lane-packed "
                "lowering; the vmap fallback waits for ROADMAP A6")
        if str(getattr(args, "device_resident", "auto")).lower() in (
                "0", "false", "none", ""):
            raise NotImplementedError(
                "host-packed rounds wait for ROADMAP A6")

        self.cfg = ClientUpdateConfig(
            optimizer=getattr(args, "client_optimizer", "sgd"),
            lr=args.lr,
            weight_decay=getattr(args, "wd", 0.0),
            momentum=getattr(args, "momentum", 0.0),
            grad_clip=getattr(args, "grad_clip", None))

        stacked = self._stack_if_fits(args)
        if stacked is None:
            raise NotImplementedError(
                "the client shards exceed device_data_cap_gb; host-packed "
                "rounds wait for ROADMAP A6")
        self.device_data = {"x": stacked["x"], "y": stacked["y"]}
        self._client_ns = stacked["n"]
        self.packed_lane_runner = LaneRunner(
            spec, self.cfg, payload_fn, server_fn,
            n_lanes=getattr(args, "client_chunk", 8) or 8, packed=True)
        self.server_state = server_state if server_state is not None else ()

        self.seed = int(getattr(args, "seed", 0))
        self.global_state = spec.init_fn(self.seed, self.device)
        self._data_rng = np.random.default_rng(self.seed)
        self.round_idx = 0
        self.history = []

    def _stack_if_fits(self, args):
        """Stack every client's padded shard onto the device when it fits
        ``device_data_cap_gb``; ``device_dtype`` bf16 halves a floating
        ``x``. Returns ``{"x", "y"}`` device tensors and ``"n"``, or
        None."""
        C = len(self.train_data_local_dict)
        n_max = max(1, max(len(d["y"])
                           for d in self.train_data_local_dict.values()))
        x0 = np.asarray(self.train_data_local_dict[0]["x"])
        y0 = np.asarray(self.train_data_local_dict[0]["y"])
        cast_bf16 = (getattr(args, "device_dtype", None) in ("bf16",
                                                             "bfloat16")
                     and np.issubdtype(x0.dtype, np.floating))
        x_itemsize = 2 if cast_bf16 else x0.dtype.itemsize
        row = (int(np.prod(x0.shape[1:], dtype=np.int64)) * x_itemsize
               + int(np.prod(y0.shape[1:], dtype=np.int64) or 1)
               * y0.dtype.itemsize)
        if C * n_max * row > float(getattr(args, "device_data_cap_gb",
                                           2.0)) * 1e9:
            return None
        host = stack_clients([self.train_data_local_dict[i]
                              for i in range(C)])
        x = torch.as_tensor(host["x"], device=self.device)
        if cast_bf16:
            x = x.to(torch.bfloat16)
        y = torch.as_tensor(host["y"], device=self.device).long()
        return {"x": x, "y": y, "n": host["n"]}

    def _sample_cohort(self, round_idx):
        return client_sampling(round_idx, len(self.train_data_local_dict),
                               self.args.client_num_per_round)

    def train_one_round(self):
        t0 = time.time()
        metrics = self._traced_round_body(t0)
        self.round_idx += 1
        return metrics

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _traced_round_body(self, t0):
        client_indexes = self._sample_cohort(self.round_idx)
        logging.info("client_indexes = %s", client_indexes)
        ns = [self._client_ns[i] for i in client_indexes]
        if sum(ns) == 0:
            raise ValueError(f"round {self.round_idx}: every sampled "
                             f"client has an empty shard")
        sched = pack_schedule(ns, self.args.batch_size, self.args.epochs,
                              rng=self._data_rng, native=False)
        round_seed = int(fold_seed(self.seed, self.round_idx))
        (self.global_state, self.server_state,
         info) = self.packed_lane_runner.run_round(
            self.global_state, self.server_state, self.device_data,
            client_indexes, sched, round_seed)
        self._sync()
        dt = time.time() - t0
        m = {k: float(v.sum()) for k, v in info["metrics"].items()}
        self._last_trip = info["trip"]
        return {"round": self.round_idx,
                "Train/Loss": m["loss_sum"] / max(m["count"], 1),
                "Train/Acc": m["correct"] / max(m["count"], 1),
                "round_time_s": dt}

    def evaluate_global(self):
        """Test loss and accuracy of the global model on the global test
        set, in batches of ``batch_size``."""
        packed = pack_eval(self.test_data_global, self.args.batch_size)
        totals = {}
        for s in range(packed["mask"].shape[0]):
            batch = {k: torch.as_tensor(v[s], device=self.device)
                     for k, v in packed.items()}
            m = self.spec.metrics_fn(self.global_state, batch)
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)
        count = max(totals["count"], 1)
        return {"Test/Loss": totals["loss_sum"] / count,
                "Test/Acc": totals["correct"] / count}

    def train(self, on_round=None):
        """Round loop until ``comm_round``; evaluates every
        ``frequency_of_the_test`` rounds and on the last. ``on_round(api,
        metrics)`` runs after each round."""
        freq = getattr(self.args, "frequency_of_the_test", 5)
        while self.round_idx < self.args.comm_round:
            metrics = self.train_one_round()
            last = self.round_idx == self.args.comm_round
            if self.round_idx % freq == 0 or last:
                metrics.update(self.evaluate_global())
            self.metrics_logger(metrics)
            self.history.append(metrics)
            if on_round is not None:
                on_round(self, metrics)
        return self.global_state


__all__ = ["FedAvgAPI", "client_sampling"]
