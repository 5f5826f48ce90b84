"""FedSeg: federated semantic segmentation (counterpart of
``fedml_tpu/algorithms/fedseg.py``).

FedAvg over a DeepLab-style model with (a) mIoU/FWIoU evaluation from a
confusion matrix (``core/seg_eval.py``), (b) the cos/poly/step learning
rate schedules with warmup (``utils/schedules.py``), each client's
local SGD counting its own steps from 0 every round, and (c) best-metric
checkpointing on ``Seg/mIoU`` in the experiment main.

The round engine is the port's FedAvg engine; only the task spec
(per-pixel cross-entropy and the confusion metrics,
``algorithms/specs.py`` ``make_segmentation_spec``) and the evaluation
differ. The confusion matrix is counted on the device and read once
an evaluation.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.seg_eval import Evaluator
from fedml_tpu_torch.utils.schedules import make_lr_schedule


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class FedSegAPI(FedAvgAPI):
    """The FedAvg loop with segmentation evaluation and the reference's
    learning-rate schedules.

    Extra args (the reference's FedSeg flags): ``lr_scheduler``
    (cos|poly|step), ``lr_step``, ``warmup_epochs``. The schedule's
    horizon is one round's local epochs over the largest shard, so no
    client's steps outrun it (smaller clients stop mid-decay).
    """

    def __init__(self, dataset, spec, args, mesh=None, metrics_logger=None,
                 device=None, **kw):
        mode = getattr(args, "lr_scheduler", None)
        if mode:
            sizes = [len(d["y"]) for d in dataset[5].values()
                     if d is not None and len(d["y"])]
            iters = max(1, math.ceil(max(sizes) / args.batch_size))
            schedule = make_lr_schedule(
                mode, args.lr, args.epochs, iters,
                lr_step=getattr(args, "lr_step", 0),
                warmup_epochs=getattr(args, "warmup_epochs", 0))
            args = argparse.Namespace(**{**vars(args), "lr": schedule})
        super().__init__(dataset, spec, args, mesh=mesh,
                         metrics_logger=metrics_logger, device=device, **kw)
        self.num_classes = dataset[7]
        self.checkpoint_metric = "Seg/mIoU"

    def evaluate_global(self):
        m = {k: _host(v) for k, v in self.eval_fn(
            self.global_state, self._packed_global_eval()).items()}
        ev = Evaluator(self.num_classes)
        ev.add_matrix(m["confusion"])
        count = max(float(m["count"]), 1)
        out = {"Test/Loss": float(m["loss_sum"]) / count,
               "Test/Acc": float(m["correct"]) / count}
        out.update(ev.metrics())
        return out

    def train_one_round(self):
        metrics = super().train_one_round()
        # the round's train confusion rides the summed metrics
        cm = _host(self._last_round_metrics["confusion"])
        while cm.ndim > 2:  # per-client leading axes
            cm = cm.sum(axis=0)
        ev = Evaluator(self.num_classes)
        ev.add_matrix(cm)
        metrics["Train/mIoU"] = ev.mean_iou()
        return metrics


__all__ = ["FedSegAPI"]
