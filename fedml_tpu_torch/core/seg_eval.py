"""Segmentation evaluation: confusion-matrix metrics (counterpart of
``fedml_tpu/core/seg_eval.py``).

Pixel Accuracy, per-class Accuracy, mIoU and FWIoU from an accumulated
``[C, C]`` confusion matrix (rows = ground truth, cols = prediction;
out-of-range labels excluded). The matrix is counted on the labels'
device (:func:`confusion_matrix`, which the segmentation spec's summed
metrics carry), the scalar metrics divide on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a):
    """A tensor as it is; anything array-like through numpy."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


def confusion_matrix(y_true, y_pred, num_class, sample_mask=None):
    """The fp32 ``[C, C]`` confusion matrix over flattened labels, on
    their device. Invalid ground-truth pixels (outside ``[0, C)``) and
    masked samples land in an overflow slot ``C*C`` that is cut off, as
    in the reference."""
    y_true = _tensor(y_true).reshape(-1).long()
    y_pred = _tensor(y_pred).reshape(-1).long().to(y_true.device)
    valid = (y_true >= 0) & (y_true < num_class)
    if sample_mask is not None:
        valid = valid & (_tensor(sample_mask).reshape(-1).to(
            y_true.device) > 0)
    idx = torch.where(valid, y_true * num_class + y_pred,
                      torch.full_like(y_true, num_class * num_class))
    counts = torch.bincount(idx, minlength=num_class * num_class + 1)
    return counts[:-1].float().reshape(num_class, num_class)


class Evaluator:
    """Host-side accumulator with the reference's metric formulas."""

    def __init__(self, num_class):
        self.num_class = num_class
        self.reset()

    def reset(self):
        self.mat = np.zeros((self.num_class, self.num_class), np.float64)

    def add_batch(self, gt, pred):
        self.mat += confusion_matrix(gt, pred,
                                     self.num_class).cpu().numpy()

    def add_matrix(self, mat):
        if isinstance(mat, torch.Tensor):
            mat = mat.detach().cpu().numpy()
        self.mat += np.asarray(mat, np.float64)

    def pixel_accuracy(self):
        return float(np.diag(self.mat).sum() / max(self.mat.sum(), 1e-12))

    def pixel_accuracy_class(self):
        with np.errstate(invalid="ignore", divide="ignore"):
            acc = np.diag(self.mat) / self.mat.sum(axis=1)
        return float(np.nanmean(acc))

    def mean_iou(self):
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = np.diag(self.mat) / (self.mat.sum(1) + self.mat.sum(0)
                                       - np.diag(self.mat))
        return float(np.nanmean(iou))

    def frequency_weighted_iou(self):
        freq = self.mat.sum(1) / max(self.mat.sum(), 1e-12)
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = np.diag(self.mat) / (self.mat.sum(1) + self.mat.sum(0)
                                       - np.diag(self.mat))
        return float((freq[freq > 0] * iou[freq > 0]).sum())

    def metrics(self):
        return {"Seg/Acc": self.pixel_accuracy(),
                "Seg/AccClass": self.pixel_accuracy_class(),
                "Seg/mIoU": self.mean_iou(),
                "Seg/FWIoU": self.frequency_weighted_iou()}


__all__ = ["confusion_matrix", "Evaluator"]
