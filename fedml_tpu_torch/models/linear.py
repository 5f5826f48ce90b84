"""Logistic regression (counterpart of ``fedml_tpu/models/linear.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn


class LogisticRegression(nn.Module):
    """One dense layer over the flattened input. With ``apply_sigmoid``
    (the default) the output is ``sigmoid(logits)``, which the loss then
    treats as logits: the reference's quirk inherited from LEAF, kept so
    accuracy curves compare."""

    def __init__(self, input_dim, num_classes, apply_sigmoid=True):
        super().__init__()
        self.apply_sigmoid = apply_sigmoid
        self.linear = nn.Linear(int(input_dim), num_classes)

    def forward(self, x, train=False):
        out = self.linear(x.reshape(x.shape[0], -1).float())
        return torch.sigmoid(out) if self.apply_sigmoid else out


__all__ = ["LogisticRegression"]
