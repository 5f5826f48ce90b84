"""Logistic regression and the vertical-FL party models (counterpart of
``fedml_tpu/models/linear.py``). Submodules carry flax's names (``linear``,
``dense``, ``hidden_{i}``, ``out``), so ``utils/torch_import.py``
``cv_variables_to_state`` carries the reference's weights."""

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


class DenseModel(nn.Module):
    """The vertical-FL dense head (the reference's
    ``vfl_models_standalone.py``): one linear layer with an optional
    bias, trained by exchanged gradients rather than a local loss."""

    def __init__(self, input_dim, output_dim=1, use_bias=True):
        super().__init__()
        self.dense = nn.Linear(int(input_dim), output_dim, bias=use_bias)

    def forward(self, x, train=False):
        return self.dense(x)


class LocalModel(nn.Module):
    """A vertical-FL party's feature extractor (the reference's
    ``vfl_models_standalone.py`` LocalModel): a dense-relu stack, then a
    dense output."""

    def __init__(self, input_dim, hidden_dims=(32,), output_dim=10):
        super().__init__()
        self.n_hidden = len(hidden_dims)
        width = int(input_dim)
        for i, h in enumerate(hidden_dims):
            setattr(self, f"hidden_{i}", nn.Linear(width, h))
            width = h
        self.out = nn.Linear(width, output_dim)

    def forward(self, x, train=False):
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
        return self.out(x)


__all__ = ["LogisticRegression", "DenseModel", "LocalModel"]
