"""Shared initialisers of the port's model zoo."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def lecun_init_(model, generator):
    """The reference's flax defaults, drawn from ``generator``: lecun-normal
    (fan-in variance, truncated at two standard deviations) for conv and
    dense kernels, zero biases. Other parameters and buffers keep their
    constructor values (BatchNorm scale 1, bias 0, running mean 0, var
    1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                std = math.sqrt(1.0 / (w[0].numel())) / .87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
    return model


__all__ = ["lecun_init_"]
