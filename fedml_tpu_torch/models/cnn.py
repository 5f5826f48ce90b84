"""The FedAvg-paper CNNs (counterpart of ``fedml_tpu/models/cnn.py``).

Inputs are NHWC ``[B, H, W]`` or ``[B, H, W, C]`` like the reference
(28x28x1 by default: ``CNNOriginalFedAvg`` then has 1,663,370 parameters
and ``CNNDropOut`` 1,199,882 with ``only_digits``). Convolutions run in
NCHW; the activations are flattened in the reference's (H, W, C) order,
so ``fc1``'s input rows are flax's. Compute runs in ``dtype`` (the head
in fp32) with fp32 parameters.

``CNNDropOut``'s dropout draws no randomness of its own: training takes
keep masks (:meth:`CNNDropOut.draw_dropout_masks`, from an explicit
generator), so K clients can train at once under ``torch.func.vmap``
with each client's masks drawn from its own seed.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _nchw(x, dtype):
    if x.dim() == 3:
        x = x[..., None]
    return x.to(dtype).permute(0, 3, 1, 2)


def _hwc(input_shape):
    shape = tuple(int(d) for d in input_shape)
    return shape if len(shape) == 3 else shape + (1,)


def _flatten_hwc(x):
    """``[B, C, H, W] -> [B, H*W*C]`` in flax's (H, W, C) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNNOriginalFedAvg(nn.Module):
    """conv5x5(32) + maxpool + conv5x5(64) + maxpool + dense 512 + head,
    biased convs without activations, as the reference."""

    def __init__(self, only_digits=True, input_shape=(28, 28, 1),
                 dtype=torch.float32):
        super().__init__()
        H, W, C = _hwc(input_shape)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(C, 32, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2)
        self.fc1 = nn.Linear((H // 4) * (W // 4) * 64, 512)
        self.fc2 = nn.Linear(512, 10 if only_digits else 62)

    def _conv(self, conv, x):
        return F.conv2d(x, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), padding=conv.padding)

    def forward(self, x, train=False):
        dt = self.dtype
        x = F.max_pool2d(self._conv(self.conv1, _nchw(x, dt)), 2, 2)
        x = F.max_pool2d(self._conv(self.conv2, x), 2, 2)
        x = F.relu(F.linear(_flatten_hwc(x), self.fc1.weight.to(dt),
                            self.fc1.bias.to(dt)))
        return F.linear(x.float(), self.fc2.weight, self.fc2.bias)


class CNNDropOut(nn.Module):
    """conv3x3(32) + relu + conv3x3(64) + relu + maxpool + dropout 0.25 +
    dense 128 + relu + dropout 0.5 + head (valid convs)."""

    RATES = (0.25, 0.5)

    def __init__(self, only_digits=True, input_shape=(28, 28, 1),
                 dtype=torch.float32):
        super().__init__()
        H, W, C = _hwc(input_shape)
        self.dtype = dtype
        self.pooled = ((H - 4) // 2, (W - 4) // 2)
        self.conv1 = nn.Conv2d(C, 32, 3)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.fc1 = nn.Linear(self.pooled[0] * self.pooled[1] * 64, 128)
        self.fc2 = nn.Linear(128, 10 if only_digits else 62)

    def draw_dropout_masks(self, n, generator):
        """Keep masks (0/1 floats) for ``n`` samples on the generator's
        device: ``mask1 [n, 64, h, w]`` after the pool, ``mask2 [n,
        128]`` after ``fc1``."""
        dev = generator.device
        shapes = ((n, 64) + self.pooled, (n, 128))
        return {f"mask{i + 1}": (torch.rand(s, generator=generator,
                                            device=dev) < 1.0 - r).float()
                for i, (s, r) in enumerate(zip(shapes, self.RATES))}

    def forward(self, x, train=False, dropout_masks=None):
        """``train`` applies the given keep masks (flax's dropout: kept
        activations scaled by ``1 / keep``); training without masks
        raises."""
        if train and dropout_masks is None:
            raise ValueError("CNNDropOut trains with explicit dropout "
                             "masks (draw_dropout_masks)")
        dt = self.dtype
        x = F.relu(F.conv2d(_nchw(x, dt), self.conv1.weight.to(dt),
                            self.conv1.bias.to(dt)))
        x = F.relu(F.conv2d(x, self.conv2.weight.to(dt),
                            self.conv2.bias.to(dt)))
        x = F.max_pool2d(x, 2, 2)
        if train:
            x = x * dropout_masks["mask1"].to(dt) / (1.0 - self.RATES[0])
        x = F.relu(F.linear(_flatten_hwc(x), self.fc1.weight.to(dt),
                            self.fc1.bias.to(dt)))
        if train:
            x = x * dropout_masks["mask2"].to(dt) / (1.0 - self.RATES[1])
        return F.linear(x.float(), self.fc2.weight, self.fc2.bias)


__all__ = ["CNNOriginalFedAvg", "CNNDropOut"]
