"""The FedAvg-paper CNNs (counterpart of ``fedml_tpu/models/cnn.py``).

Inputs are NHWC ``[B, H, W]`` or ``[B, H, W, C]`` like the reference
(28x28x1 by default: ``CNNOriginalFedAvg`` then has 1,663,370 parameters
and ``CNNDropOut`` 1,199,882 with ``only_digits``). Convolutions run in
NCHW; the activations are flattened in the reference's (H, W, C) order,
so ``fc1``'s input rows are flax's. Compute runs in ``dtype`` (the head
in fp32) with fp32 parameters.

``CNNDropOut``'s dropout draws no randomness of its own: training takes
keep masks (``draw_dropout_masks``, from an explicit generator; the
``MaskedDropout`` mixin of ``models/layers.py``), so K clients can train
at once under ``torch.func.vmap`` with each client's masks drawn from its
own seed.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import (MaskedDropout, conv2d, dense,
                                           flatten_hwc, hwc, nchw)


class CNNOriginalFedAvg(nn.Module):
    """conv5x5(32) + maxpool + conv5x5(64) + maxpool + dense 512 + head,
    biased convs without activations, as the reference."""

    def __init__(self, only_digits=True, input_shape=(28, 28, 1),
                 dtype=torch.float32):
        super().__init__()
        H, W, C = hwc(input_shape)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(C, 32, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2)
        self.fc1 = nn.Linear((H // 4) * (W // 4) * 64, 512)
        self.fc2 = nn.Linear(512, 10 if only_digits else 62)

    def forward(self, x, train=False):
        dt = self.dtype
        x = F.max_pool2d(conv2d(self.conv1, nchw(x, dt), dt), 2, 2)
        x = F.max_pool2d(conv2d(self.conv2, x, dt), 2, 2)
        x = F.relu(dense(self.fc1, flatten_hwc(x), dt))
        return F.linear(x.float(), self.fc2.weight, self.fc2.bias)


class CNNDropOut(MaskedDropout, nn.Module):
    """conv3x3(32) + relu + conv3x3(64) + relu + maxpool + dropout 0.25 +
    dense 128 + relu + dropout 0.5 + head (valid convs). Its keep masks
    (:class:`~fedml_tpu_torch.models.layers.MaskedDropout`) are ``mask1
    [n, 64, h, w]`` after the pool and ``mask2 [n, 128]`` after ``fc1``."""

    def __init__(self, only_digits=True, input_shape=(28, 28, 1),
                 dtype=torch.float32):
        super().__init__()
        H, W, C = hwc(input_shape)
        self.dtype = dtype
        pooled = ((H - 4) // 2, (W - 4) // 2)
        self.conv1 = nn.Conv2d(C, 32, 3)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.fc1 = nn.Linear(pooled[0] * pooled[1] * 64, 128)
        self.fc2 = nn.Linear(128, 10 if only_digits else 62)
        self._mask_specs = {"mask1": ((64,) + pooled, 0.25),
                            "mask2": ((128,), 0.5)}

    def forward(self, x, train=False, dropout_masks=None):
        """``train`` applies the given keep masks; training without masks
        raises."""
        masks = self._masks_for(train, dropout_masks)
        dt = self.dtype
        x = F.relu(conv2d(self.conv1, nchw(x, dt), dt))
        x = F.relu(conv2d(self.conv2, x, dt))
        x = self._dropout(F.max_pool2d(x, 2, 2), masks, "mask1")
        x = self._dropout(F.relu(dense(self.fc1, flatten_hwc(x), dt)), masks,
                          "mask2")
        return F.linear(x.float(), self.fc2.weight, self.fc2.bias)


__all__ = ["CNNOriginalFedAvg", "CNNDropOut"]
