"""MobileNet v1, depthwise separable (counterpart of
``fedml_tpu/models/mobilenet.py``): the 3x3/1 CIFAR stem and the 13
blocks of ``_CFG`` at width 1.0; the cross-silo CIFAR-10/100 and
CINIC-10 recipes train it.

Depthwise convolutions are ``groups=in_ch``. Submodules carry flax's
names (``conv1``, ``bn1``, ``block{i}.{dw,bn1,pw,bn2}``, ``fc``);
compute runs in ``dtype`` with fp32 parameters, BatchNorm statistics
and logits, and the public forward takes NHWC images.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import conv2d, nchw
from fedml_tpu_torch.models.resnet import FlaxBatchNorm2d

# (filters, stride) per depthwise-separable block, standard MobileNet v1
_CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]


class _DepthwiseSeparable(nn.Module):
    def __init__(self, ci, filters, stride, dtype):
        super().__init__()
        self.dtype = dtype
        self.dw = nn.Conv2d(ci, ci, 3, stride=stride, padding=1, groups=ci,
                            bias=False)
        self.bn1 = FlaxBatchNorm2d(ci, dtype)
        self.pw = nn.Conv2d(ci, filters, 1, bias=False)
        self.bn2 = FlaxBatchNorm2d(filters, dtype)

    def forward(self, x):
        x = F.relu(self.bn1(conv2d(self.dw, x, self.dtype)))
        return F.relu(self.bn2(conv2d(self.pw, x, self.dtype)))


class MobileNet(nn.Module):
    def __init__(self, num_classes=10, in_channels=3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, 32, 3, padding=1, bias=False)
        self.bn1 = FlaxBatchNorm2d(32, dtype)
        ci = 32
        for i, (filters, stride) in enumerate(_CFG):
            setattr(self, f"block{i}",
                    _DepthwiseSeparable(ci, filters, stride, dtype))
            ci = filters
        self.fc = nn.Linear(ci, num_classes)

    def forward(self, x, train=False):
        """``x [B, H, W, C]`` -> fp32 logits; ``train`` uses batch
        statistics and updates the running ones."""
        self.train(train)
        x = nchw(x, self.dtype)
        x = F.relu(self.bn1(conv2d(self.conv1, x, self.dtype)))
        for i in range(len(_CFG)):
            x = getattr(self, f"block{i}")(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight, self.fc.bias)


__all__ = ["MobileNet"]
