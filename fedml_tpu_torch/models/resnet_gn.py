"""Torchvision-layout ResNets with a GroupNorm knob (counterpart of
``fedml_tpu/models/resnet_gn.py``): ``group_norm`` channels a group,
0 for BatchNorm; the 3x3 stem for CIFAR-size inputs or, with
``small_input=False``, the 7x7/2 stem and a 3x3/2 max pool. The fed
CIFAR-100 recipe trains ResNet-18 with GroupNorm 32.

Submodules carry flax's names (``conv1``, ``bn1``,
``layer{s}_block{b}.{conv1,bn1,...,downsample_conv,downsample_bn}``,
``fc``), so the weight carrier maps names one to one. Compute runs in
``dtype`` with fp32 parameters, fp32 normalisation statistics and fp32
logits; the public forward takes NHWC images.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import FlaxGroupNorm2d, conv2d, nchw
from fedml_tpu_torch.models.resnet import FlaxBatchNorm2d, _conv


def _norm(group_norm, channels, dtype):
    """``group_norm`` > 0: GroupNorm with that many channels a group;
    otherwise BatchNorm (flax's momentum 0.9, eps 1e-5)."""
    if group_norm > 0:
        return FlaxGroupNorm2d(channels, group_norm, dtype)
    return FlaxBatchNorm2d(channels, dtype)


class _BasicBlockGN(nn.Module):
    expansion = 1

    def __init__(self, ci, filters, stride, group_norm, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(ci, filters, 3, stride, 1)
        self.bn1 = _norm(group_norm, filters, dtype)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = _norm(group_norm, filters, dtype)
        # the reference's `residual.shape != y.shape`
        if stride != 1 or ci != filters:
            self.downsample_conv = _conv(ci, filters, 1, stride, 0)
            self.downsample_bn = _norm(group_norm, filters, dtype)

    def forward(self, x):
        dt = self.dtype
        y = F.relu(self.bn1(conv2d(self.conv1, x, dt)))
        y = self.bn2(conv2d(self.conv2, y, dt))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(conv2d(self.downsample_conv, x, dt))
        return F.relu(y + residual)


class _BottleneckGN(nn.Module):
    expansion = 4

    def __init__(self, ci, filters, stride, group_norm, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(ci, filters, 1, 1, 0)
        self.bn1 = _norm(group_norm, filters, dtype)
        self.conv2 = _conv(filters, filters, 3, stride, 1)
        self.bn2 = _norm(group_norm, filters, dtype)
        self.conv3 = _conv(filters, filters * 4, 1, 1, 0)
        self.bn3 = _norm(group_norm, filters * 4, dtype)
        # stage 1's first block has one at stride 1 (64 -> 256 channels)
        if stride != 1 or ci != filters * 4:
            self.downsample_conv = _conv(ci, filters * 4, 1, stride, 0)
            self.downsample_bn = _norm(group_norm, filters * 4, dtype)

    def forward(self, x):
        dt = self.dtype
        y = F.relu(self.bn1(conv2d(self.conv1, x, dt)))
        y = F.relu(self.bn2(conv2d(self.conv2, y, dt)))
        y = self.bn3(conv2d(self.conv3, y, dt))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(conv2d(self.downsample_conv, x, dt))
        return F.relu(y + residual)


class ResNetGN(nn.Module):
    """``stage_sizes`` blocks in each of the stages of 64, 128, 256 and
    512 filters (times 4 for ``block="bottleneck"``)."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), block="basic",
                 num_classes=1000, group_norm=32, small_input=True,
                 in_channels=3, dtype=torch.float32):
        super().__init__()
        self.small_input, self.dtype = small_input, dtype
        self.group_norm = group_norm
        cls = _BasicBlockGN if block == "basic" else _BottleneckGN
        if small_input:
            self.conv1 = _conv(in_channels, 64, 3, 1, 1)
        else:
            self.conv1 = _conv(in_channels, 64, 7, 2, 3)
        self.bn1 = _norm(group_norm, 64, dtype)
        ci, self.blocks = 64, []
        for stage, size in enumerate(stage_sizes):
            filters = 64 * (2 ** stage)
            for b in range(size):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_block{b}"
                setattr(self, name, cls(ci, filters, stride, group_norm,
                                        dtype))
                self.blocks.append(name)
                ci = filters * cls.expansion
        self.fc = nn.Linear(ci, num_classes)

    def forward(self, x, train=False):
        """``x [B, H, W, C]`` -> fp32 logits; ``train`` uses batch
        statistics and updates the running ones (BatchNorm only)."""
        self.train(train)
        x = F.relu(self.bn1(conv2d(self.conv1, nchw(x, self.dtype),
                                   self.dtype)))
        if not self.small_input:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight, self.fc.bias)


def resnet18_gn(class_num=10, group_norm=32, **kw):
    return ResNetGN(stage_sizes=(2, 2, 2, 2), block="basic",
                    num_classes=class_num, group_norm=group_norm, **kw)


def resnet34_gn(class_num=10, group_norm=32, **kw):
    return ResNetGN(stage_sizes=(3, 4, 6, 3), block="basic",
                    num_classes=class_num, group_norm=group_norm, **kw)


def resnet50_gn(class_num=10, group_norm=32, **kw):
    return ResNetGN(stage_sizes=(3, 4, 6, 3), block="bottleneck",
                    num_classes=class_num, group_norm=group_norm, **kw)


__all__ = ["ResNetGN", "resnet18_gn", "resnet34_gn", "resnet50_gn"]
