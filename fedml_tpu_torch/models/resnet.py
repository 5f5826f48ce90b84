"""CIFAR ResNets (BasicBlock, BatchNorm) as ``nn.Module``s (counterpart of
``fedml_tpu/models/resnet.py``).

Compute runs in ``dtype`` (bf16 on the main path) with fp32 master
parameters, fp32 BatchNorm statistics and fp32 logits. BatchNorm follows
flax semantics, not ``nn.BatchNorm2d``'s: the batch variance is the fast
``E[x^2] - E[x]^2`` clipped at 0 (biased, also in the running stats),
momentum 0.9 on the old value, eps 1e-5. Parameter and buffer names are
the torch ``state_dict`` names the weight carrier
(``utils/torch_import.py``) maps to the JAX package's variables.

The public forward takes NHWC images like the reference and runs NCHW
inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import conv2d, fp32_or_wider

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def flax_batch_norm(x, scale, bias, mean, var, train, dtype,
                    momentum=BN_MOMENTUM, eps=BN_EPS):
    """BatchNorm over every axis but 1 of ``x`` (NCHW), flax semantics
    (``momentum`` on the old running value, ``eps`` inside the root).

    Returns ``(y, new_mean, new_var)``; in eval mode the running stats
    pass through. ``scale`` and ``bias`` may be None (no affine).
    Statistics and the normalisation run in fp32 (float64 for a float64
    ``x``), the result is cast to ``dtype``."""
    xf = fp32_or_wider(x)
    if train:
        dims = [d for d in range(x.dim()) if d != 1]
        mu = xf.mean(dim=dims)
        mu2 = (xf * xf).mean(dim=dims)
        v = torch.clamp(mu2 - mu * mu, min=0.0)
        new_mean = momentum * mean + (1 - momentum) * mu.detach()
        new_var = momentum * var + (1 - momentum) * v.detach()
    else:
        mu, v = mean, var
        new_mean, new_var = mean, var
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(v + eps)
    if scale is not None:
        mul = mul * scale
    y = (xf - mu.reshape(shape)) * mul.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y.to(dtype), new_mean, new_var


class FlaxBatchNorm2d(nn.Module):
    """BatchNorm with flax's statistics (see :func:`flax_batch_norm`);
    ``affine=False`` (flax's ``use_scale=use_bias=False``) keeps the
    statistics and no scale or bias."""

    def __init__(self, channels, dtype=torch.float32, momentum=BN_MOMENTUM,
                 eps=BN_EPS, affine=True):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.weight = self.bias = None
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        y, m, v = flax_batch_norm(x, self.weight, self.bias,
                                  self.running_mean, self.running_var,
                                  self.training, self.dtype,
                                  self.momentum, self.eps)
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(m)
                self.running_var.copy_(v)
        return y


def _conv(ci, co, k, stride, padding):
    return nn.Conv2d(ci, co, k, stride=stride, padding=padding, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, ci, filters, stride=1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(ci, filters, 3, stride, 1)
        self.bn1 = FlaxBatchNorm2d(filters, dtype)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = FlaxBatchNorm2d(filters, dtype)
        self.downsample = None
        if stride != 1 or ci != filters:
            self.downsample = nn.Sequential(
                _conv(ci, filters, 1, stride, 0),
                FlaxBatchNorm2d(filters, dtype))

    def forward(self, x):
        dt = self.dtype
        y = F.relu(self.bn1(conv2d(self.conv1, x, dt)))
        y = self.bn2(conv2d(self.conv2, y, dt))
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](conv2d(self.downsample[0], x, dt))
        return F.relu(y + residual)


class CifarResNet(nn.Module):
    """6n+2 CIFAR ResNet, channels 16/32/64; ``depth`` in {20, 32, 44,
    56, 110}."""

    def __init__(self, depth=56, num_classes=10, dtype=torch.float32):
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError("depth must be 6n+2")
        self.depth, self.num_classes, self.dtype = depth, num_classes, dtype
        n = (depth - 2) // 6
        self.conv1 = _conv(3, 16, 3, 1, 1)
        self.bn1 = FlaxBatchNorm2d(16, dtype)
        ci = 16
        for stage, (filters, stride) in enumerate([(16, 1), (32, 2),
                                                   (64, 2)]):
            blocks = []
            for b in range(n):
                blocks.append(BasicBlock(ci, filters,
                                         stride if b == 0 else 1, dtype))
                ci = filters
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(64, num_classes)

    def forward(self, x, train=False):
        """``x [B, H, W, 3]`` (NHWC) -> fp32 logits ``[B, classes]``;
        ``train`` uses batch statistics and updates the running ones."""
        self.train(train)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = conv2d(self.conv1, x, self.dtype)
        x = F.relu(self.bn1(x))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = x.mean(dim=(2, 3))
        return F.linear(fp32_or_wider(x), self.fc.weight, self.fc.bias)


def resnet56(class_num=10, dtype=torch.float32):
    return CifarResNet(depth=56, num_classes=class_num, dtype=dtype)


def resnet110(class_num=10, dtype=torch.float32):
    return CifarResNet(depth=110, num_classes=class_num, dtype=dtype)


__all__ = ["CifarResNet", "BasicBlock", "FlaxBatchNorm2d", "flax_batch_norm",
           "resnet56", "resnet110"]
