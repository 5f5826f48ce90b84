"""DeepLab-v3+-style semantic segmentation (counterpart of
``fedml_tpu/models/deeplab.py``): a dilated residual-free encoder whose
``output_stride`` (16 or 8) decides where striding stops and dilation
takes over, an ASPP pyramid (a 1x1 branch, 3x3 branches at rates 6, 12
and 18, and global pooling), and a decoder that upsamples to the
encoder's 1/4 skip, fuses and refines; the logits are upsampled to the
input size.

- ``backbone="resnet"`` is width 32, ``"mobilenet"`` width 16.
- Every convolution pads as flax's ``"SAME"`` (``models/layers.py``
  ``same_conv2d``): a stride-2 3x3 over an even side pads (0, 1).
- BatchNorm has flax's statistics (``models/resnet.py``), also the
  global-pool branch's over ``[B, C, 1, 1]``.
- The reference's ``jax.image.resize(..., "bilinear")`` only upsamples
  here, which is ``F.interpolate(mode="bilinear", align_corners=False,
  antialias=False)``, edges included.
- Submodules carry flax's automatic names (``_Backbone_0._ConvBlock_2.
  Conv_0``, ``ASPP_0._ConvBlock_4.BatchNorm_0``, ``Conv_0``), so
  ``utils/torch_import.py`` ``cv_variables_to_state`` carries the
  reference's variables.

The public forward takes NHWC images and returns NHWC fp32 logits
``[B, H, W, classes]``; compute runs in ``dtype`` with fp32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import nchw, same_conv2d
from fedml_tpu_torch.models.resnet import FlaxBatchNorm2d


def bilinear(x, hw):
    """NCHW ``x`` resized to ``hw`` as ``jax.image.resize(...,
    "bilinear")`` upsamples (half-pixel centres, edges clamped)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=False)


class _ConvBlock(nn.Module):
    """Conv (``"SAME"``, no bias) -> BatchNorm -> ReLU."""

    def __init__(self, ci, features, kernel=3, strides=1, dilation=1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(ci, features, kernel, stride=strides,
                                dilation=dilation, bias=False)
        self.BatchNorm_0 = FlaxBatchNorm2d(features, dtype)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(same_conv2d(self.Conv_0, x,
                                                   self.dtype)))


class _Backbone(nn.Module):
    def __init__(self, ci=3, width=32, output_stride=16,
                 dtype=torch.float32):
        super().__init__()
        if output_stride not in (8, 16):
            raise ValueError(f"output_stride {output_stride}: 8 or 16")
        w = width
        blocks = [(ci, w, 2, 1), (w, 2 * w, 2, 1), (2 * w, 4 * w, 2, 1)]
        if output_stride == 16:
            blocks += [(4 * w, 8 * w, 2, 1), (8 * w, 8 * w, 1, 2)]
        else:
            blocks += [(4 * w, 8 * w, 1, 2), (8 * w, 8 * w, 1, 4)]
        for i, (a, b, s, d) in enumerate(blocks):
            setattr(self, f"_ConvBlock_{i}",
                    _ConvBlock(a, b, strides=s, dilation=d, dtype=dtype))

    def forward(self, x):
        x = self._ConvBlock_0(x)             # /2
        low = self._ConvBlock_1(x)           # /4 (the skip)
        x = self._ConvBlock_2(low)           # /8
        x = self._ConvBlock_4(self._ConvBlock_3(x))
        return x, low


class ASPP(nn.Module):
    def __init__(self, ci, features=128, rates=(6, 12, 18),
                 dtype=torch.float32):
        super().__init__()
        self.n_rates = len(rates)
        self._ConvBlock_0 = _ConvBlock(ci, features, kernel=1, dtype=dtype)
        for i, r in enumerate(rates):
            setattr(self, f"_ConvBlock_{i + 1}",
                    _ConvBlock(ci, features, dilation=r, dtype=dtype))
        n = len(rates) + 1
        setattr(self, f"_ConvBlock_{n}",
                _ConvBlock(ci, features, kernel=1, dtype=dtype))
        setattr(self, f"_ConvBlock_{n + 1}",
                _ConvBlock(features * (n + 1), features, kernel=1,
                           dtype=dtype))

    def forward(self, x):
        n = self.n_rates + 1
        branches = [getattr(self, f"_ConvBlock_{i}")(x) for i in range(n)]
        gp = getattr(self, f"_ConvBlock_{n}")(x.mean(dim=(2, 3),
                                                      keepdim=True))
        branches.append(gp.expand_as(branches[0]))
        return getattr(self, f"_ConvBlock_{n + 1}")(torch.cat(branches,
                                                              dim=1))


class DeepLab(nn.Module):
    """Encoder + ASPP + decoder with the 1/4 skip; logits upsampled to
    the input size."""

    def __init__(self, num_classes=21, backbone="resnet", output_stride=16,
                 in_channels=3, dtype=torch.float32):
        super().__init__()
        if backbone not in ("resnet", "mobilenet"):
            raise ValueError(f"backbone {backbone!r}: resnet or mobilenet")
        self.num_classes, self.dtype = num_classes, dtype
        width = 32 if backbone == "resnet" else 16
        self._Backbone_0 = _Backbone(in_channels, width, output_stride,
                                     dtype)
        self.ASPP_0 = ASPP(8 * width, features=4 * width, dtype=dtype)
        self._ConvBlock_0 = _ConvBlock(2 * width, width, kernel=1,
                                       dtype=dtype)
        self._ConvBlock_1 = _ConvBlock(5 * width, 4 * width, dtype=dtype)
        self.Conv_0 = nn.Conv2d(4 * width, num_classes, 1)

    def forward(self, x, train=False):
        """``x [B, H, W, C]`` -> fp32 logits ``[B, H, W, classes]``;
        ``train`` uses batch statistics and updates the running ones."""
        self.train(train)
        hw = x.shape[1:3]
        feats, low = self._Backbone_0(nchw(x, self.dtype))
        feats = bilinear(self.ASPP_0(feats), low.shape[2:])
        low = self._ConvBlock_0(low)
        feats = self._ConvBlock_1(torch.cat([feats, low], dim=1))
        logits = F.conv2d(feats.float(), self.Conv_0.weight,
                          self.Conv_0.bias)
        return bilinear(logits, hw).permute(0, 2, 3, 1)


__all__ = ["DeepLab", "ASPP", "bilinear"]
