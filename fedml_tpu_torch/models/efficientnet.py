"""EfficientNet b0-b7 (counterpart of ``fedml_tpu/models/efficientnet.py``):
MBConv blocks (1x1 expand, depthwise, squeeze-excite, 1x1 project) on
the b0 stages, compound width and depth scaling (``round_filters``,
``round_repeats``), swish, BatchNorm at momentum 0.99 and eps 1e-3.

Submodules carry flax's names (``stem``, ``bn_stem``,
``block{s}_{r}.{expand,bn0,dw,bn1,se_reduce,se_expand,project,bn2}``,
``head``, ``bn_head``, ``fc``). Dropout draws no randomness of its own:
training takes keep masks (``draw_dropout_masks``): ``head`` before
``fc`` at the b-variant's rate, and a per-sample drop-connect mask for
each residual block whose rate ``drop_connect_rate * idx / total`` is
above 0, keyed by the block's name. Compute runs in ``dtype`` with fp32
parameters, BatchNorm statistics and logits; the public forward takes
NHWC images.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import (MaskedDropout, conv2d, dense,
                                           drop_path, nchw)
from fedml_tpu_torch.models.mobilenet_v3 import _make_divisible
from fedml_tpu_torch.models.resnet import FlaxBatchNorm2d

BN_MOMENTUM, BN_EPS = 0.99, 1e-3


class BlockArgs(NamedTuple):
    """One MBConv stage."""
    kernel: int
    strides: int
    expand_ratio: int
    in_filters: int
    out_filters: int
    num_repeat: int
    se_ratio: float = 0.25


# EfficientNet-B0 baseline stages
_B0_BLOCKS: Sequence[BlockArgs] = [
    BlockArgs(3, 1, 1, 32, 16, 1),
    BlockArgs(3, 2, 6, 16, 24, 2),
    BlockArgs(5, 2, 6, 24, 40, 2),
    BlockArgs(3, 2, 6, 40, 80, 3),
    BlockArgs(5, 1, 6, 80, 112, 3),
    BlockArgs(5, 2, 6, 112, 192, 4),
    BlockArgs(3, 1, 6, 192, 320, 1),
]

# name -> (width_coef, depth_coef, dropout)
_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 0.2),
    "efficientnet-b1": (1.0, 1.1, 0.2),
    "efficientnet-b2": (1.1, 1.2, 0.3),
    "efficientnet-b3": (1.2, 1.4, 0.3),
    "efficientnet-b4": (1.4, 1.8, 0.4),
    "efficientnet-b5": (1.6, 2.2, 0.4),
    "efficientnet-b6": (1.8, 2.6, 0.5),
    "efficientnet-b7": (2.0, 3.1, 0.5),
}


def round_filters(filters: int, width_coef: float, divisor: int = 8) -> int:
    """Width scaling, MobileNetV3's channel rounding."""
    return _make_divisible(filters * width_coef, divisor)


def round_repeats(repeats: int, depth_coef: float) -> int:
    """Depth scaling (ceil)."""
    return int(-(-depth_coef * repeats // 1))


def _bn(channels, dtype):
    return FlaxBatchNorm2d(channels, dtype, momentum=BN_MOMENTUM, eps=BN_EPS)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with SE; the SE width is
    ``max(1, int(in_ch * se_ratio))`` of the block's input."""

    def __init__(self, ci, kernel, strides, expand_ratio, out_filters,
                 se_ratio, drop_rate=0.0, dtype=torch.float32):
        super().__init__()
        self.dtype, self.drop_rate = dtype, drop_rate
        self.residual = strides == 1 and ci == out_filters
        mid = ci * expand_ratio
        if expand_ratio != 1:
            self.expand = nn.Conv2d(ci, mid, 1, bias=False)
            self.bn0 = _bn(mid, dtype)
        self.dw = nn.Conv2d(mid, mid, kernel, stride=strides,
                            padding=kernel // 2, groups=mid, bias=False)
        self.bn1 = _bn(mid, dtype)
        if se_ratio > 0:
            se_ch = max(1, int(ci * se_ratio))
            self.se_reduce = nn.Linear(mid, se_ch)
            self.se_expand = nn.Linear(se_ch, mid)
        self.project = nn.Conv2d(mid, out_filters, 1, bias=False)
        self.bn2 = _bn(out_filters, dtype)

    def forward(self, x, keep_mask=None):
        """``keep_mask [B]``: the drop-connect mask (training, residual
        blocks with a rate above 0), else None."""
        dt = self.dtype
        y = x
        if hasattr(self, "expand"):
            y = F.silu(self.bn0(conv2d(self.expand, y, dt)))
        y = F.silu(self.bn1(conv2d(self.dw, y, dt)))
        if hasattr(self, "se_reduce"):
            s = F.silu(dense(self.se_reduce, y.mean(dim=(2, 3)), dt))
            s = torch.sigmoid(dense(self.se_expand, s, dt))
            y = y * s[:, :, None, None]
        y = self.bn2(conv2d(self.project, y, dt))
        if self.residual:
            if keep_mask is not None:
                y = drop_path(y, keep_mask, self.drop_rate)
            y = y + x
        return y


class EfficientNet(MaskedDropout, nn.Module):
    """Construct through :func:`efficientnet` (``from_name``)."""

    def __init__(self, num_classes=1000, width_coef=1.0, depth_coef=1.0,
                 dropout_rate=0.2, drop_connect_rate=0.2, in_channels=3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.dropout_rate = dtype, dropout_rate
        ci = round_filters(32, width_coef)
        self.stem = nn.Conv2d(in_channels, ci, 3, stride=2, padding=1,
                              bias=False)
        self.bn_stem = _bn(ci, dtype)
        total = sum(round_repeats(b.num_repeat, depth_coef)
                    for b in _B0_BLOCKS)
        self.blocks, specs, idx = [], {}, 0
        for si, b in enumerate(_B0_BLOCKS):
            out_f = round_filters(b.out_filters, width_coef)
            for r in range(round_repeats(b.num_repeat, depth_coef)):
                # the drop-connect rate grows linearly with depth
                rate = drop_connect_rate * idx / total
                name = f"block{si}_{r}"
                blk = MBConvBlock(ci, b.kernel, b.strides if r == 0 else 1,
                                  b.expand_ratio, out_f, b.se_ratio,
                                  drop_rate=rate, dtype=dtype)
                setattr(self, name, blk)
                self.blocks.append(name)
                if blk.residual and rate > 0:
                    specs[name] = ((), rate)
                ci, idx = out_f, idx + 1
        head = round_filters(1280, width_coef)
        self.head = nn.Conv2d(ci, head, 1, bias=False)
        self.bn_head = _bn(head, dtype)
        self.fc = nn.Linear(head, num_classes)
        if dropout_rate > 0:
            specs["head"] = ((head,), dropout_rate)
        self._mask_specs = specs

    def forward(self, x, train=False, dropout_masks=None):
        """``x [B, H, W, C]`` -> fp32 logits; ``train`` uses batch
        statistics, updates the running ones and applies the given keep
        masks (training without them raises when the model has
        dropout)."""
        masks = self._masks_for(train, dropout_masks)
        self.train(train)
        dt = self.dtype
        x = F.silu(self.bn_stem(conv2d(self.stem, nchw(x, dt), dt)))
        for name in self.blocks:
            x = getattr(self, name)(
                x, None if masks is None else masks.get(name))
        x = F.silu(self.bn_head(conv2d(self.head, x, dt)))
        x = self._dropout(x.mean(dim=(2, 3)), masks, "head")
        return F.linear(x.float(), self.fc.weight, self.fc.bias)


def efficientnet(model_name="efficientnet-b0", num_classes=1000, **kw):
    """``EfficientNet.from_name``: b0-b7 with their width, depth and
    dropout."""
    if model_name not in _PARAMS:
        raise ValueError(
            f"model_name should be one of: {', '.join(sorted(_PARAMS))}")
    w, d, drop = _PARAMS[model_name]
    kw.setdefault("dropout_rate", drop)
    return EfficientNet(num_classes=num_classes, width_coef=w, depth_coef=d,
                        **kw)


__all__ = ["BlockArgs", "MBConvBlock", "EfficientNet", "efficientnet",
           "round_filters", "round_repeats"]
