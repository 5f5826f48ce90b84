"""MobileNetV3 LARGE and SMALL (counterpart of
``fedml_tpu/models/mobilenet_v3.py``): the paper's bottleneck tables,
``h_swish``/``h_sigmoid``, squeeze-excite with an h-sigmoid gate, the
channel rounding of ``_make_divisible`` and a 1280-wide head that does
not scale with ``multiplier``.

Submodules carry flax's names (``stem``, ``bn_stem``,
``bneck{i}.{expand,bn1,dw,bn2,se.fc1,se.fc2,project,bn3}``,
``head_conv``, ``bn_head``, ``head_fc``, ``classifier``). With
``dropout_rate`` above 0 the head's dropout takes an explicit keep mask
(``draw_dropout_masks``, key ``head_fc``); at 0 there is no dropout at
all. Compute runs in ``dtype`` with fp32 parameters, BatchNorm
statistics and logits; the public forward takes NHWC images.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import MaskedDropout, conv2d, dense, nchw
from fedml_tpu_torch.models.resnet import FlaxBatchNorm2d


def h_sigmoid(x):
    """relu6(x + 3) / 6."""
    return F.relu6(x + 3.0) / 6.0


def h_swish(x):
    """x * h_sigmoid(x)."""
    return x * h_sigmoid(x)


def _make_divisible(v, divisor=8, min_value=None):
    """Channel rounding to a multiple of ``divisor``, never below 90% of
    ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcite(nn.Module):
    """SE block with an h-sigmoid gate (``divide`` 4)."""

    def __init__(self, channels, divide=4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(channels, channels // divide)
        self.fc2 = nn.Linear(channels // divide, channels)

    def forward(self, x):
        s = x.mean(dim=(2, 3))
        s = F.relu(dense(self.fc1, s, self.dtype))
        s = h_sigmoid(dense(self.fc2, s, self.dtype))
        return x * s[:, :, None, None]


class _Bneck(nn.Module):
    """Inverted-residual bottleneck; the expand conv exists only where
    ``exp_size != in_ch``."""

    def __init__(self, ci, kernel, exp_size, out_channels, use_se, use_hs,
                 stride, dtype):
        super().__init__()
        self.dtype, self.use_hs = dtype, use_hs
        self.residual = stride == 1 and ci == out_channels
        if exp_size != ci:
            self.expand = nn.Conv2d(ci, exp_size, 1, bias=False)
            self.bn1 = FlaxBatchNorm2d(exp_size, dtype)
        self.dw = nn.Conv2d(exp_size, exp_size, kernel, stride=stride,
                            padding=kernel // 2, groups=exp_size,
                            bias=False)
        self.bn2 = FlaxBatchNorm2d(exp_size, dtype)
        if use_se:
            self.se = SqueezeExcite(exp_size, dtype=dtype)
        self.project = nn.Conv2d(exp_size, out_channels, 1, bias=False)
        self.bn3 = FlaxBatchNorm2d(out_channels, dtype)

    def forward(self, x):
        act = h_swish if self.use_hs else F.relu
        dt = self.dtype
        y = x
        if hasattr(self, "expand"):
            y = act(self.bn1(conv2d(self.expand, y, dt)))
        y = act(self.bn2(conv2d(self.dw, y, dt)))
        if hasattr(self, "se"):
            y = self.se(y)
        y = self.bn3(conv2d(self.project, y, dt))
        return y + x if self.residual else y


# (kernel, exp_size, out, SE, h-swish, stride): the paper's Tables 1 and 2
_LARGE: Sequence[Tuple[int, int, int, bool, bool, int]] = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
_SMALL: Sequence[Tuple[int, int, int, bool, bool, int]] = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]

HEAD_WIDTH = 1280


class MobileNetV3(MaskedDropout, nn.Module):
    def __init__(self, model_mode="LARGE", num_classes=1000, multiplier=1.0,
                 dropout_rate=0.0, in_channels=3, dtype=torch.float32):
        super().__init__()
        mode = model_mode.upper()
        if mode not in ("LARGE", "SMALL"):
            raise ValueError(f"model_mode must be LARGE or SMALL, got "
                             f"{model_mode!r}")
        self.dtype, self.dropout_rate = dtype, dropout_rate
        cfg = _LARGE if mode == "LARGE" else _SMALL
        last_exp = 960 if mode == "LARGE" else 576
        ci = _make_divisible(16 * multiplier)
        self.stem = nn.Conv2d(in_channels, ci, 3, stride=2, padding=1,
                              bias=False)
        self.bn_stem = FlaxBatchNorm2d(ci, dtype)
        self.n_bneck = len(cfg)
        for i, (k, e, c, se, hs, s) in enumerate(cfg):
            out = _make_divisible(c * multiplier)
            setattr(self, f"bneck{i}",
                    _Bneck(ci, k, _make_divisible(e * multiplier), out, se,
                           hs, s, dtype))
            ci = out
        head = _make_divisible(last_exp * multiplier)
        self.head_conv = nn.Conv2d(ci, head, 1, bias=False)
        self.bn_head = FlaxBatchNorm2d(head, dtype)
        self.head_fc = nn.Linear(head, HEAD_WIDTH)
        self.classifier = nn.Linear(HEAD_WIDTH, num_classes)
        self._mask_specs = ({"head_fc": ((HEAD_WIDTH,), dropout_rate)}
                            if dropout_rate > 0 else {})

    def forward(self, x, train=False, dropout_masks=None):
        """``x [B, H, W, C]`` -> fp32 logits; ``train`` uses batch
        statistics, updates the running ones and applies the given keep
        masks (training without them raises when the model has
        dropout)."""
        masks = self._masks_for(train, dropout_masks)
        self.train(train)
        dt = self.dtype
        x = h_swish(self.bn_stem(conv2d(self.stem, nchw(x, dt), dt)))
        for i in range(self.n_bneck):
            x = getattr(self, f"bneck{i}")(x)
        x = h_swish(self.bn_head(conv2d(self.head_conv, x, dt)))
        x = h_swish(dense(self.head_fc, x.mean(dim=(2, 3)), dt))
        x = self._dropout(x, masks, "head_fc")
        return F.linear(x.float(), self.classifier.weight,
                        self.classifier.bias)


__all__ = ["MobileNetV3", "SqueezeExcite", "h_sigmoid", "h_swish",
           "_make_divisible"]
