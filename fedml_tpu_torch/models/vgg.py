"""VGG 11/13/16/19 with optional BatchNorm (counterpart of
``fedml_tpu/models/vgg.py``): torchvision's configs A/B/D/E, a classifier
of ``classifier_dims`` with dropout 0.5, and a head.

Submodules carry flax's names (``conv{i}``, ``bn{i}``, ``fc{i}``,
``head``). The features are flattened in flax's (H, W, C) order, so
``fc0``'s input rows are the reference's; ``fc0`` is sized from the
input's spatial size. Dropout takes keep masks (``draw_dropout_masks``,
keys ``fc{i}``). Compute runs in ``dtype`` with fp32 parameters,
BatchNorm statistics and logits; the public forward takes NHWC images.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import (MaskedDropout, conv2d, dense,
                                           flatten_hwc, hwc, nchw)
from fedml_tpu_torch.models.resnet import FlaxBatchNorm2d

_CFGS = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "D": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"),
    "E": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"),
}


class VGG(MaskedDropout, nn.Module):
    def __init__(self, cfg="A", batch_norm=False, num_classes=10,
                 classifier_dims=(4096, 4096), dropout_rate=0.5,
                 input_shape=(32, 32, 3), dtype=torch.float32):
        super().__init__()
        self.cfg, self.batch_norm, self.dtype = cfg, batch_norm, dtype
        H, W, ci = hwc(input_shape)
        conv_i = 0
        for v in _CFGS[cfg]:
            if v == "M":
                H, W = H // 2, W // 2
                continue
            setattr(self, f"conv{conv_i}", nn.Conv2d(ci, v, 3, padding=1))
            if batch_norm:
                setattr(self, f"bn{conv_i}", FlaxBatchNorm2d(v, dtype))
            ci, conv_i = v, conv_i + 1
        fan_in = H * W * ci
        self.n_fc = len(classifier_dims)
        for i, h in enumerate(classifier_dims):
            setattr(self, f"fc{i}", nn.Linear(fan_in, h))
            fan_in = h
        self.head = nn.Linear(fan_in, num_classes)
        self._mask_specs = ({f"fc{i}": ((h,), dropout_rate)
                             for i, h in enumerate(classifier_dims)}
                            if dropout_rate > 0 else {})

    def forward(self, x, train=False, dropout_masks=None):
        """``x [B, H, W, C]`` -> fp32 logits; ``train`` uses batch
        statistics, updates the running ones and applies the given keep
        masks (training without them raises when the model has
        dropout)."""
        masks = self._masks_for(train, dropout_masks)
        self.train(train)
        dt = self.dtype
        x = nchw(x, dt)
        conv_i = 0
        for v in _CFGS[self.cfg]:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = conv2d(getattr(self, f"conv{conv_i}"), x, dt)
            if self.batch_norm:
                x = getattr(self, f"bn{conv_i}")(x)
            x = F.relu(x)
            conv_i += 1
        x = flatten_hwc(x)
        for i in range(self.n_fc):
            x = F.relu(dense(getattr(self, f"fc{i}"), x, dt))
            x = self._dropout(x, masks, f"fc{i}")
        return F.linear(x.float(), self.head.weight, self.head.bias)


def vgg11(class_num=10, batch_norm=False, **kw):
    return VGG(cfg="A", batch_norm=batch_norm, num_classes=class_num, **kw)


def vgg13(class_num=10, batch_norm=False, **kw):
    return VGG(cfg="B", batch_norm=batch_norm, num_classes=class_num, **kw)


def vgg16(class_num=10, batch_norm=False, **kw):
    return VGG(cfg="D", batch_norm=batch_norm, num_classes=class_num, **kw)


def vgg19(class_num=10, batch_norm=False, **kw):
    return VGG(cfg="E", batch_norm=batch_norm, num_classes=class_num, **kw)


__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]
