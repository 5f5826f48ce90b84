"""The split ResNets of FedGKT (counterpart of
``fedml_tpu/models/gkt.py``): the client's small edge model (a stem and
16-channel ``BasicBlock``s with a local classification head that also
hands out its feature maps: ``resnet5_56``, ``resnet8_56``) and the
server's large model over those features (the 32- and 64-channel stages
of ResNet-56: ``resnet56_server``).

Built on the port's CIFAR ResNet ``BasicBlock`` with flax's BatchNorm
statistics (``models/resnet.py``); submodules carry flax's names
(``conv1``, ``bn1``, ``block{b}``, ``layer{2,3}_block{b}``, ``fc``), the
shortcuts the port's ``downsample.{0,1}`` (``utils/torch_import.py``
``gkt_variables_to_state`` renames them). The features cross between
the two as NHWC ``[B, H, W, 16]``, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import conv2d, nchw
from fedml_tpu_torch.models.resnet import BasicBlock, FlaxBatchNorm2d


class GKTClientResNet(nn.Module):
    """Edge model: stem + ``n_blocks`` 16-channel blocks. ``forward``
    returns ``(features [B, H, W, 16], logits [B, classes])``, the two
    payloads a client uploads."""

    def __init__(self, n_blocks=1, num_classes=10, in_channels=3,
                 dtype=torch.float32):
        super().__init__()
        self.n_blocks, self.num_classes, self.dtype = (n_blocks,
                                                       num_classes, dtype)
        self.conv1 = nn.Conv2d(in_channels, 16, 3, padding=1, bias=False)
        self.bn1 = FlaxBatchNorm2d(16, dtype)
        for b in range(n_blocks):
            setattr(self, f"block{b}", BasicBlock(16, 16, 1, dtype))
        self.fc = nn.Linear(16, num_classes)

    def forward(self, x, train=False):
        self.train(train)
        x = F.relu(self.bn1(conv2d(self.conv1, nchw(x, self.dtype),
                                   self.dtype)))
        for b in range(self.n_blocks):
            x = getattr(self, f"block{b}")(x)
        logits = F.linear(x.mean(dim=(2, 3)).float(), self.fc.weight,
                          self.fc.bias)
        return x.permute(0, 2, 3, 1), logits


class GKTServerResNet(nn.Module):
    """Server model over the client features: ``n`` blocks a stage at 32
    and 64 channels (``n`` 9 is ResNet-56's tail)."""

    def __init__(self, n=9, num_classes=10, in_channels=16,
                 dtype=torch.float32):
        super().__init__()
        self.n, self.num_classes, self.dtype = n, num_classes, dtype
        ci = in_channels
        for stage, (filters, stride) in enumerate([(32, 2), (64, 2)]):
            for b in range(n):
                setattr(self, f"layer{stage + 2}_block{b}",
                        BasicBlock(ci, filters, stride if b == 0 else 1,
                                   dtype))
                ci = filters
        self.fc = nn.Linear(64, num_classes)

    def forward(self, features, train=False):
        self.train(train)
        x = nchw(features, self.dtype)
        for stage in (2, 3):
            for b in range(self.n):
                x = getattr(self, f"layer{stage}_block{b}")(x)
        return F.linear(x.mean(dim=(2, 3)).float(), self.fc.weight,
                        self.fc.bias)


def resnet5_56(class_num=10, **kw):
    return GKTClientResNet(n_blocks=1, num_classes=class_num, **kw)


def resnet8_56(class_num=10, **kw):
    return GKTClientResNet(n_blocks=2, num_classes=class_num, **kw)


def resnet56_server(class_num=10, **kw):
    return GKTServerResNet(n=9, num_classes=class_num, **kw)


__all__ = ["GKTClientResNet", "GKTServerResNet", "resnet5_56",
           "resnet8_56", "resnet56_server"]
