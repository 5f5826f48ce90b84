"""SplitNN experiment main (counterpart of
``fedml_tpu/experiments/main_splitnn.py``; the reference's ``split_nn``:
the model cut into a client half that gives activations and a server
half that gives logits, exchanged every batch --
``split_nn/client_manager.py:35-70``, ``server.py:40-60``), on the card:

    python -m fedml_tpu_torch.experiments.main_splitnn \
        --dataset synthetic_images --cut conv
    python -m fedml_tpu_torch.experiments.main_splitnn --platform cpu ...

The default pair is a conv stem (client) and a dense head (server) for
images; ``--cut dense`` uses a dense stem over flat features. The
modules carry flax's auto names (``Conv_0``, ``Dense_1``), so
``utils/torch_import.py`` ``cv_variables_to_state`` carries the
reference's weights. ``main(argv)`` returns ``(api, server_params)``.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.experiments import common
from fedml_tpu_torch.models.layers import hwc, nchw


def same_pad(x, kernel, stride):
    """Pad NCHW ``x`` as flax's ``"SAME"`` does: ``ceil(n / stride)``
    outputs a side, the odd pixel of padding at the end -- (0, 1) for a
    3x3 stride-2 conv over an even side, not ``padding=1``."""
    pads = []
    for n in (x.shape[3], x.shape[2]):   # F.pad lists the last axis first
        out = math.ceil(n / stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvStem(nn.Module):
    """Client half: two 3x3 stride-2 convs with ReLU over NHWC images,
    flattened in NHWC order as the reference flattens."""

    def __init__(self, input_shape, width=32):
        super().__init__()
        c = hwc(input_shape)[2]
        self.Conv_0 = nn.Conv2d(c, width, 3, stride=2)
        self.Conv_1 = nn.Conv2d(width, width * 2, 3, stride=2)

    def forward(self, x):
        x = nchw(x, torch.float32)
        x = F.relu(self.Conv_0(same_pad(x, 3, 2)))
        x = F.relu(self.Conv_1(same_pad(x, 3, 2)))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class DenseStem(nn.Module):
    """Client half over flat features: one dense layer with ReLU."""

    def __init__(self, input_shape, width=64):
        super().__init__()
        self.Dense_0 = nn.Linear(int(np.prod(input_shape)), width)

    def forward(self, x):
        return F.relu(self.Dense_0(x.reshape(x.shape[0], -1).float()))


class DenseHead(nn.Module):
    """Server half: activations -> logits. Flax numbers the outer layer
    of ``Dense(classes)(relu(Dense(width)(acts)))`` first, so ``Dense_0``
    is the output layer and ``Dense_1`` the hidden one."""

    def __init__(self, in_features, classes=10, width=128):
        super().__init__()
        self.Dense_0 = nn.Linear(width, classes)
        self.Dense_1 = nn.Linear(int(in_features), width)

    def forward(self, acts):
        return self.Dense_0(F.relu(self.Dense_1(acts)))


def split_pair(cut, input_shape, classes):
    """The ``--cut`` pair for one sample's ``input_shape``: ``(client
    half, server half)``, the head sized by the stem's output on one
    zero sample."""
    if cut not in ("conv", "dense"):
        raise ValueError(f"unknown --cut {cut!r} (conv | dense)")
    stem = ConvStem(input_shape) if cut == "conv" else DenseStem(input_shape)
    with torch.no_grad():
        acts = stem(torch.zeros((1,) + tuple(input_shape)))
    return stem, DenseHead(acts.shape[1], classes)


def parser():
    p = argparse.ArgumentParser("SplitNN-torch")
    common.add_base_args(p)
    p.add_argument("--cut", type=str, default="conv",
                   choices=["conv", "dense"])
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    common.refuse_unported(args)
    device = common.device_for(args)
    logger = common.setup(args, run_name="SplitNN")
    from fedml_tpu_torch.data.registry import load_dataset
    dataset = load_dataset(args, args.dataset)
    x = np.asarray(common.example_train_data(dataset)["x"])
    stem, head = split_pair(args.cut, x.shape[1:], dataset[7])

    from fedml_tpu_torch.algorithms.splitnn import SplitNNAPI
    api = SplitNNAPI(dataset, stem, head, args, metrics_logger=logger,
                     device=device)
    api.train()
    logger.close()
    return api, api.server_params


if __name__ == "__main__":
    main()
