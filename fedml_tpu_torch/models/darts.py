"""The DARTS search space of FedNAS (counterpart of
``fedml_tpu/models/darts.py``): the primitive ops, the search network
with its architecture weights, genotype derivation and the fixed
network a genotype builds.

- The architecture weights are two buffers, ``alphas_normal`` and
  ``alphas_reduce`` (``[n_edges, len(PRIMITIVES)]``), which the state
  keeps as its own collection ``"arch"`` beside ``"params"`` and
  ``"batch_stats"`` (``algorithms/specs.py`` hands them to the module
  with its parameters), so weights and alphas stay separable and FedNAS
  averages both.
- A ``MixedOp`` runs every primitive and sums ``w * o`` in
  ``PRIMITIVES`` order; a ``SearchCell`` sums its edges in order.
- Strided convolutions and pools pad as flax's ``"SAME"`` does
  (``models/layers.py`` ``same_pad``): (0, 1) for a 3x3 stride-2 window
  over an even side; dilated kernels by their effective size; max pools
  pad with ``-inf``; average pools divide by the in-bounds count.
- The search network's ops convolve through ``models/layers.py``
  ``conv2d_twice``, whose double backward the second-order search step
  runs; the fixed network's, and both stems, through ``F.conv2d``.
- BatchNorm has flax's statistics (``models/resnet.py``
  ``FlaxBatchNorm2d``); the ops' norms carry no scale or bias
  (``affine=False``).
- Submodules carry flax's names (``stem``, ``stem_bn``,
  ``cell{i}.pre0.Conv_0``, ``cell{i}.edge{k}.sep_conv_3x3.dw0``,
  ``cell{i}.node{j}_edge{e}_{op}``, ``classifier``), so
  ``utils/torch_import.py`` ``cv_variables_to_state`` carries the
  reference's variables.
- The fixed network's drop path takes per-sample keep masks
  (``draw_dropout_masks``, one per non-skip edge), as the zoo's dropout
  does.

The public forward takes NHWC images and runs NCHW inside, in fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import (MaskedDropout, avg_pool_same,
                                           conv2d_twice, drop_path,
                                           max_pool_same, nchw, same_conv2d)
from fedml_tpu_torch.models.resnet import FlaxBatchNorm2d

F32 = torch.float32

PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)


class Genotype(NamedTuple):
    normal: Sequence[Tuple[str, int]]
    normal_concat: Sequence[int]
    reduce: Sequence[Tuple[str, int]]
    reduce_concat: Sequence[int]


#: the published DARTS (first order) cell pair
DARTS_V1 = Genotype(
    normal=[("sep_conv_3x3", 1), ("sep_conv_3x3", 0), ("skip_connect", 0),
            ("sep_conv_3x3", 1), ("skip_connect", 0), ("sep_conv_3x3", 1),
            ("sep_conv_3x3", 0), ("skip_connect", 2)],
    normal_concat=[2, 3, 4, 5],
    reduce=[("max_pool_3x3", 0), ("max_pool_3x3", 1), ("skip_connect", 2),
            ("max_pool_3x3", 0), ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("avg_pool_3x3", 0)],
    reduce_concat=[2, 3, 4, 5])


def _conv(ci, co, k, stride=1, dilation=1, groups=1):
    return nn.Conv2d(ci, co, k, stride=stride, dilation=dilation,
                     groups=groups, bias=False)


def _bn(C):
    return FlaxBatchNorm2d(C, affine=False)


class _ConvOp(nn.Module):
    """An op whose convolutions run ``self.conv`` (``F.conv2d``'s
    signature): ``F.conv2d``, or ``models/layers.py`` ``conv2d_twice``
    inside :class:`DARTSNetwork`, whose second-order step differentiates
    through every weight gradient. ``conv2d_twice`` has no ``vmap``
    rule: a generated one made the fixed network's round over stacked
    clients 3 times slower on the H100."""

    conv = staticmethod(F.conv2d)


class ReLUConvBN(_ConvOp):
    def __init__(self, C_in, C_out, kernel=1, stride=1):
        super().__init__()
        self.Conv_0 = _conv(C_in, C_out, kernel, stride)
        self.BatchNorm_0 = _bn(C_out)

    def forward(self, x):
        return self.BatchNorm_0(same_conv2d(self.Conv_0, F.relu(x), F32,
                                            self.conv))


class FactorizedReduce(_ConvOp):
    """Stride-2 reduction through two 1x1 convolutions, the second offset
    by one pixel, concatenated (keeps every pixel)."""

    def __init__(self, C_in, C_out):
        super().__init__()
        self.Conv_0 = _conv(C_in, C_out // 2, 1, 2)
        self.Conv_1 = _conv(C_in, C_out - C_out // 2, 1, 2)
        self.BatchNorm_0 = _bn(C_out)

    def forward(self, x):
        x = F.relu(x)
        a = self.conv(x, self.Conv_0.weight, None, 2)
        b = self.conv(x[:, :, 1:, 1:], self.Conv_1.weight, None, 2)
        # pad b back to a's sides (odd inputs)
        b = F.pad(b, (0, a.shape[3] - b.shape[3], 0, a.shape[2] - b.shape[2]))
        return self.BatchNorm_0(torch.cat([a, b], dim=1))


class SepConv(_ConvOp):
    """Two stacked depthwise-separable convolutions."""

    def __init__(self, C_in, C_out, kernel, stride):
        super().__init__()
        for i, (s, co) in enumerate([(stride, C_in), (1, C_out)]):
            setattr(self, f"dw{i}", _conv(C_in, C_in, kernel, s,
                                          groups=C_in))
            setattr(self, f"pw{i}", _conv(C_in, co, 1))
            setattr(self, f"bn{i}", _bn(co))

    def forward(self, x):
        for i in range(2):
            x = same_conv2d(getattr(self, f"dw{i}"), F.relu(x), F32,
                            self.conv)
            x = getattr(self, f"bn{i}")(
                self.conv(x, getattr(self, f"pw{i}").weight))
        return x


class DilConv(_ConvOp):
    def __init__(self, C_in, C_out, kernel, stride, dilation=2):
        super().__init__()
        self.Conv_0 = _conv(C_in, C_in, kernel, stride, dilation,
                            groups=C_in)
        self.Conv_1 = _conv(C_in, C_out, 1)
        self.BatchNorm_0 = _bn(C_out)

    def forward(self, x):
        x = same_conv2d(self.Conv_0, F.relu(x), F32, self.conv)
        return self.BatchNorm_0(self.conv(x, self.Conv_1.weight))


class PoolOp(nn.Module):
    def __init__(self, kind, stride, C):
        super().__init__()
        self.kind, self.stride = kind, stride
        self.BatchNorm_0 = _bn(C)

    def forward(self, x):
        pool = max_pool_same if self.kind == "max" else avg_pool_same
        return self.BatchNorm_0(pool(x, 3, self.stride))


class ZeroOp(nn.Module):
    def __init__(self, stride):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        if self.stride == 1:
            return torch.zeros_like(x)
        return torch.zeros_like(x[:, :, ::self.stride, ::self.stride])


class SkipOp(nn.Module):
    def __init__(self, C_in, C_out, stride):
        super().__init__()
        self.FactorizedReduce_0 = (FactorizedReduce(C_in, C_out)
                                   if stride != 1 else None)

    def forward(self, x):
        if self.FactorizedReduce_0 is None:
            return x
        return self.FactorizedReduce_0(x)


def make_op(primitive, C, stride):
    """The primitive op over ``C`` channels at ``stride``."""
    if primitive == "none":
        return ZeroOp(stride)
    if primitive == "max_pool_3x3":
        return PoolOp("max", stride, C)
    if primitive == "avg_pool_3x3":
        return PoolOp("avg", stride, C)
    if primitive == "skip_connect":
        return SkipOp(C, C, stride)
    if primitive == "sep_conv_3x3":
        return SepConv(C, C, 3, stride)
    if primitive == "sep_conv_5x5":
        return SepConv(C, C, 5, stride)
    if primitive == "dil_conv_3x3":
        return DilConv(C, C, 3, stride)
    if primitive == "dil_conv_5x5":
        return DilConv(C, C, 5, stride)
    raise ValueError(primitive)


class MixedOp(nn.Module):
    def __init__(self, C, stride):
        super().__init__()
        for p in PRIMITIVES:
            setattr(self, p, make_op(p, C, stride))

    def forward(self, x, weights):
        out = None
        for w, p in zip(weights, PRIMITIVES):
            o = w * getattr(self, p)(x)
            out = o if out is None else out + o
        return out


def _preprocess(C_pp, C_p, C, reduction_prev):
    pre0 = (FactorizedReduce(C_pp, C) if reduction_prev
            else ReLUConvBN(C_pp, C))
    return pre0, ReLUConvBN(C_p, C)


class SearchCell(nn.Module):
    """Two input nodes and ``steps`` intermediate nodes, every edge a
    ``MixedOp``; the output concatenates the intermediate nodes."""

    def __init__(self, C_pp, C_p, C, steps, reduction, reduction_prev):
        super().__init__()
        self.steps = steps
        self.pre0, self.pre1 = _preprocess(C_pp, C_p, C, reduction_prev)
        k = 0
        for i in range(steps):
            for j in range(2 + i):
                stride = 2 if reduction and j < 2 else 1
                setattr(self, f"edge{k}", MixedOp(C, stride))
                k += 1

    def forward(self, s0, s1, weights):
        states = [self.pre0(s0), self.pre1(s1)]
        offset = 0
        for _ in range(self.steps):
            s = None
            for j in range(len(states)):
                h = getattr(self, f"edge{offset + j}")(states[j],
                                                       weights[offset + j])
                s = h if s is None else s + h
            states.append(s)
            offset += len(states) - 1
        return torch.cat(states[-self.steps:], dim=1)


def n_edges(steps):
    return sum(2 + i for i in range(steps))


def _reductions(layers):
    return (layers // 3, 2 * layers // 3) if layers >= 3 else ()


class DARTSNetwork(nn.Module):
    """The search network: a 3x3 stem, ``layers`` search cells (the ones
    at a third and two thirds reduce and double the width), global
    average pooling and the classifier. ``alphas_normal`` and
    ``alphas_reduce`` are buffers the state carries as ``"arch"``; the
    forward softmaxes them."""

    arch_names = ("alphas_normal", "alphas_reduce")

    def __init__(self, C=16, layers=8, num_classes=10, steps=4,
                 stem_multiplier=3, in_channels=3):
        super().__init__()
        self.C, self.layers, self.steps = C, layers, steps
        self.num_classes = num_classes
        k = n_edges(steps)
        self.register_buffer("alphas_normal",
                             torch.zeros(k, len(PRIMITIVES)))
        self.register_buffer("alphas_reduce",
                             torch.zeros(k, len(PRIMITIVES)))
        C_curr = stem_multiplier * C
        self.stem = nn.Conv2d(in_channels, C_curr, 3, padding=1, bias=False)
        self.stem_bn = FlaxBatchNorm2d(C_curr)
        C_pp = C_p = C_curr
        C_curr = C
        reduction_prev = False
        for i in range(layers):
            reduction = i in _reductions(layers)
            if reduction:
                C_curr *= 2
            setattr(self, f"cell{i}", SearchCell(C_pp, C_p, C_curr, steps,
                                                 reduction, reduction_prev))
            C_pp, C_p = C_p, steps * C_curr
            reduction_prev = reduction
        self.classifier = nn.Linear(C_p, num_classes)
        for m in self.modules():
            if isinstance(m, _ConvOp):
                m.conv = conv2d_twice

    def init_arch_(self, generator):
        """The reference's ``normal(1e-3)`` draw of both alphas."""
        with torch.no_grad():
            for name in self.arch_names:
                a = getattr(self, name)
                a.copy_(torch.randn(a.shape, generator=generator) * 1e-3)
        return self

    def forward(self, x, train=False):
        """``x [B, H, W, C]`` -> fp32 logits; ``train`` uses batch
        statistics and updates the running ones."""
        self.train(train)
        w_normal = torch.softmax(self.alphas_normal, dim=-1)
        w_reduce = torch.softmax(self.alphas_reduce, dim=-1)
        s0 = s1 = self.stem_bn(F.conv2d(nchw(x, F32), self.stem.weight,
                                        None, 1, 1))
        for i in range(self.layers):
            w = w_reduce if i in _reductions(self.layers) else w_normal
            s0, s1 = s1, getattr(self, f"cell{i}")(s0, s1, w)
        return self.classifier(s1.mean(dim=(2, 3)))


def _softmax_np(a):
    a = np.asarray(a, np.float32)
    e = np.exp(a - a.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _steps_from_edges(k):
    steps, total = 0, 0
    while total < k:
        total += 2 + steps
        steps += 1
    assert total == k, f"invalid edge count {k}"
    return steps


def derive_genotype(arch):
    """Alphas -> Genotype on the host in numpy: each node keeps its two
    strongest incoming edges (ranked by ``argsort`` of the negated
    strongest non-``none`` weight), each with its best non-``none``
    primitive. ``arch`` holds arrays or tensors."""
    def parse(alphas):
        if isinstance(alphas, torch.Tensor):
            alphas = alphas.detach().cpu().numpy()
        w = _softmax_np(alphas)
        gene, start = [], 0
        steps = _steps_from_edges(w.shape[0])
        none_idx = PRIMITIVES.index("none")
        for i in range(steps):
            n_in = 2 + i
            rows = w[start:start + n_in]
            strength = np.max(np.delete(rows, none_idx, axis=1), axis=1)
            for j in np.argsort(-strength)[:2]:
                ops = rows[j].copy()
                ops[none_idx] = -1
                gene.append((PRIMITIVES[int(np.argmax(ops))], int(j)))
            start += n_in
        concat = list(range(2, 2 + steps))
        return gene, concat[-4:] if steps >= 4 else concat

    normal, n_cat = parse(arch["alphas_normal"])
    reduce, r_cat = parse(arch["alphas_reduce"])
    return Genotype(normal=normal, normal_concat=n_cat,
                    reduce=reduce, reduce_concat=r_cat)


class FixedCell(nn.Module):
    """A discrete cell from a genotype; drop path on its non-skip edges
    from the keep masks ``{"node{i}_edge{e}": [B]}``."""

    def __init__(self, C_pp, C_p, C, genotype, reduction, reduction_prev,
                 drop_path_prob=0.0):
        super().__init__()
        self.pre0, self.pre1 = _preprocess(C_pp, C_p, C, reduction_prev)
        self.gene = genotype.reduce if reduction else genotype.normal
        self.concat = list(genotype.reduce_concat if reduction
                           else genotype.normal_concat)
        self.drop_path_prob = drop_path_prob
        for i in range(len(self.gene) // 2):
            for e in range(2):
                op_name, j = self.gene[2 * i + e]
                stride = 2 if reduction and j < 2 else 1
                setattr(self, f"node{i}_edge{e}_{op_name}",
                        make_op(op_name, C, stride))

    def drop_edges(self):
        """The edges drop path acts on, as mask names."""
        return [f"node{i}_edge{e}"
                for i in range(len(self.gene) // 2) for e in range(2)
                if self.gene[2 * i + e][0] != "skip_connect"]

    def forward(self, s0, s1, masks=None):
        states = [self.pre0(s0), self.pre1(s1)]
        for i in range(len(self.gene) // 2):
            outs = []
            for e in range(2):
                op_name, j = self.gene[2 * i + e]
                h = getattr(self, f"node{i}_edge{e}_{op_name}")(states[j])
                if masks is not None and f"node{i}_edge{e}" in masks:
                    h = drop_path(h, masks[f"node{i}_edge{e}"],
                                  self.drop_path_prob)
                outs.append(h)
            states.append(outs[0] + outs[1])
        return torch.cat([states[i] for i in self.concat], dim=1)


class DARTSFixedNetwork(MaskedDropout, nn.Module):
    """The network a genotype builds (the train stage): the search
    network's layout with fixed cells, widths ``len(concat) * C``. With
    ``drop_path_prob`` > 0, training takes keep masks
    ``{"cell{i}.node{j}_edge{e}": [B]}`` (``draw_dropout_masks``)."""

    def __init__(self, genotype=DARTS_V1, C=36, layers=8, num_classes=10,
                 stem_multiplier=3, drop_path_prob=0.0, in_channels=3):
        super().__init__()
        self.layers, self.num_classes = layers, num_classes
        C_curr = stem_multiplier * C
        self.stem = nn.Conv2d(in_channels, C_curr, 3, padding=1, bias=False)
        self.stem_bn = FlaxBatchNorm2d(C_curr)
        C_pp = C_p = C_curr
        C_curr = C
        reduction_prev = False
        specs = {}
        for i in range(layers):
            reduction = i in _reductions(layers)
            if reduction:
                C_curr *= 2
            cell = FixedCell(C_pp, C_p, C_curr, genotype, reduction,
                             reduction_prev, drop_path_prob)
            setattr(self, f"cell{i}", cell)
            if drop_path_prob > 0:
                specs.update({f"cell{i}.{e}": ((), drop_path_prob)
                              for e in cell.drop_edges()})
            C_pp, C_p = C_p, len(cell.concat) * C_curr
            reduction_prev = reduction
        self._mask_specs = specs
        self.classifier = nn.Linear(C_p, num_classes)

    def forward(self, x, train=False, dropout_masks=None):
        self.train(train)
        masks = self._masks_for(train, dropout_masks)
        s0 = s1 = self.stem_bn(F.conv2d(nchw(x, F32), self.stem.weight,
                                        None, 1, 1))
        for i in range(self.layers):
            cell_masks = None
            if masks is not None:
                pre = f"cell{i}."
                cell_masks = {k[len(pre):]: v for k, v in masks.items()
                              if k.startswith(pre)}
            s0, s1 = s1, getattr(self, f"cell{i}")(s0, s1, cell_masks)
        return self.classifier(s1.mean(dim=(2, 3)))


__all__ = ["PRIMITIVES", "Genotype", "DARTS_V1", "ReLUConvBN",
           "FactorizedReduce", "SepConv", "DilConv", "PoolOp", "ZeroOp",
           "SkipOp", "make_op", "MixedOp", "SearchCell", "n_edges",
           "DARTSNetwork", "derive_genotype", "FixedCell",
           "DARTSFixedNetwork"]
