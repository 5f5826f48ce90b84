"""Shared layers and initialisers of the port's model zoo (counterpart of
``fedml_tpu/models/layers.py``): flax's default initialisers,
per-sample stochastic depth from a given keep mask, flax's ``"SAME"``
padding for convolutions and pools, and GroupNorm with flax's
statistics."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

GN_EPS = 1e-5


def lecun_init_(model, generator):
    """The reference's flax defaults, drawn from ``generator``: lecun-normal
    (fan-in variance, truncated at two standard deviations) for conv and
    dense kernels, zero biases. Other parameters and buffers keep their
    constructor values (BatchNorm scale 1, bias 0, running mean 0, var
    1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                std = math.sqrt(1.0 / (w[0].numel())) / .87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
    return model


def nchw(x, dtype):
    """NHWC images (``[B, H, W]`` gets a channel axis) -> NCHW in
    ``dtype``."""
    if x.dim() == 3:
        x = x[..., None]
    return x.to(dtype).permute(0, 3, 1, 2)


def hwc(input_shape):
    """One sample's shape as ``(H, W, C)`` (C 1 for ``(H, W)``)."""
    shape = tuple(int(d) for d in input_shape)
    return shape if len(shape) == 3 else shape + (1,)


def conv2d(conv, x, dtype):
    """``conv`` (an ``nn.Conv2d`` holding fp32 parameters) applied in
    ``dtype``, as flax's ``Conv(dtype=...)`` casts its kernel."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x, conv.weight.to(dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def dense(lin, x, dtype):
    """``lin`` (an ``nn.Linear`` holding fp32 parameters) applied in
    ``dtype``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def flatten_hwc(x):
    """``[B, C, H, W] -> [B, H*W*C]`` in flax's (H, W, C) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def same_padding(n, kernel, stride, dilation=1):
    """``(low, high)`` padding of one side of ``n`` pixels under flax's
    ``"SAME"``: ``ceil(n / stride)`` outputs, the kernel's effective
    size ``dilation * (kernel - 1) + 1``, the odd pixel at the end."""
    eff = dilation * (kernel - 1) + 1
    out = math.ceil(n / stride)
    total = max((out - 1) * stride + eff - n, 0)
    return total // 2, total - total // 2


def same_pad(x, kernel, stride, dilation=1, value=0.0):
    """Pad NCHW ``x`` as flax's ``"SAME"`` does (:func:`same_padding`):
    (0, 1) for a 3x3 stride-2 window over an even side, not
    ``padding=1``. ``value`` fills the pad (``-inf`` for a max pool)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad lists the last axis first
        pads += list(same_padding(n, kernel, stride, dilation))
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


def same_conv2d(conv, x, dtype, fn=None):
    """``conv`` (an ``nn.Conv2d`` built with ``padding=0``) applied in
    ``dtype`` over flax's ``"SAME"`` padding of ``x``: a symmetric pad
    goes to the convolution itself, an uneven one to :func:`same_pad`.
    ``fn`` is the convolution (``F.conv2d``'s signature; default it)."""
    fn = fn or F.conv2d
    k, s, d = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
    (top, bottom), (left, right) = (same_padding(x.shape[2], k, s, d),
                                    same_padding(x.shape[3], k, s, d))
    bias = None if conv.bias is None else conv.bias.to(dtype)
    w = conv.weight.to(dtype)
    if top == bottom and left == right:
        return fn(x, w, bias, s, (top, left), d, conv.groups)
    return fn(F.pad(x, (left, right, top, bottom)), w, bias, s, 0, d,
              conv.groups)


def _pair(v):
    return list(v) if isinstance(v, (tuple, list)) else [v, v]


class _Conv(torch.autograd.Function):
    """``y = conv(x, w)`` whose backward is :class:`_ConvGrad`, itself
    differentiable."""

    @staticmethod
    def forward(x, w, stride, padding, dilation, groups):
        return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, *conf = inputs
        ctx.save_for_backward(x, w)
        ctx.conf = conf

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw = _ConvGrad.apply(gy, x, w, *ctx.conf)
        return gx, gw, None, None, None, None


class _ConvGrad(torch.autograd.Function):
    """``(gx, gw)`` of ``y = conv(x, w)`` at the output gradient ``gy``,
    by ``convolution_backward``. Its own backward is written in the
    convolution and its two gradients again (for incoming ``a`` on
    ``gx`` and ``b`` on ``gw``: ``conv(a, w) + conv(x, b)`` on ``gy``,
    the weight gradient of ``(a, gy)`` on ``w`` and the input gradient
    of ``(gy, b)`` on ``x``), where autograd's own double backward
    computes the weight gradient as a convolution whose kernel is a
    whole image."""

    @staticmethod
    def forward(gy, x, w, stride, padding, dilation, groups):
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy, x, w, None, _pair(stride), _pair(padding), _pair(dilation),
            False, [0, 0], groups, [True, True, False])
        return gx, gw

    @staticmethod
    def setup_context(ctx, inputs, output):
        gy, x, w, *conf = inputs
        ctx.save_for_backward(gy, x, w)
        ctx.conf = conf

    @staticmethod
    def backward(ctx, a, b):
        gy, x, w = ctx.saved_tensors
        conf = ctx.conf
        g_gy = g_x = g_w = None
        if a is not None:
            g_gy = _Conv.apply(a, w, *conf)
            g_w = _ConvGrad.apply(gy, a, w, *conf)[1]
        if b is not None:
            t = _Conv.apply(x, b, *conf)
            g_gy = t if g_gy is None else g_gy + t
            g_x = _ConvGrad.apply(gy, x, b, *conf)[0]
        return g_gy, g_x, g_w, None, None, None, None


def conv2d_twice(x, w, bias=None, stride=1, padding=0, dilation=1,
                 groups=1):
    """``F.conv2d`` with a hand-written double backward in
    ``convolution_backward``'s own products (:class:`_ConvGrad`): the
    second-order DARTS step differentiates through every weight gradient,
    and autograd's formula for that runs each as a convolution with an
    image-sized kernel (on the card, cuDNN's slow indexed implicit GEMM).
    Same values; not for ``torch.func.vmap``."""
    y = _Conv.apply(x, w, stride, padding, dilation, groups)
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def max_pool_same(x, window, stride):
    """flax ``nn.max_pool(padding="SAME")`` over NCHW ``x``: the pad is
    ``-inf``, so it is never the maximum."""
    return F.max_pool2d(same_pad(x, window, stride, value=float("-inf")),
                        window, stride)


def avg_pool_same(x, window, stride):
    """flax ``nn.avg_pool(padding="SAME", count_include_pad=False)`` over
    NCHW ``x``: each window's sum over the in-bounds pixels divided by
    their count, also where the pad is uneven."""
    total = F.avg_pool2d(same_pad(x, window, stride), window, stride,
                         divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[-2:]), dtype=x.dtype,
                      device=x.device)
    count = F.avg_pool2d(same_pad(ones, window, stride), window, stride,
                         divisor_override=1)
    return total / count


def drop_path(x, keep_mask, rate):
    """Per-sample stochastic depth: each sample's whole branch ``x`` kept
    where ``keep_mask [B]`` is 1 and zeroed where it is 0, survivors
    rescaled by ``1 / (1 - rate)``. The reference draws the mask inside
    (``jax.random.bernoulli``); here the caller hands it in, drawn from
    an explicit generator (:func:`draw_keep`)."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return x * keep_mask.reshape(shape).to(x.dtype) / keep


def draw_keep(shape, rate, generator):
    """A 0/1 float keep mask of ``shape``, each entry kept with
    probability ``1 - rate``, drawn from ``generator`` on its device."""
    return (torch.rand(shape, generator=generator, device=generator.device)
            < 1.0 - rate).float()


def flax_group_norm(x, scale, bias, group_size, dtype, eps=GN_EPS):
    """GroupNorm of ``x`` (NCHW) with ``group_size`` channels a group, flax
    semantics: statistics in fp32 over (H, W, the group's channels), the
    fast variance ``max(0, E[x^2] - E[x]^2)``, then ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in fp32, cast to ``dtype``."""
    B, C = x.shape[0], x.shape[1]
    xf = x.float()
    g = xf.reshape(B, C // group_size, group_size, -1)
    mu = g.mean(dim=(2, 3))
    mu2 = (g * g).mean(dim=(2, 3))
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    shape = (B, C) + (1,) * (x.dim() - 2)
    mu = mu.repeat_interleave(group_size, dim=1).reshape(shape)
    var = var.repeat_interleave(group_size, dim=1).reshape(shape)
    cshape = (1, C) + (1,) * (x.dim() - 2)
    y = ((xf - mu) * (torch.rsqrt(var + eps) * scale.reshape(cshape))
         + bias.reshape(cshape))
    return y.to(dtype)


class MaskedDropout:
    """Dropout from explicit keep masks, for an ``nn.Module`` whose
    ``_mask_specs`` is ``{name: (shape of one sample, rate)}``.

    The model draws no randomness of its own: training takes the masks
    :meth:`draw_dropout_masks` draws from an explicit generator, so K
    clients train at once under ``torch.func.vmap`` with each client's
    masks from its own seed (``algorithms/specs.py``). ``CNNDropOut``,
    VGG, EfficientNet and MobileNetV3 drop out so. A model with no mask
    to draw (every rate 0) has no ``draw_dropout_masks`` at all and
    trains without masks."""

    _mask_specs: dict = {}

    @property
    def draw_dropout_masks(self):
        if not self._mask_specs:
            raise AttributeError(f"{type(self).__name__} without dropout "
                                 "draws no masks")
        return self._draw_dropout_masks

    def _draw_dropout_masks(self, n, generator):
        """Keep masks (0/1 floats) for ``n`` samples on the generator's
        device, one for each entry of ``_mask_specs`` in its order."""
        return {name: draw_keep((n,) + tuple(shape), rate, generator)
                for name, (shape, rate) in self._mask_specs.items()}

    def _masks_for(self, train, dropout_masks):
        """The masks a forward applies: None in evaluation and for a
        model without dropout; training without them raises."""
        if not (train and self._mask_specs):
            return None
        if dropout_masks is None:
            raise ValueError(f"{type(self).__name__} trains with explicit "
                             "dropout masks (draw_dropout_masks)")
        return dropout_masks

    def _dropout(self, x, masks, name):
        """``x`` with the keep mask ``name`` applied (kept activations
        scaled by ``1 / keep``, flax's dropout), or ``x`` itself."""
        if masks is None or name not in masks:
            return x
        keep = 1.0 - self._mask_specs[name][1]
        return x * masks[name].to(x.dtype) / keep


class FlaxGroupNorm2d(nn.Module):
    """GroupNorm with ``group_size`` channels a group (flax's
    ``nn.GroupNorm(num_groups=None, group_size=...)``, not a number of
    groups) and flax's statistics (:func:`flax_group_norm`). Stateless:
    training and evaluation compute the same function."""

    def __init__(self, channels, group_size, dtype=torch.float32,
                 eps=GN_EPS):
        super().__init__()
        if channels % group_size:
            raise ValueError(f"Number of channels ({channels}) is not "
                             f"multiple of the group size ({group_size}).")
        self.group_size, self.dtype, self.eps = group_size, dtype, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return flax_group_norm(x, self.weight, self.bias, self.group_size,
                               self.dtype, self.eps)


__all__ = ["lecun_init_", "nchw", "hwc", "conv2d", "dense", "flatten_hwc",
           "same_padding", "same_pad", "same_conv2d", "conv2d_twice",
           "max_pool_same", "avg_pool_same", "drop_path", "draw_keep",
           "MaskedDropout", "flax_group_norm", "FlaxGroupNorm2d"]
