"""Shared layers and initialisers of the port's model zoo (counterpart of
``fedml_tpu/models/layers.py``): flax's default initialisers,
per-sample stochastic depth from a given keep mask, and GroupNorm with
flax's statistics."""

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
           "drop_path", "draw_keep", "MaskedDropout", "flax_group_norm",
           "FlaxGroupNorm2d"]
