"""Lane-packed models: L per-lane model replicas in one program with the
lane axis folded into channels (counterpart of
``fedml_tpu/models/lane_packed.py``), for the CIFAR ResNet and the
FedAvg-paper CNN (``CNNOriginalFedAvg``).

Activations live lane-merged as ``[B, L*C, H, W]`` (lane-major
channels). A per-lane conv over merged activations is a grouped conv:

- ``"bgc"``: one ``groups=L`` conv whose weight is the lane-stacked
  kernels, no redundant work;
- ``"blockdiag"``: ``g`` lanes merge per group (``g*Ci`` close to
  :data:`MERGE_K`), each group's weight the block-diagonal embedding of
  its lanes' kernels;
- ``"auto"``: ``bgc`` where ``Ci <= BGC_MAX_CI``, else ``blockdiag``;
- ``"pallas"``: the ``bgc`` forward with the hand-written dW kernel on
  the backward (``ops/grouped_conv.py``).

BatchNorm over merged channels is per-lane BatchNorm; the head is a
per-lane einsum. The CNN (:func:`_make_cnn_apply`) merges lanes the
``blockdiag`` way on both convs, pools the merged channels and runs its
dense layers as per-lane einsums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg
from fedml_tpu_torch.models.layers import fp32_or_wider
from fedml_tpu_torch.models.resnet import CifarResNet, flax_batch_norm
from fedml_tpu_torch.ops.grouped_conv import lane_conv_pallas

#: per-group input width the blockdiag lowering merges lanes up to
MERGE_K = 128
#: ``lowering="auto"`` uses ``bgc`` up to this input width
BGC_MAX_CI = 32
LOWERINGS = ("blockdiag", "bgc", "auto", "pallas")


def lane_merge(x):
    """``[L, B, C, H, W] -> [B, L*C, H, W]`` (lane-major channels)."""
    L, B, C, H, W = x.shape
    return x.transpose(0, 1).reshape(B, L * C, H, W)


def lane_unmerge(x, L):
    """``[B, L*C, H, W] -> [L, B, C, H, W]``."""
    B, LC, H, W = x.shape
    return x.reshape(B, L, LC // L, H, W).transpose(0, 1)


def merged_to_stacked(x, L):
    """``[B, L*C, H, W] -> [L*B, C, H, W]`` (batch-stacked lanes)."""
    B, LC, H, W = x.shape
    return lane_unmerge(x, L).reshape(L * B, LC // L, H, W)


def _lanes_per_group(L, ci, min_k=MERGE_K):
    """Largest divisor ``g`` of ``L`` with ``g*ci`` at most ``min_k`` (at
    least 1): how many lanes merge into one blockdiag group."""
    g = max(1, min(L, min_k // max(ci, 1)))
    while L % g:
        g -= 1
    return g


def lane_conv_bgc(x, w, L, stride=(1, 1), padding=(1, 1)):
    """Per-lane conv as one ``groups=L`` conv: ``x [B, L*Ci, H, W]``,
    ``w [L, Co, Ci, kh, kw]`` -> ``[B, L*Co, H', W']``."""
    return F.conv2d(x, w.reshape((-1,) + w.shape[2:]), stride=stride,
                    padding=padding, groups=L)


def lane_conv(x, w, L, stride=(1, 1), padding=(1, 1), min_k=MERGE_K,
              strategy="blockdiag"):
    """Per-lane conv over merged activations ``x [B, L*Ci, H, W]`` with
    per-lane OIHW kernels ``w [L, Co, Ci, kh, kw]``; returns ``[B, L*Co,
    H', W']``. ``strategy`` is one of ``"blockdiag"``, ``"bgc"`` or
    ``"pallas"`` (see the module docstring)."""
    stride, padding = tuple(stride), tuple(padding)
    if strategy == "pallas":
        return lane_conv_pallas(x, w, L, stride, padding)
    if strategy == "bgc":
        return lane_conv_bgc(x, w, L, stride, padding)
    if strategy != "blockdiag":
        raise ValueError(f"unknown lane conv strategy {strategy!r}")
    _, co, ci, kh, kw = w.shape
    g = _lanes_per_group(L, ci, min_k)
    G = L // g
    wg = w.reshape(G, g, co, ci, kh, kw)
    # wd[j, m, o, l, i] = wg[j, m, o, i] * (l == m): inputs of lane l
    # reach only outputs of lane m == l; every element is one product
    # with 1.0 or 0.0, so the embedding is exact in any dtype
    eye = torch.eye(g, dtype=w.dtype, device=w.device)
    wd = torch.einsum("gmoihw,lm->gmolihw", wg, eye)
    return F.conv2d(x, wd.reshape(G * g * co, g * ci, kh, kw), stride=stride,
                    padding=padding, groups=G)


def lane_bn(x, scale, bias, mean, var, train, dtype):
    """Per-lane BatchNorm on merged activations; ``scale/bias/mean/var``
    are ``[L, C]``. Returns ``(y, new_mean, new_var)`` (flax semantics,
    :func:`fedml_tpu_torch.models.resnet.flax_batch_norm`)."""
    y, m, v = flax_batch_norm(x, scale.reshape(-1), bias.reshape(-1),
                              mean.reshape(-1), var.reshape(-1), train,
                              dtype)
    return y, m.reshape(mean.shape), v.reshape(var.shape)


def make_lane_packed_apply(model, L: int, lowering: str = "blockdiag"):
    """Packed apply for ``L`` lanes of a :data:`PACKED_FAMILIES` model.

    Returns ``apply_fn(stacked_state, x, train) -> (logits, new_stats)``
    where ``stacked_state`` is the port state with every leaf lane-stacked,
    ``x`` is ``[L, B, H, W, C]`` (NHWC, as the reference), ``logits``
    ``[L, B, classes]`` fp32 and ``new_stats`` the lane-stacked running
    statistics (passed through when ``train`` is false; ``{}`` for the
    CNN). ``lowering`` picks the ResNet's conv strategy; the CNN always
    runs ``blockdiag``."""
    if isinstance(model, CNNOriginalFedAvg):
        return _make_cnn_apply(model, L)
    if not isinstance(model, CifarResNet):
        raise TypeError(f"lane-packed apply supports CifarResNet and "
                        f"CNNOriginalFedAvg, got {type(model).__name__}")
    if lowering not in LOWERINGS:
        raise ValueError(f"unknown lane lowering {lowering!r}")
    n = (model.depth - 2) // 6
    dtype = model.dtype

    def apply_fn(stacked_state, x, train=False):
        p, bs = stacked_state["params"], stacked_state["batch_stats"]
        new_bs = {}
        x = lane_merge(x.to(dtype).permute(0, 1, 4, 2, 3))

        def conv(name, xin, stride=1, padding=1):
            w = p[f"{name}.weight"]
            ci = w.shape[2]
            if lowering in ("pallas", "bgc", "blockdiag"):
                strat = lowering
            else:
                strat = "bgc" if ci <= BGC_MAX_CI else "blockdiag"
            return lane_conv(xin, w.to(dtype), L, (stride, stride),
                             (padding, padding), strategy=strat)

        def bn(name, xin):
            y, m, v = lane_bn(xin, p[f"{name}.weight"], p[f"{name}.bias"],
                              bs[f"{name}.running_mean"],
                              bs[f"{name}.running_var"], train, dtype)
            new_bs[f"{name}.running_mean"] = m
            new_bs[f"{name}.running_var"] = v
            return y

        x = F.relu(bn("bn1", conv("conv1", x)))
        for stage, stride in enumerate((1, 2, 2)):
            for block in range(n):
                name = f"layer{stage + 1}.{block}"
                s = stride if block == 0 else 1
                residual = x
                y = F.relu(bn(f"{name}.bn1", conv(f"{name}.conv1", x, s)))
                y = bn(f"{name}.bn2", conv(f"{name}.conv2", y))
                if f"{name}.downsample.0.weight" in p:
                    residual = bn(f"{name}.downsample.1",
                                  conv(f"{name}.downsample.0", x, s, 0))
                x = F.relu(y + residual)
        B = x.shape[0]
        feat = fp32_or_wider(x.mean(dim=(2, 3)).reshape(B, L, -1))
        logits = (torch.einsum("blc,loc->lbo", feat,
                               fp32_or_wider(p["fc.weight"]))
                  + fp32_or_wider(p["fc.bias"][:, None, :]))
        return logits, new_bs

    return apply_fn


def _make_cnn_apply(model, L):
    """Packed apply for :class:`CNNOriginalFedAvg`: the one-channel stem
    merges all lanes into one group (per-group K 25 -> 25L), conv2 merges
    ``MERGE_K // 32 = 4`` lanes; pooling acts per merged channel; the
    dense layers are per-lane einsums over the reference's (H, W, C)
    flatten."""
    dtype = model.dtype

    def apply_fn(stacked_state, x, train=False):
        del train  # no dropout and no batch statistics in this family
        p = stacked_state["params"]
        if x.dim() == 4:  # [L, B, H, W] -> one channel
            x = x[..., None]
        x = lane_merge(x.to(dtype).permute(0, 1, 4, 2, 3))

        def biased_conv(name, xin):
            y = lane_conv(xin, p[f"{name}.weight"].to(dtype), L, (1, 1),
                          (2, 2))
            return y + p[f"{name}.bias"].to(dtype).reshape(1, -1, 1, 1)

        x = F.max_pool2d(biased_conv("conv1", x), 2, 2)
        x = F.max_pool2d(biased_conv("conv2", x), 2, 2)
        x = lane_unmerge(x, L).permute(0, 1, 3, 4, 2)  # [L, B, H, W, C]
        x = x.reshape(x.shape[0], x.shape[1], -1)
        h = torch.einsum("lbi,loi->lbo", x, p["fc1.weight"].to(dtype))
        h = F.relu(h + p["fc1.bias"][:, None, :].to(dtype))
        return (torch.einsum("lbi,loi->lbo", h.float(),
                             p["fc2.weight"].float())
                + p["fc2.bias"][:, None, :].float()), {}

    return apply_fn


def lane_metrics(logits, y, mask):
    """Per-lane masked cross-entropy and sums over ``[L, B]``: returns
    ``(per-lane mean loss [L], {"loss_sum", "correct", "count"} [L])``."""
    logp = torch.log_softmax(fp32_or_wider(logits), dim=-1)
    per_sample = -logp.gather(-1, y.long()[..., None])[..., 0]
    count = mask.sum(dim=1)
    loss_sum = (per_sample * mask).sum(dim=1)
    correct = ((logits.argmax(dim=-1) == y).float() * mask).sum(dim=1)
    return (loss_sum / torch.clamp(count, min=1.0),
            {"loss_sum": loss_sum, "correct": correct, "count": count})


def make_lane_loss_builder(model, lowering="blockdiag"):
    """``lane_loss_builder`` for classification with a packed
    :data:`PACKED_FAMILIES` model: ``builder(L) ->
    lane_loss_fn(stacked_state, batch, rng, train) -> (loss_sum,
    (new_stacked_state, metrics))``.
    ``loss_sum`` is the sum of the per-lane mean losses, whose gradient
    w.r.t. the stacked params is the per-lane gradients. Augmentation
    runs in the engine, before the loss."""

    def builder(L):
        packed_apply = make_lane_packed_apply(model, L, lowering)

        def lane_loss_fn(stacked_state, batch, rng, train):
            del rng  # no packed family draws randomness in its forward
            logits, new_bs = packed_apply(stacked_state, batch["x"], train)
            loss_l, metrics = lane_metrics(logits, batch["y"],
                                           batch["mask"])
            new_state = dict(stacked_state)
            if new_bs:  # the CNN keeps no batch statistics
                new_state["batch_stats"] = new_bs
            return loss_l.sum(), (new_state, metrics)

        return lane_loss_fn

    return builder


#: model families with a lane-packed lowering
PACKED_FAMILIES = (CifarResNet, CNNOriginalFedAvg)


def builder_for(model, lowering=None):
    """The packed ``lane_loss_builder`` for a model, or None when its
    family has no packed lowering. ``lowering`` defaults to
    ``"blockdiag"``, as in the reference; only the ResNet dispatches on
    it."""
    if isinstance(model, PACKED_FAMILIES):
        return make_lane_loss_builder(model, lowering or "blockdiag")
    return None


def lane_kernel_libraries(model, lowering=None):
    """Kernel libraries the packed lowering of ``model`` launches on a
    card: the dW kernel's under the ResNet's ``pallas`` lowering."""
    if isinstance(model, CifarResNet) and lowering == "pallas":
        return ("grouped_conv_dw",)
    return ()


__all__ = ["lane_merge", "lane_unmerge", "merged_to_stacked", "lane_conv",
           "lane_conv_bgc", "lane_bn", "make_lane_packed_apply",
           "make_lane_loss_builder", "builder_for", "lane_kernel_libraries",
           "lane_metrics",
           "MERGE_K", "BGC_MAX_CI", "LOWERINGS", "PACKED_FAMILIES"]
