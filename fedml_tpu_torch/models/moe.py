"""Mixture-of-Experts transformer with Switch top-1 routing (counterpart
of ``fedml_tpu/models/moe.py``).

Each token routes to one of ``n_experts`` expert MLPs through a
fixed-capacity one-hot dispatch: a ``[N, E, capacity]`` dispatch/combine
tensor instead of a ragged gather and scatter, so the shapes are static
and the expert products are batched products over the expert axis
(``torch.einsum``; no hand-written kernel, as in the reference, where
they are plain XLA products). Tokens past an expert's capacity are
dropped: their gate value is 0, so the block passes only the residual.
The Switch load-balancing loss is returned beside the output as the
reference sows it, and the task specs add it to the training loss at
``aux_loss_weight`` (``algorithms/specs.py``).

The attention stays the dense model's hand-written flash attention:
:class:`MoETransformerLM` is the :class:`TransformerLM` with each block's
MLP swapped through its ``mlp_factory`` seam. On the client-stacked
``[K, B, T]`` path, capacity, queue order and the aux loss are taken per
client over its flattened ``(b, t)`` tokens in row-major order, as the
reference's per-client application takes them.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.transformer import TransformerLM, _Block, dense


def capacity(n_tokens, n_experts, capacity_factor=1.25):
    """Tokens each expert takes from one client's ``n_tokens``."""
    return max(1, int(capacity_factor * n_tokens / n_experts))


def route(x, router_weight, router_bias, n_experts, capacity_factor=1.25):
    """Top-1 fixed-capacity routing of K clients' tokens ``x [K, N, C]``
    (router in fp32): ``(disp [K, N, E, cap], gate_val [K, N], aux [K],
    expert [K, N], keep [K, N, E])`` -- the one-hot dispatch/combine
    tensor, each token's gate value (0 past capacity), the Switch aux
    loss ``E * sum_e(fraction routed to e * mean gate of e)``, each
    token's route and whether it fit its expert's queue."""
    N, E = x.shape[1], n_experts
    cap = capacity(N, E, capacity_factor)
    gates = torch.softmax(dense(x.float(), router_weight, router_bias,
                                torch.float32), dim=-1)          # [K, N, E]
    expert = gates.argmax(dim=-1)                                # [K, N]
    # one-hots by comparison (F.one_hot checks its range on the host)
    onehot = (expert[..., None]
              == torch.arange(E, device=x.device)).float()       # [K, N, E]
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    slot = (pos.clamp(0, cap - 1)[..., None]
            == torch.arange(cap, device=x.device)).float()
    disp = (onehot * keep)[..., None] * slot                     # [K,N,E,cap]
    gate_val = (gates * onehot * keep).sum(dim=-1)               # [K, N]
    aux = E * (onehot.mean(dim=1) * gates.mean(dim=1)).sum(dim=-1)
    return disp, gate_val, aux, expert, keep


def experts(xin, wi, wo, dtype):
    """The expert MLPs over their token buffers ``xin [K, E, cap, C]``:
    ``gelu(xin wi) wo`` in ``dtype``."""
    h = F.gelu(torch.einsum("kecd,kedh->kech", xin, wi.to(dtype)),
               approximate="tanh")
    return torch.einsum("kech,kehd->kecd", h, wo.to(dtype))


def moe_mlp(x, router_weight, router_bias, wi, wo, capacity_factor=1.25,
            dtype=torch.float32):
    """Top-1 routed expert MLP over K clients' tokens ``x [K, N, C]``
    with per-client ``router_weight [K, E, C]``, ``router_bias [K, E]``,
    ``wi [K, E, C, H]`` and ``wo [K, E, H, C]``. The router runs in fp32,
    the experts in ``dtype``. Returns ``(y [K, N, C] in x's dtype, aux
    [K], expert [K, N], keep [K, N])``: the Switch aux loss (:func:`route`)
    and each token's route and whether it fit its expert's capacity."""
    disp, gate_val, aux, expert, keep = route(
        x, router_weight, router_bias, wi.shape[1], capacity_factor)
    d = disp.to(dtype)
    xin = torch.einsum("knec,knd->kecd", d, x.to(dtype))         # [K,E,cap,C]
    out = experts(xin, wi, wo, dtype)
    y = torch.einsum("knec,kecd->knd", d, out) * gate_val[..., None].to(dtype)
    return y.to(x.dtype), aux, expert, keep.any(dim=-1)


class MoEMLP(nn.Module):
    """Parameter holder of a top-1 routed expert MLP over flattened
    tokens (applied by :meth:`apply_params`): ``router`` (a Dense ``[E,
    C]`` with bias), ``wi [E, C, H]`` and ``wo [E, H, C]`` (stacked on
    the expert axis, einsum parameters, not Dense kernels)."""

    def __init__(self, d_model, n_experts=8, mlp_ratio=4,
                 capacity_factor=1.25):
        super().__init__()
        C, E, H = d_model, n_experts, mlp_ratio * d_model
        self.n_experts, self.capacity_factor = n_experts, capacity_factor
        self.router = nn.Linear(C, E)
        self.wi = nn.Parameter(torch.empty(E, C, H))
        self.wo = nn.Parameter(torch.empty(E, H, C))

    def reset_parameters_(self, generator):
        """``wi``/``wo`` from flax's lecun-normal over their whole shape:
        fan-in ``E*C`` and ``E*H`` (the leading axes are receptive
        field), truncated at two standard deviations. The router is a
        Dense and takes the model's Dense initialiser."""
        for w in (self.wi, self.wo):
            fan_in = w.shape[0] * w.shape[1]
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    def apply_params(self, params, x, dtype=torch.float32, stacked=True):
        """``(y, aux)`` of tokens ``x [K, N, C]`` under client-stacked
        ``params`` (``router.weight``, ``router.bias``, ``wi``, ``wo``);
        with ``stacked=False``, one client's ``x [N, C]`` and
        parameters."""
        if not stacked:
            params = {k: v.unsqueeze(0) for k, v in params.items()}
            x = x.unsqueeze(0)
        y, aux, _, _ = moe_mlp(x, params["router.weight"],
                               params["router.bias"], params["wi"],
                               params["wo"], self.capacity_factor, dtype)
        return (y, aux) if stacked else (y[0], aux[0])


def MoEBlock(d_model, n_experts=8, mlp_ratio=4, capacity_factor=1.25):
    """A transformer block with its MLP replaced by :class:`MoEMLP`: the
    dense block through its ``mlp_factory`` seam (one attention
    implementation)."""
    return _Block(d_model, mlp_ratio,
                  mlp_factory=partial(MoEMLP, d_model, n_experts, mlp_ratio,
                                      capacity_factor))


class MoETransformerLM(TransformerLM):
    """Causal LM with MoE blocks: the surface of :class:`TransformerLM`
    (token ids ``[B, T]`` -> logits ``[B, T, vocab]``);
    ``apply_params(with_sown=True)`` also returns the summed aux loss."""

    sows_losses = True

    def __init__(self, vocab_size, n_layers=4, n_heads=4, d_model=256,
                 max_len=2048, n_experts=8, mlp_ratio=4,
                 capacity_factor=1.25, dtype: Any = torch.float32,
                 attention_fn: Optional[Callable] = None):
        super().__init__(vocab_size, n_layers=n_layers, n_heads=n_heads,
                         d_model=d_model, max_len=max_len,
                         mlp_ratio=mlp_ratio, dtype=dtype,
                         attention_fn=attention_fn,
                         mlp_factory=partial(MoEMLP, d_model, n_experts,
                                             mlp_ratio, capacity_factor))
        self.n_experts, self.capacity_factor = n_experts, capacity_factor


__all__ = ["capacity", "route", "experts", "moe_mlp", "MoEMLP", "MoEBlock", "MoETransformerLM"]
