"""Decoder-only Transformer LM for federated next-token prediction
(counterpart of ``fedml_tpu/models/transformer.py``).

Token ids ``[B, T]`` in, next-token logits ``[B, T, vocab]`` out, with
the reference's Flax semantics: pre-LN blocks, LayerNorm with eps 1e-6,
the fast variance ``E[x^2] - E[x]^2`` and statistics in fp32, output
cast to the compute dtype; Dense layers (and embeddings) cast their fp32
params to the compute dtype and compute in it; the tanh-approximated
GELU; q, k, v the first, second and third C columns of one bias-free
``qkv`` product; the head an fp32 Dense on the fp32 activations.

Attention is the hand-written flash attention
(:func:`fedml_tpu_torch.ops.flash_attention.flash_attention`, causal)
unless ``attention_fn(q, k, v)`` (all ``[B, T, H, D]``) is given.

``mlp_factory`` swaps each block's dense MLP for an alternative over
one client's flattened ``[B*T, C]`` tokens (the reference's ``_Block``
seam, taken by :mod:`fedml_tpu_torch.models.moe`): the block adds its
output to the residual, and ``apply_params(with_sown=True)`` also
returns the auxiliary losses such MLPs sow, summed over the blocks per
client (0 for the dense model).

The module holds its parameters under torch names (``tok_embed.weight``,
``blocks.{i}.qkv.weight`` ``[3C, C]``, ...; ``utils/torch_import.py``
carries the reference's variables across) and applies them
functionally: :meth:`TransformerLM.apply_params` takes a dict of
parameters, either one model's or K clients' stacked on a leading axis
(then the tokens are ``[K, B, T]``). The client axis is written out:
Dense layers are batched products over it and attention sees ``K*B``
sequences, so one forward and one backward train K clients at once.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.ops.flash_attention import flash_attention

LN_EPS = 1e-6


def _bc(p, x):
    """Per-client ``p [K, C]`` broadcast against ``x [K, ..., C]``."""
    return p.reshape((p.shape[0],) + (1,) * (x.dim() - 2) + (p.shape[-1],))


def layer_norm(x, scale, bias, dtype):
    """Flax ``nn.LayerNorm`` over the last axis of ``x [K, ..., C]`` with
    per-client ``scale``/``bias [K, C]``: fp32 statistics by the fast
    variance (clipped at 0), ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, cast to ``dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * _bc(scale, x)
    return ((xf - mean) * mul + _bc(bias, x)).to(dtype)


def dense(x, weight, bias, dtype):
    """Flax ``nn.Dense`` per client: ``x [K, ..., in]``, ``weight [K, out,
    in]``, ``bias [K, out]`` or None; computes in ``dtype``."""
    K, n_in = x.shape[0], x.shape[-1]
    y = torch.bmm(x.reshape(K, -1, n_in).to(dtype),
                  weight.to(dtype).transpose(1, 2))
    if bias is not None:
        y = y + bias.to(dtype)[:, None, :]
    return y.reshape(x.shape[:-1] + (weight.shape[1],))


def embed(table, idx, dtype):
    """Flax ``nn.Embed`` per client: ``table [K, V, C]`` cast to
    ``dtype``, rows ``idx [K, ...]``."""
    K, V = table.shape[0], table.shape[1]
    offs = (torch.arange(K, device=idx.device) * V).reshape(
        (K,) + (1,) * (idx.dim() - 1))
    return F.embedding(idx.long() + offs, table.to(dtype).reshape(K * V, -1))


class _Block(nn.Module):
    """Parameter holder of one pre-LN block (applied by
    :meth:`TransformerLM.apply_params`). ``mlp_factory()`` builds the
    module that replaces the dense MLP (held as ``moe``); it applies as
    ``moe.apply_params(params, h [K, N, C], dtype) -> (y, aux [K])``."""

    def __init__(self, d_model, mlp_ratio, mlp_factory=None):
        super().__init__()
        C = d_model
        self.ln1 = nn.LayerNorm(C, eps=LN_EPS)
        self.qkv = nn.Linear(C, 3 * C, bias=False)
        self.proj = nn.Linear(C, C, bias=False)
        self.ln2 = nn.LayerNorm(C, eps=LN_EPS)
        if mlp_factory is not None:
            self.moe = mlp_factory()
        else:
            self.moe = None
            self.mlp_up = nn.Linear(C, mlp_ratio * C)
            self.mlp_down = nn.Linear(mlp_ratio * C, C)


class TransformerLM(nn.Module):
    """Causal LM over token ids ``[B, T] -> logits [B, T, vocab]`` (fp32).

    ``dtype`` is the compute dtype (parameters stay fp32).
    ``attention_fn(q, k, v) -> out`` (all ``[B, T, H, D]``) overrides the
    flash-attention kernels; ``mlp_factory`` swaps the blocks' MLP."""

    #: whether ``apply_params(with_sown=True)`` can return a nonzero aux
    sows_losses = False

    def __init__(self, vocab_size, n_layers=4, n_heads=4, d_model=256,
                 max_len=2048, mlp_ratio=4, dtype: Any = torch.float32,
                 attention_fn: Optional[Callable] = None,
                 mlp_factory: Optional[Callable] = None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} is not a multiple of "
                             f"n_heads={n_heads}")
        self.vocab_size, self.n_layers, self.n_heads = (vocab_size, n_layers,
                                                        n_heads)
        self.d_model, self.max_len, self.mlp_ratio = (d_model, max_len,
                                                      mlp_ratio)
        self.dtype, self.attention_fn = dtype, attention_fn
        self.tok_embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_len, d_model)
        self.blocks = nn.ModuleList(_Block(d_model, mlp_ratio, mlp_factory)
                                    for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.head = nn.Linear(d_model, vocab_size)

    def reset_parameters_(self, generator):
        """The reference's initialisers, drawn from ``generator``:
        embeddings normal with variance 1/d_model, Dense kernels
        lecun-normal (fan-in variance, truncated at two standard
        deviations), Dense biases 0, LayerNorm scale 1 and bias 0; a
        block MLP with its own ``reset_parameters_`` draws the rest."""
        with torch.no_grad():
            for m in self.modules():
                if hasattr(m, "reset_parameters_") and m is not self:
                    m.reset_parameters_(generator)
                elif isinstance(m, nn.Embedding):
                    nn.init.normal_(m.weight, 0.0,
                                    1.0 / math.sqrt(m.weight.shape[1]),
                                    generator=generator)
                elif isinstance(m, nn.Linear):
                    std = (math.sqrt(1.0 / m.weight.shape[1])
                           / .87962566103423978)
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                          2 * std, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
        return self

    @property
    def kernel_libraries(self):
        """The kernel libraries this model launches on a card."""
        return () if self.attention_fn is not None else ("flash_attention",)

    def _attend(self, q, k, v):
        if self.attention_fn is not None:
            return self.attention_fn(q, k, v)
        return flash_attention(q, k, v, True)

    def apply_params(self, params, idx, stacked=False, with_sown=False):
        """Logits of ``idx`` under ``params`` (``{name: tensor}``). With
        ``stacked=True`` every parameter has a leading client axis K and
        ``idx`` is ``[K, B, T]``; the logits are then ``[K, B, T, V]``.
        ``with_sown=True`` returns ``(logits, aux)``: the blocks' sown
        auxiliary losses summed per client (``[K]``, or a scalar)."""
        if not stacked:
            params = {k: v.unsqueeze(0) for k, v in params.items()}
            idx = idx.unsqueeze(0)
        P, dt = params, self.dtype
        K, B, T = idx.shape
        C, H = self.d_model, self.n_heads
        D = C // H
        x = (embed(P["tok_embed.weight"], idx, dt)
             + P["pos_embed.weight"][:, None, :T].to(dt))
        aux = torch.zeros(K, device=idx.device)
        for i in range(self.n_layers):
            p = lambda n: P[f"blocks.{i}.{n}"]
            h = layer_norm(x, p("ln1.weight"), p("ln1.bias"), dt)
            qkv = dense(h, p("qkv.weight"), None, dt)
            q, k, v = (qkv[..., j * C:(j + 1) * C].reshape(K * B, T, H, D)
                       for j in range(3))
            att = self._attend(q, k, v).reshape(K, B, T, C)
            x = x + dense(att, p("proj.weight"), None, dt)
            h = layer_norm(x, p("ln2.weight"), p("ln2.bias"), dt)
            moe = self.blocks[i].moe
            if moe is not None:
                # one client's [B*T, C] tokens route together
                prefix = f"blocks.{i}.moe."
                y, a = moe.apply_params(
                    {k[len(prefix):]: v for k, v in P.items()
                     if k.startswith(prefix)}, h.reshape(K, B * T, C), dt)
                x = x + y.reshape(K, B, T, C)
                aux = aux + a
                continue
            h = F.gelu(dense(h, p("mlp_up.weight"), p("mlp_up.bias"), dt),
                       approximate="tanh")
            x = x + dense(h, p("mlp_down.weight"), p("mlp_down.bias"), dt)
        x = layer_norm(x, P["ln_f.weight"], P["ln_f.bias"], dt)
        logits = dense(x.float(), P["head.weight"], P["head.bias"],
                       torch.float32)
        if not stacked:
            logits, aux = logits[0], aux[0]
        return (logits, aux) if with_sown else logits

    def forward(self, idx):
        return self.apply_params(dict(self.named_parameters()), idx)


def lm_loss(logits, tgt):
    """Masked next-token NLL: mean over positions with ``tgt >= 0`` (the
    reference's one LM loss convention)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    mask = (tgt >= 0).float()
    nll = -lp.gather(-1, torch.clamp(tgt, min=0).long()[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def transformer_nwp(vocab_size: int = 10004, **kw):
    """StackOverflow-NWP-shaped config (vocab 10000 + 4 specials)."""
    return TransformerLM(vocab_size=vocab_size, **kw)


__all__ = ["TransformerLM", "transformer_nwp", "lm_loss", "layer_norm",
           "dense", "embed"]
