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


def _same(x):
    return x


def apply_block(x, get, n_heads, dtype, attend, enter=_same, leave=_same,
                moe=None):
    """One pre-LN block over ``x [K, B, T, C]``: ``get(name)`` gives the
    block's client-stacked parameter (``"qkv.weight"``, ...), ``attend(q,
    k, v)`` the attention over ``[K*B, T, H, D]``. ``moe(h [K, B*T, C])
    -> (y, aux)`` replaces the dense MLP. Returns ``(x, aux or None)``.

    The seams of tensor parallelism: ``enter`` wraps the input of the
    column-parallel products (``qkv``, ``mlp_up``) and ``leave`` the
    output of the row-parallel ones (``proj``, ``mlp_down``, whose bias is
    added after it). A ``qkv`` weight of fewer than ``3C`` rows holds a
    rank's heads: its q, k and v thirds are that many heads' rows."""
    K, B, T, C = x.shape
    D = C // n_heads
    h = layer_norm(x, get("ln1.weight"), get("ln1.bias"), dtype)
    qkv = dense(enter(h), get("qkv.weight"), None, dtype)
    Cl = qkv.shape[-1] // 3
    q, k, v = (qkv[..., j * Cl:(j + 1) * Cl].reshape(K * B, T, Cl // D, D)
               for j in range(3))
    att = attend(q, k, v).reshape(K, B, T, Cl)
    x = x + leave(dense(att, get("proj.weight"), None, dtype))
    h = layer_norm(x, get("ln2.weight"), get("ln2.bias"), dtype)
    if moe is not None:
        y, aux = moe(h.reshape(K, B * T, C))
        return x + y.reshape(K, B, T, C), aux
    h = F.gelu(dense(enter(h), get("mlp_up.weight"), get("mlp_up.bias"),
                     dtype), approximate="tanh")
    y = leave(dense(h, get("mlp_down.weight"), None, dtype))
    return x + (y + _bc(get("mlp_down.bias").to(dtype), y)), None


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

    def embed_tokens(self, params, idx, pos_offset=0):
        """Token plus position embeddings of ``idx [K, B, T]`` under
        client-stacked ``params``, in the compute dtype."""
        T = idx.shape[-1]
        return (embed(params["tok_embed.weight"], idx, self.dtype)
                + params["pos_embed.weight"][
                    :, None, pos_offset:pos_offset + T].to(self.dtype))

    def head_logits(self, params, x):
        """The final LayerNorm and the fp32 head over ``x [K, B, T, C]``."""
        x = layer_norm(x, params["ln_f.weight"], params["ln_f.bias"],
                       self.dtype)
        return dense(x.float(), params["head.weight"], params["head.bias"],
                     torch.float32)

    def _block_moe(self, params, i):
        """Block ``i``'s MLP replacement as ``fn(h [K, N, C]) -> (y,
        aux)`` over client-stacked ``params``, or None for a dense
        block."""
        moe = self.blocks[i].moe
        if moe is None:
            return None
        prefix = f"blocks.{i}.moe."
        sub = {k[len(prefix):]: v for k, v in params.items()
               if k.startswith(prefix)}
        # one client's [B*T, C] tokens route together
        return lambda h: moe.apply_params(sub, h, self.dtype)

    def apply_blocks(self, params, x, n_blocks=None, get=None, moe_for=None,
                     enter=_same, leave=_same):
        """The blocks over ``x [K, B, T, C]`` under client-stacked
        ``params``: ``(x, aux [K])``, the sown auxiliary losses summed.

        The seams of the sharded steps: ``get(params, i, name)`` gives
        block ``i``'s parameter (default ``params["blocks.{i}.{name}"]``),
        ``moe_for(params, i)`` its MLP replacement (default the model's
        own), ``n_blocks`` how many blocks run (default all), and
        ``enter``/``leave`` the tensor-parallel seams of
        :func:`apply_block`."""
        get = get or (lambda P, i, name: P[f"blocks.{i}.{name}"])
        moe_for = moe_for or self._block_moe
        aux = torch.zeros(x.shape[0], device=x.device)
        for i in range(self.n_layers if n_blocks is None else n_blocks):
            x, a = apply_block(x, lambda name, i=i: get(params, i, name),
                               self.n_heads, self.dtype, self._attend,
                               enter, leave, moe=moe_for(params, i))
            if a is not None:
                aux = aux + a
        return x, aux

    def apply_params(self, params, idx, stacked=False, with_sown=False,
                     pos_offset=0, get=None, moe_for=None, enter=_same,
                     leave=_same):
        """Logits of ``idx`` under ``params`` (``{name: tensor}``). With
        ``stacked=True`` every parameter has a leading client axis K and
        ``idx`` is ``[K, B, T]``; the logits are then ``[K, B, T, V]``.
        ``with_sown=True`` returns ``(logits, aux)``: the blocks' sown
        auxiliary losses summed per client (``[K]``, or a scalar).
        ``pos_offset`` is the absolute position of ``idx``'s first token
        (a sequence shard's start under sequence parallelism); ``get``,
        ``moe_for``, ``enter`` and ``leave`` are :meth:`apply_blocks`'s
        seams."""
        if not stacked:
            params = {k: v.unsqueeze(0) for k, v in params.items()}
            idx = idx.unsqueeze(0)
        x = self.embed_tokens(params, idx, pos_offset)
        x, aux = self.apply_blocks(params, x, get=get, moe_for=moe_for,
                                   enter=enter, leave=leave)
        logits = self.head_logits(params, x)
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
           "dense", "embed", "apply_block"]
