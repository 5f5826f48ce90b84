"""Attention in plain PyTorch: blockwise online softmax and the
materialising oracle (counterpart of ``fedml_tpu/ops/attention.py``).

Both take and return ``[B, T, H, D]``. They are the oracles of the
hand-written flash-attention kernels (``ops/flash_attention.py``) and
keep the reference's two causal conventions as they are: :func:`mha`
aligns the causal mask to the end (query ``i`` sees keys up to
``i + Tk - Tq``), while :func:`blockwise_attention`, like the kernels,
compares absolute positions (``kpos <= qpos``). Scores and sums run in
fp32 on values of the input type.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _online_step(carry, q, k, v, scale, bias_block):
    """One KV-block update of the online softmax over ``q [B, Tq, H, D]``
    and a key block ``[B, Bk, H, D]``; ``carry`` is ``acc [B, H, Tq, D]``,
    ``row_sum`` and ``row_max [B, H, Tq]``, all fp32."""
    acc, row_sum, row_max = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias_block is not None:
        s = s + bias_block
    new_max = torch.maximum(row_max, s.amax(dim=-1))
    # guard fully masked rows: exp(NEG_INF - NEG_INF) would be exp(0)
    correction = torch.exp(row_max - new_max)
    p = torch.exp(s - new_max[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    new_sum = row_sum * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    new_acc = acc * correction[..., None] + pv
    return new_acc, new_sum, torch.where(new_max <= NEG_INF / 2, row_max,
                                         new_max)


def blockwise_attention(q, k, v, block_size: int = 512, causal: bool = False,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None, q_offset=0,
                        k_offset=0):
    """Attention over ``q/k/v [B, T, H, D]`` scanning KV in blocks.

    ``bias`` (optional) broadcasts against ``[B, H, Tq, Tk]`` (additive,
    before the softmax; ``NEG_INF`` entries mask). ``causal`` masks in
    global positions ``q_offset + i`` against ``k_offset + j``. The
    output equals ``softmax(q k^T * scale + bias) v`` up to fp32
    reassociation."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    nblocks = -(-Tk // block_size)
    pad = nblocks * block_size - Tk
    if bias is not None:
        if bias.dim() > 4:
            raise ValueError(f"bias rank {bias.dim()} > 4")
        bias = bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
        for ax, full in enumerate((B, H, Tq, Tk)):
            if bias.shape[ax] not in (1, full):
                raise ValueError(
                    f"bias axis {ax} is {bias.shape[ax]}, expected 1 or "
                    f"{full} (broadcast against [B, H, Tq, Tk])")
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if bias is not None and bias.shape[3] != 1:
            # padded keys are masked below; 0 keeps the bias finite
            bias = F.pad(bias, (0, pad))
    dev = q.device
    qpos = q_offset + torch.arange(Tq, device=dev)[:, None]
    carry = (torch.zeros((B, H, Tq, D), device=dev),
             torch.zeros((B, H, Tq), device=dev),
             torch.full((B, H, Tq), NEG_INF, device=dev))
    for j in range(nblocks):
        blk = slice(j * block_size, (j + 1) * block_size)
        bias_blk = None
        if bias is not None:
            bias_blk = bias if bias.shape[3] == 1 else bias[..., blk]
        if causal:
            kpos = (k_offset + j * block_size
                    + torch.arange(block_size, device=dev)[None, :])
            cmask = torch.where(kpos <= qpos, 0.0, NEG_INF)
            bias_blk = cmask if bias_blk is None else bias_blk + cmask
        if pad:
            pmask = torch.where(
                torch.arange(j * block_size, (j + 1) * block_size,
                             device=dev) < Tk, 0.0, NEG_INF)
            bias_blk = pmask if bias_blk is None else bias_blk + pmask
        carry = _online_step(carry, q, k[:, blk], v[:, blk], scale, bias_blk)
    acc, row_sum, _ = carry
    out = acc / torch.clamp(row_sum, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def mha(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Plain (materialising) multi-head attention: the oracle the
    blockwise and flash paths are tested against."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Tk - Tq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


__all__ = ["blockwise_attention", "mha", "NEG_INF"]
