"""Ring attention: attention with the sequence sharded over a mesh axis
(counterpart of ``fedml_tpu/ops/ring_attention.py``).

Each rank of the ``seq`` group holds the shard ``[B, T/n, H, D]`` of q,
k and v that starts at ``rank * T/n``. Its queries stay put while the
K/V shards travel the ring one hop a step (``batch_isend_irecv`` to the
next rank, from the previous one), and each visiting shard folds into
the online softmax block by block (``ops/attention.py``
``_online_step``), the causal mask comparing absolute positions. After
``n`` steps every rank holds ``softmax(q k^T) v`` for its queries over
the whole sequence. A rank never holds more than its own K/V shard and
the one in flight, so activation memory is ``O(T / n)``.

The ring is a ``torch.autograd.Function``: its forward keeps O and the
row log-sum-exp; its backward sends the K/V shards round the ring again,
each carrying its dK/dV accumulators, to which every rank adds its
queries' contribution, and one last hop returns the accumulators to
their owners. Under ``causal``, a shard from a later rank is wholly
masked for this rank's queries and is passed on without being folded.
There is no kernel here: on the card the products are PyTorch's, as the
reference's ring runs XLA's ``_online_step``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from fedml_tpu_torch.ops.attention import NEG_INF, _online_step
from fedml_tpu_torch.parallel.collectives import ring_peers as _ring_peers
from fedml_tpu_torch.parallel.collectives import rotate as _rotate

SEQ_AXIS = "seq"


def _causal_bias(q_off, Tq, k_off, Tk, device):
    qpos = q_off + torch.arange(Tq, device=device)[:, None]
    kpos = k_off + torch.arange(Tk, device=device)[None, :]
    return torch.where(kpos <= qpos, 0.0, NEG_INF)


def _fold(carry, q, k, v, scale, block, q_off, k_off, causal):
    """One visiting K/V shard folded into the online softmax ``carry``,
    ``block`` keys at a time."""
    Tq, Tk = q.shape[1], k.shape[1]
    for j in range(0, Tk, block):
        kb, vb = k[:, j:j + block], v[:, j:j + block]
        bias = (_causal_bias(q_off, Tq, k_off + j, kb.shape[1], q.device)
                if causal else None)
        carry = _online_step(carry, q, kb, vb, scale, bias)
    return carry


def _unfold(q, k, v, do, lse, delta, scale, block, q_off, k_off, causal):
    """The gradients through one visiting shard: ``(dq, dk, dv)`` fp32,
    the probabilities re-formed from the saved row log-sum-exp."""
    qf, dof = q.float(), do.float()
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    Tq, Tk = q.shape[1], k.shape[1]
    for j in range(0, Tk, block):
        kb, vb = k[:, j:j + block].float(), v[:, j:j + block].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        if causal:
            s = s + _causal_bias(q_off, Tq, k_off + j, kb.shape[1],
                                 q.device)
        p = torch.exp(s - lse[..., None])
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, dof))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale)
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _folds(src, me, causal):
    """Whether this rank's queries see any key of rank ``src``'s shard."""
    return not (causal and src > me)


class RingAttention(torch.autograd.Function):
    """``softmax(q k^T * scale) v`` over a sequence sharded on
    ``group``'s ranks; ``q, k, v [B, T/n, H, D]`` are this rank's
    shards, in rank order along the sequence."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, block):
        n, me, nxt, prv = _ring_peers(group)
        B, Tl, H, D = q.shape
        dev = q.device
        carry = (torch.zeros((B, H, Tl, D), device=dev),
                 torch.zeros((B, H, Tl), device=dev),
                 torch.full((B, H, Tl), NEG_INF, device=dev))
        kv = (k, v)
        for s in range(n):
            src = (me - s) % n
            if _folds(src, me, causal):
                carry = _fold(carry, q, kv[0], kv[1], scale, block,
                              me * Tl, src * Tl, causal)
            if s < n - 1:
                kv = _rotate(kv, group, nxt, prv)
        acc, row_sum, row_max = carry
        row_sum = torch.clamp(row_sum, min=1e-30)
        out = (acc / row_sum[..., None]).permute(0, 2, 1, 3).to(q.dtype)
        lse = row_max + torch.log(row_sum)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, causal, scale, block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale, block = ctx.ring
        n, me, nxt, prv = _ring_peers(group)
        Tl = q.shape[1]
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        dq = torch.zeros(q.shape, device=q.device)
        # each K/V shard travels with its own dK/dV accumulators
        kv = (k, v, torch.zeros(k.shape, device=k.device),
              torch.zeros(v.shape, device=v.device))
        for s in range(n):
            src = (me - s) % n
            if _folds(src, me, causal):
                dq_s, dk_s, dv_s = _unfold(q, kv[0], kv[1], do, lse, delta,
                                           scale, block, me * Tl, src * Tl,
                                           causal)
                dq = dq + dq_s
                kv = (kv[0], kv[1], kv[2] + dk_s, kv[3] + dv_s)
            if s < n - 1:
                kv = _rotate(kv, group, nxt, prv)
        dk, dv = kv[2], kv[3]
        if n > 1:
            # the accumulators held here belong to the next rank's shard
            dk, dv = _rotate((dk, dv), group, nxt, prv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def make_ring_attention(mesh, axis_name: str = SEQ_AXIS,
                        causal: bool = False,
                        scale: Optional[float] = None,
                        block_size: int = 512):
    """``fn(q, k, v) -> out`` over this rank's ``[B, T/n, H, D]`` shards
    of a sequence sharded on ``mesh[axis_name]``; differentiable. Where
    the batch is also split (dp x sp), each rank's batch rows are its
    own and the ring runs within its ``seq`` group."""
    group = mesh.group(axis_name)

    def fn(q, k, v):
        s = scale if scale is not None else q.shape[-1] ** -0.5
        return RingAttention.apply(q, k, v, group, causal, s,
                                   int(block_size))

    return fn


def ring_attention(q, k, v, mesh, axis_name: str = SEQ_AXIS,
                   causal: bool = False, scale: Optional[float] = None,
                   block_size: int = 512):
    """One call of :func:`make_ring_attention`."""
    return make_ring_attention(mesh, axis_name, causal, scale,
                               block_size)(q, k, v)


__all__ = ["RingAttention", "ring_attention", "make_ring_attention",
           "SEQ_AXIS"]
