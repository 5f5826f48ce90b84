"""Differentiable collectives for the model-parallel steps (no reference
file of this name: the reference leaves them to GSPMD and ``ppermute``,
whose transposes JAX derives; torch differentiates no collective).

- Megatron's pair over a group: :func:`copy_to` is the identity forward
  and an all-reduce of the gradient backward (the input of a
  column-parallel product, replicated over the group, whose ranks each
  contribute a part of its gradient); :func:`reduce_from` all-reduces
  forward and passes the gradient through (the output of a row-parallel
  product, whose ranks each hold a part of the sum).
- :func:`gather_rows`: every rank's rows, concatenated in group order
  forward; backward, the gradient summed over the group and this rank's
  rows of it (each rank's use of the others' rows sends them gradient).
- :func:`stage_hop`: one hop down a ring, the tensor sent to the next
  rank and the previous rank's received, in one batch of point-to-point
  operations; backward, the gradient goes the reverse hop.

Every all-reduce sums in fp32, as ``multihost.all_reduce_sum`` does, and
casts back to the tensor's dtype. On a group of one rank each is the
identity and sends nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def ring_peers(group):
    """``(n, me, next, previous)``: the group's size, this rank's index
    in it, and the global ranks it sends to and receives from."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    return (n, me, dist.get_global_rank(group, (me + 1) % n),
            dist.get_global_rank(group, (me - 1) % n))


def rotate(tensors, group, nxt, prv):
    """Send ``tensors`` to global rank ``nxt`` and return those received
    from ``prv``, in one batch of point-to-point operations."""
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _sum(x, group):
    """``x`` summed over ``group`` in fp32, in ``x``'s dtype."""
    if dist.get_world_size(group) == 1:
        return x
    t = x.float().contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group) if dist.get_world_size(group) > 1 \
            else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        n = dist.get_world_size(group)
        if n == 1:
            return x.view_as(x)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        me, rows = dist.get_rank(ctx.group), ctx.rows
        return _sum(g, ctx.group)[me * rows:(me + 1) * rows], None


class _StageHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, _, nxt, prv = ring_peers(group)
        ctx.peers = (group, n, nxt, prv)
        return x.clone() if n == 1 else rotate([x], group, nxt, prv)[0]

    @staticmethod
    def backward(ctx, g):
        group, n, nxt, prv = ctx.peers
        return (g.clone() if n == 1
                else rotate([g], group, prv, nxt)[0]), None


def copy_to(x, group):
    """Identity forward; the gradient all-reduced over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """``x`` all-reduced over ``group``; the gradient passed through."""
    return _ReduceFrom.apply(x, group)


def gather_rows(x, group):
    """The group's ranks' ``x`` concatenated on dim 0 in rank order; the
    gradient summed over the group, this rank's rows of it."""
    return _GatherRows.apply(x, group)


def stage_hop(x, group):
    """``x`` sent one hop down ``group``'s ring, the previous rank's
    received; the gradient goes the reverse hop. Every rank of the group
    must hop together, forward and backward."""
    return _StageHop.apply(x, group)


__all__ = ["ring_peers", "rotate", "copy_to", "reduce_from",
           "gather_rows", "stage_hop"]
