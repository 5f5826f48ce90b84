"""What the sharded LM steps share (sequence, tensor, expert and pipeline
parallelism): the default optimizer, the seeded parameters, this rank's
share of the global loss, the one all-reduced optimizer step, and the
placing of a batch's rows and of parameter blocks on the mesh.

Every rank takes the same step: its loss is its masked token sum over
the token count of the whole ``group``, its gradients are summed over
the group in one fp32 ``all_reduce`` (``multihost.all_reduce_sum``),
and each rank steps its own leaves with them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.parallel.multihost import all_reduce_sum, global_put
from fedml_tpu_torch.utils.torch_import import (tp_gather_params,
                                                tp_shard_params)

DATA_AXIS = "data"

# coefficient on the Switch load-balancing aux loss -- single-sourced so
# the step builders and their oracles (tests, dryrun) cannot drift
MOE_AUX_WEIGHT = 0.01


def sgd(lr):
    """``tx(params) -> torch.optim.SGD`` at ``lr``: the steps' default."""
    return lambda params: torch.optim.SGD(params, lr=lr)


def seeded_params(model, seed):
    """``model``'s parameters drawn from its initialisers under ``seed``
    (the same on every rank), detached, by torch name."""
    model.reset_parameters_(torch.Generator().manual_seed(int(seed)))
    return {k: v.detach() for k, v in model.named_parameters()}


def lm_loss_share(logits, tgt, group):
    """This rank's share of the masked next-token mean over ``group``'s
    tokens: its masked NLL sum over the token count summed over the
    group (the shares sum to the reference's ``lm_loss``)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    mask = (tgt >= 0).float()
    nll = -lp.gather(-1, torch.clamp(tgt, min=0).long()[..., None])[..., 0]
    count = all_reduce_sum(mask.sum(), group)
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def sharded_step(params, opt, loss, group, assemble=()):
    """Backward of this rank's ``loss``, every gradient (and the loss)
    summed over ``group`` in one fp32 ``all_reduce``, the gradients named
    in each ``(group, names)`` of ``assemble`` summed over that group
    too, and one optimizer step, the same on every rank. Returns the loss
    summed over ``group``."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        total, grads = all_reduce_sum((loss, grads), group)
        for other, names in assemble:
            if names:
                grads.update(all_reduce_sum({k: grads[k] for k in names},
                                            other))
        for k, p in params.items():
            p.grad = grads[k].to(p.dtype)
    opt.step()
    return total


def data_rows(mesh, a):
    """This rank's rows of a host-replicated ``[B, ...]`` token array
    over ``data``, as int64 on the rank's device."""
    return global_put(mesh, torch.as_tensor(np.asarray(a)).long(),
                      (DATA_AXIS,))


def place_params(full, specs, mesh, axis):
    """This rank's block (over ``axis``) of ``full`` parameters, as leaf
    tensors on the mesh's device that require gradients."""
    local = tp_shard_params(full, specs, mesh.shape[axis], mesh.index(axis),
                            axis)
    return {k: v.detach().clone().to(mesh.device).requires_grad_(True)
            for k, v in local.items()}


def gather_params(params, specs, mesh, axis):
    """Every leaf of ``params`` whole again: the ranks' blocks over
    ``axis`` all-gathered and assembled (detached copies)."""
    group, n = mesh.group(axis), mesh.shape[axis]
    shards = [dict() for _ in range(n)]
    for k, t in params.items():
        t = t.detach().clone()
        if axis in tuple(specs[k]) and n > 1:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
        else:
            parts = [t] * n
        for s, p in zip(shards, parts):
            s[k] = p
    return tp_gather_params(shards, specs, axis)


__all__ = ["DATA_AXIS", "MOE_AUX_WEIGHT", "sgd", "seeded_params",
           "lm_loss_share", "sharded_step", "data_rows", "place_params",
           "gather_params"]
