"""Sequence-parallel LM training over a ``(data, seq)`` mesh
(counterpart of ``fedml_tpu/parallel/seq_parallel.py``).

The batch splits over ``data`` and the sequence over ``seq``: each rank
holds the ``[B / n_data, T / n_seq]`` block of tokens that its
coordinates name, runs the model on it (the positions offset by its
shard's start) and meets the other ranks of its ``seq`` group in ring
attention (``ops/ring_attention.py``), so activation memory is
``O(T / n_seq)``. The loss is the global masked mean over the whole
grid: each rank divides its masked token sum by the token count summed
over the mesh, and the parameter gradients are summed over both axes in
one fp32 ``all_reduce``. Parameters and optimizer state stay replicated:
every rank takes the same step.

A model that sows auxiliary losses (the Switch MoE) adds them with
``aux_loss_weight``, averaged over the ranks: each rank routes its own
tokens, so the load-balancing term is the mean of the ranks' terms and
equals the reference's, which routes the whole batch at once, on a
mesh of one rank.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.ops.ring_attention import make_ring_attention
from fedml_tpu_torch.parallel.multihost import all_reduce_sum, global_put

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def make_seq_mesh(n_data: int, n_seq: int, devices=None, device=None):
    """The ``(data, seq)`` mesh: dp over ``data``, sp over ``seq``."""
    from fedml_tpu_torch.parallel.mesh import make_2d_mesh

    return make_2d_mesh(n_data, n_seq, (DATA_AXIS, SEQ_AXIS), devices,
                        device)


def seq_parallel_model(model_cls, mesh, *, block_size: int = 512, **kw):
    """``model_cls`` (TransformerLM-compatible) with its attention the
    causal ring over ``mesh``'s ``seq`` axis."""
    ring = make_ring_attention(mesh, SEQ_AXIS, causal=True,
                               block_size=block_size)
    return model_cls(attention_fn=ring, **kw)


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


def make_seq_parallel_lm_step(model, mesh, tx=None,
                              seq_axis: str = SEQ_AXIS,
                              aux_loss_weight: float = 0.01):
    """``(init_fn, step_fn)`` for next-token training with the sequence
    sharded over ``mesh[seq_axis]``.

    ``tx(params) -> torch.optim.Optimizer`` builds the optimizer (default
    SGD at 1e-3). ``init_fn(seed) -> (params, opt)`` draws the model's
    initialisers from ``seed`` (the same on every rank) and places the
    parameters on the rank's device. ``step_fn(params, opt, idx, tgt) ->
    (params, opt, loss)`` takes this rank's ``[B / n_data, T / n_seq]``
    blocks (:func:`place_lm_batch`) of the tokens and of their targets,
    shifted globally before sharding (:func:`shift_targets`; targets < 0
    are masked), steps every rank alike and returns the global loss."""
    tx = tx if tx is not None else _sgd(1e-3)
    group = mesh.group()

    def init_fn(seed):
        model.reset_parameters_(torch.Generator().manual_seed(int(seed)))
        params = {k: v.detach().clone().to(mesh.device).requires_grad_(True)
                  for k, v in model.named_parameters()}
        return params, tx(list(params.values()))

    def local_loss(params, idx, tgt):
        # this rank's share of the global mean: its masked sum over the
        # token count of the whole grid
        off = mesh.index(seq_axis) * idx.shape[1]
        logits, aux = model.apply_params(params, idx, with_sown=True,
                                         pos_offset=off)
        lp = torch.log_softmax(logits.float(), dim=-1)
        mask = (tgt >= 0).float()
        nll = -lp.gather(-1, torch.clamp(tgt, min=0).long()[..., None])[
            ..., 0]
        count = all_reduce_sum(mask.sum(), group)
        return ((nll * mask).sum() / torch.clamp(count, min=1.0)
                + aux_loss_weight * aux / mesh.size)

    def step_fn(params, opt, idx, tgt):
        opt.zero_grad(set_to_none=True)
        loss = local_loss(params, idx, tgt)
        loss.backward()
        with torch.no_grad():
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p))
                     for k, p in params.items()}
            loss_sum, grads = all_reduce_sum((loss, grads), group)
            for k, p in params.items():
                p.grad = grads[k].to(p.dtype)
        opt.step()
        return params, opt, loss_sum

    return init_fn, step_fn


def place_lm_batch(mesh, idx, tgt, data_axis: str = DATA_AXIS,
                   seq_axis: str = SEQ_AXIS):
    """Host-replicated ``[B, T]`` tokens and targets -> this rank's
    ``(data, seq)`` blocks on its device, as int64."""
    return tuple(global_put(mesh, torch.as_tensor(np.asarray(a)).long(),
                            (data_axis, seq_axis)) for a in (idx, tgt))


def shift_targets(idx, pad_id: int = -1):
    """Global next-token targets: ``tgt[t] = idx[t + 1]``, the last
    position masked. Shift the host's whole sequence before sharding: a
    shard's last target lies in the next shard."""
    idx = np.asarray(idx)
    return np.concatenate(
        [idx[:, 1:], np.full_like(idx[:, :1], pad_id)], axis=1)


__all__ = ["make_seq_mesh", "make_seq_parallel_lm_step", "place_lm_batch",
           "seq_parallel_model", "shift_targets", "DATA_AXIS", "SEQ_AXIS"]
