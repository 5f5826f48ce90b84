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
``MOE_AUX_WEIGHT``, averaged over the ranks: each rank routes its own
tokens, so the load-balancing term is the mean of the ranks' terms and
equals the reference's, which routes the whole batch at once, on a
mesh of one rank.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.ops.ring_attention import make_ring_attention
from fedml_tpu_torch.parallel.lm_step import (DATA_AXIS, MOE_AUX_WEIGHT,
                                              lm_loss_share, seeded_params,
                                              sgd, sharded_step)
from fedml_tpu_torch.parallel.multihost import global_put

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


def make_seq_parallel_lm_step(model, mesh, tx=None):
    """``(init_fn, step_fn)`` for next-token training with the sequence
    sharded over the mesh's ``seq`` axis.

    ``tx(params) -> torch.optim.Optimizer`` builds the optimizer (default
    SGD at 1e-3). ``init_fn(seed) -> (params, opt)`` draws the model's
    initialisers from ``seed`` (the same on every rank) and places the
    parameters on the rank's device. ``step_fn(params, opt, idx, tgt) ->
    (params, opt, loss)`` takes this rank's ``[B / n_data, T / n_seq]``
    blocks (:func:`place_lm_batch`) of the tokens and of their targets,
    shifted globally before sharding (:func:`shift_targets`; targets < 0
    are masked), steps every rank alike and returns the global loss."""
    tx = tx if tx is not None else sgd(1e-3)
    group = mesh.group()

    def init_fn(seed):
        params = {k: v.clone().to(mesh.device).requires_grad_(True)
                  for k, v in seeded_params(model, seed).items()}
        return params, tx(list(params.values()))

    def local_loss(params, idx, tgt):
        # this rank's share of the global mean over the whole grid
        off = mesh.index(SEQ_AXIS) * idx.shape[1]
        logits, aux = model.apply_params(params, idx, with_sown=True,
                                         pos_offset=off)
        return (lm_loss_share(logits, tgt, group)
                + MOE_AUX_WEIGHT * aux / mesh.size)

    def step_fn(params, opt, idx, tgt):
        loss = local_loss(params, idx, tgt)
        return params, opt, sharded_step(params, opt, loss, group)

    return init_fn, step_fn


def place_lm_batch(mesh, idx, tgt):
    """Host-replicated ``[B, T]`` tokens and targets -> this rank's
    ``(data, seq)`` blocks on its device, as int64."""
    return tuple(global_put(mesh, torch.as_tensor(np.asarray(a)).long(),
                            (DATA_AXIS, SEQ_AXIS)) for a in (idx, tgt))


def shift_targets(idx, pad_id: int = -1):
    """Global next-token targets: ``tgt[t] = idx[t + 1]``, the last
    position masked. Shift the host's whole sequence before sharding: a
    shard's last target lies in the next shard."""
    idx = np.asarray(idx)
    return np.concatenate(
        [idx[:, 1:], np.full_like(idx[:, :1], pad_id)], axis=1)


__all__ = ["make_seq_mesh", "make_seq_parallel_lm_step", "place_lm_batch",
           "seq_parallel_model", "shift_targets", "DATA_AXIS",
           "SEQ_AXIS"]
