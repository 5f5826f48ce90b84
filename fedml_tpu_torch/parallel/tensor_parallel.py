"""Tensor-parallel (tp) LM training: Megatron-style sharded products over
the ``model`` axis of a ``(data, model)`` mesh (counterpart of
``fedml_tpu/parallel/tensor_parallel.py``).

The reference annotates the parameters and lets GSPMD insert the
collectives. Here each rank of the ``model`` group holds its block of
the sharded parameters and the step says where the ranks meet
(``parallel/collectives.py``):

- ``qkv`` and ``mlp_up`` are column-parallel: a rank holds the rows of
  its heads (of each of q, k and v) and of its slice of the MLP's hidden
  units (``nn.Linear`` weights are ``[out, in]``, so the reference's
  output-feature split is dim 0 here). Their input enters through
  :func:`~fedml_tpu_torch.parallel.collectives.copy_to`;
- ``proj`` and ``mlp_down`` are row-parallel (dim 1): their partial
  products meet in one all-reduce (``reduce_from``), and ``mlp_down``'s
  bias is added once after it;
- everything else is replicated. ``mlp_up``'s bias is 1-D and so
  replicated, as in the reference; each rank adds its slice, and the
  slices' gradients are summed over ``model`` before the step.

The batch splits over ``data``: a rank's loss is its masked token sum
over the token count of the whole batch, and every gradient is summed
over ``data``, so every rank takes the same step on its leaves. A model
that sows auxiliary losses (the Switch MoE, replicated over ``model``)
routes the whole batch, as the reference's global semantics do
(``parallel/expert_parallel.py``). Attention is
:func:`tp_attention`'s blockwise path, as in the reference (no kernel),
unless the model carries none, in which case it is the flash kernels.
"""

from __future__ import annotations

from typing import Any, Optional

from fedml_tpu_torch.ops.attention import blockwise_attention
from fedml_tpu_torch.parallel.collectives import copy_to, reduce_from
from fedml_tpu_torch.parallel.expert_parallel import sharded_moe
from fedml_tpu_torch.parallel.lm_step import (DATA_AXIS, MOE_AUX_WEIGHT,
                                              data_rows, gather_params,
                                              lm_loss_share, place_params,
                                              seeded_params, sgd,
                                              sharded_step)

MODEL_AXIS = "model"


def make_tp_mesh(n_data: int, n_model: int, devices=None, device=None):
    from fedml_tpu_torch.parallel.mesh import make_2d_mesh
    return make_2d_mesh(n_data, n_model, (DATA_AXIS, MODEL_AXIS), devices,
                        device)


# Megatron placement by EXACT module name (a path COMPONENT, never a
# substring -- a future 'projector' module must not silently become
# row-parallel). Module names from models/transformer.py::_Block.
_COL_PARALLEL = frozenset({"qkv", "mlp_up"})    # output-feature sharded
_ROW_PARALLEL = frozenset({"proj", "mlp_down"})  # input-feature sharded
# >=2D params that are INTENTIONALLY replicated (embeddings, head, MoE
# experts -- expert sharding belongs to the ep axis, not tp); any other
# >=2D param is unknown to the placement table and raises.
_KNOWN_REPLICATED = frozenset({"tok_embed", "pos_embed", "head", "embedding",
                               "moe"})


def _tp_spec(path: str, ndim: int):
    parts = path.split(".")
    if ndim < 2:  # biases, LN scales: replicated
        return ()
    if any(p in _COL_PARALLEL for p in parts):
        return (MODEL_AXIS,)            # column-parallel: [out, in] dim 0
    if any(p in _ROW_PARALLEL for p in parts):
        return (None, MODEL_AXIS)       # row-parallel: dim 1
    if any(p in _KNOWN_REPLICATED for p in parts):
        return ()
    raise ValueError(
        f"tp_param_shardings: no Megatron placement known for >=2D param "
        f"'{path}' -- add its module name to _COL_PARALLEL/_ROW_PARALLEL/"
        "_KNOWN_REPLICATED rather than silently replicating")


def tp_param_shardings(params, mesh) -> dict:
    """``{name: spec}`` for ``params`` (torch names): a spec names the
    mesh axis each leading dim is split over (the reference's
    ``PartitionSpec``; ``()`` replicates). Validates that every sharded
    dimension divides the ``model`` mesh axis."""
    n_model = mesh.shape[MODEL_AXIS]
    specs = {}
    for name, leaf in params.items():
        spec = _tp_spec(name, len(leaf.shape))
        for dim, axis in enumerate(spec):
            if axis == MODEL_AXIS and leaf.shape[dim] % n_model:
                raise ValueError(
                    f"tp_param_shardings: '{name}' dim {dim} of size "
                    f"{leaf.shape[dim]} does not divide the {n_model}-way "
                    "model axis")
        specs[name] = spec
    return specs


def tp_attention(block_size: int = 512):
    """Attention for the tp path: blockwise (flash semantics) over the
    rank's heads, as the reference's GSPMD-partitioned path."""
    def fn(q, k, v):
        return blockwise_attention(q, k, v, block_size=block_size,
                                   causal=True)
    return fn


def make_tp_lm_step(model, mesh, tx: Optional[Any] = None):
    """``(init_fn, step_fn)`` with Megatron-sharded parameters.

    ``tx(params) -> torch.optim.Optimizer`` (default SGD at 1e-3).
    ``init_fn(seed) -> (params, opt)`` draws the model's initialisers
    from ``seed`` (the same on every rank) and keeps this rank's blocks
    (:func:`tp_param_shardings`) on its device; ``step_fn(params, opt,
    idx, tgt) -> (params, opt, loss)`` takes the host-replicated ``[B,
    T]`` batch and its targets (targets < 0 masked), trains this rank's
    rows of ``data`` and returns the global loss, with ``MOE_AUX_WEIGHT``
    times the aux loss of a model that sows one."""
    tx = tx if tx is not None else sgd(1e-3)
    n_model, me = mesh.shape[MODEL_AXIS], mesh.index(MODEL_AXIS)
    if model.n_heads % n_model:
        raise ValueError(f"tp: n_heads={model.n_heads} does not divide the "
                         f"{n_model}-way model axis")
    group = mesh.group(MODEL_AXIS)
    data_group, n_data = mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS]
    hidden = model.mlp_ratio * model.d_model // n_model

    def init_fn(seed):
        full = seeded_params(model, seed)
        params = place_params(full, tp_param_shardings(full, mesh), mesh,
                              MODEL_AXIS)
        return params, tx(list(params.values()))

    def get(P, i, name):
        t = P[f"blocks.{i}.{name}"]
        if name == "mlp_up.bias":  # replicated: this rank's slice
            return t[:, me * hidden:(me + 1) * hidden]
        return t

    def step_fn(params, opt, idx, tgt):
        idx, tgt = data_rows(mesh, idx), data_rows(mesh, tgt)
        logits, aux = model.apply_params(
            params, idx, with_sown=True, get=get,
            moe_for=lambda P, i: sharded_moe(model, P, i, data_group),
            enter=lambda h: copy_to(h, group),
            leave=lambda y: reduce_from(y, group))
        loss = (lm_loss_share(logits, tgt, data_group)
                + MOE_AUX_WEIGHT * aux / n_data)
        col_biases = [k for k in params if k.endswith("mlp_up.bias")]
        total = sharded_step(params, opt, loss, data_group,
                             [(group, col_biases)])
        return params, opt, total

    return init_fn, step_fn


def gather_tp_params(params, mesh):
    """A tp rank's ``params`` whole again (every rank gets them), in the
    unsharded model's layout: the ``model`` group's blocks all-gathered
    and assembled by the placement table."""
    specs = {k: _tp_spec(k, v.dim()) for k, v in params.items()}
    return gather_params(params, specs, mesh, MODEL_AXIS)


__all__ = ["make_tp_mesh", "make_tp_lm_step", "tp_param_shardings",
           "tp_attention", "gather_tp_params", "DATA_AXIS", "MODEL_AXIS"]
