"""Expert parallelism (ep): the MoE experts split over the ``expert``
axis of a ``(data, expert)`` mesh (counterpart of
``fedml_tpu/parallel/expert_parallel.py``).

The stacked expert weights of
:class:`fedml_tpu_torch.models.moe.MoEMLP` (``wi [E, C, H]``, ``wo [E,
H, C]``) split on their leading axis: each rank of the ``expert`` group
holds ``E / n_expert`` experts and computes their token buffers, and the
combine's sum over experts is one all-reduce (``reduce_from``).
Everything else is replicated.

The reference keeps the unsharded semantics under GSPMD: routing,
capacity (``capacity(N, ...)``) and queue order are taken over all
``N`` tokens of the global batch. So each MoE layer gathers the tokens
of every ``data`` rank (``gather_rows``) and routes them all on every
rank; a rank combines the outputs of its own tokens only. The gathered
tokens enter the experts through ``copy_to`` over ``expert``, so their
gradient is the sum of every rank's experts' parts. The router runs on
the gathered tokens outside the expert group, and the gate value is
applied after the reduce, so its gradient and the Switch aux loss's are
the same on every expert rank; the aux loss, which every ``data`` rank
computes whole, enters each rank's loss divided by ``n_data``, and every
gradient is summed over ``data``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from fedml_tpu_torch.parallel.collectives import (copy_to, gather_rows,
                                                  reduce_from)
from fedml_tpu_torch.parallel.lm_step import (DATA_AXIS, MOE_AUX_WEIGHT,
                                              data_rows, gather_params,
                                              lm_loss_share, place_params,
                                              seeded_params, sgd,
                                              sharded_step)

EXPERT_AXIS = "expert"


def make_ep_mesh(n_data: int, n_expert: int, devices=None, device=None):
    from fedml_tpu_torch.parallel.mesh import make_2d_mesh
    return make_2d_mesh(n_data, n_expert, (DATA_AXIS, EXPERT_AXIS), devices,
                        device)


def _is_expert(name):
    parts = name.split(".")
    return "moe" in parts[:-1] and parts[-1] in ("wi", "wo")


def ep_param_shardings(params, mesh, n_experts=None) -> dict:
    """Expert weights shard over ``expert``; everything else replicates.
    Returns ``{name: spec}`` (``(EXPERT_AXIS,)`` or ``()``).

    A leaf is an expert stack only when it is named ``wi``/``wo`` AND
    lives under an ``moe`` module (anchored on name components -- a
    parameter merely *ending* in "wi" must not silently shard). The
    leading axis must divide the expert mesh axis (and equal
    ``n_experts`` when given), else this raises."""
    n_ep = mesh.shape[EXPERT_AXIS]
    specs = {}
    for name, leaf in params.items():
        if not _is_expert(name):
            specs[name] = ()
            continue
        if n_experts is not None and leaf.shape[0] != n_experts:
            raise ValueError(
                f"ep_param_shardings: '{name}' leading axis "
                f"{leaf.shape[0]} != n_experts={n_experts}")
        if leaf.shape[0] % n_ep:
            raise ValueError(
                f"ep_param_shardings: '{name}' has {leaf.shape[0]} experts, "
                f"not divisible by the {n_ep}-way expert mesh axis")
        specs[name] = (EXPERT_AXIS,)
    return specs


def sharded_moe(model, params, i, data_group, expert_group=None,
                expert_index=0):
    """Block ``i``'s MoE MLP of ``model`` over the global batch, as
    ``fn(h [1, N_l, C]) -> (y [1, N_l, C], aux [1])`` on this rank's
    tokens, or None for a dense block. ``params`` are client-stacked
    (``K = 1``) and hold this rank's experts, the ``expert_index``-th
    block of ``expert_group``'s ranks (None: every expert)."""
    moe = model.blocks[i].moe
    if moe is None:
        return None
    from fedml_tpu_torch.models.moe import experts, route

    pre = f"blocks.{i}.moe."
    rw, rb = params[pre + "router.weight"], params[pre + "router.bias"]
    wi, wo = params[pre + "wi"], params[pre + "wo"]
    dtype = model.dtype

    def fn(h):
        n_own = h.shape[1]
        x = gather_rows(h[0], data_group)[None]                  # [1, N, C]
        disp, gate_val, aux, _, _ = route(x, rw, rb, rw.shape[1],
                                          moe.capacity_factor)
        e0 = expert_index * wi.shape[1]
        d = disp[:, :, e0:e0 + wi.shape[1]].to(dtype)
        if expert_group is not None:
            x = copy_to(x, expert_group)
        out = experts(torch.einsum("knec,knd->kecd", d, x.to(dtype)), wi,
                      wo, dtype)
        me = dist.get_rank(data_group)
        own = slice(me * n_own, (me + 1) * n_own)
        y = torch.einsum("knec,kecd->knd", d[:, own], out)
        if expert_group is not None:
            y = reduce_from(y, expert_group)
        y = y * gate_val[:, own, None].to(dtype)
        return y.to(h.dtype), aux

    return fn


def make_ep_lm_step(model, mesh, tx: Optional[Any] = None):
    """``(init_fn, step_fn)`` for an MoE LM, the contract of
    :func:`~fedml_tpu_torch.parallel.tensor_parallel.make_tp_lm_step`:
    ``init_fn(seed) -> (params, opt)`` keeps this rank's experts
    (:func:`ep_param_shardings`); ``step_fn(params, opt, idx, tgt) ->
    (params, opt, loss)`` over the host-replicated batch, the loss
    ``lm_loss + MOE_AUX_WEIGHT * aux`` of the global batch."""
    tx = tx if tx is not None else sgd(1e-3)
    group, me = mesh.group(EXPERT_AXIS), mesh.index(EXPERT_AXIS)
    data_group, n_data = mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS]

    def init_fn(seed):
        full = seeded_params(model, seed)
        specs = ep_param_shardings(full, mesh,
                                   getattr(model, "n_experts", None))
        params = place_params(full, specs, mesh, EXPERT_AXIS)
        return params, tx(list(params.values()))

    def step_fn(params, opt, idx, tgt):
        idx, tgt = data_rows(mesh, idx), data_rows(mesh, tgt)
        logits, aux = model.apply_params(
            params, idx, with_sown=True,
            moe_for=lambda P, i: sharded_moe(model, P, i, data_group, group,
                                             me))
        loss = (lm_loss_share(logits, tgt, data_group)
                + MOE_AUX_WEIGHT * aux / n_data)
        return params, opt, sharded_step(params, opt, loss, data_group)

    return init_fn, step_fn


def gather_ep_params(params, mesh):
    """An ep rank's ``params`` whole again (every rank gets them): the
    ``expert`` group's experts all-gathered."""
    specs = {k: (EXPERT_AXIS,) if _is_expert(k) else () for k in params}
    return gather_params(params, specs, mesh, EXPERT_AXIS)


__all__ = ["make_ep_mesh", "make_ep_lm_step", "ep_param_shardings",
           "sharded_moe", "gather_ep_params", "MOE_AUX_WEIGHT",
           "DATA_AXIS", "EXPERT_AXIS"]
