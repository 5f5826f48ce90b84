"""Pipeline parallelism (pp): GPipe over the ``stage`` axis of a mesh
(counterpart of ``fedml_tpu/parallel/pipeline_parallel.py``).

Transformer blocks split over the ``stage`` ranks: ``k = n_layers /
n_stages`` consecutive blocks a stage, in the port's state-dict layout
stacked to ``[S, k, ...]`` (:func:`stack_pp_params`; a rank holds its
stage's ``[k, ...]``). Microbatches flow down the ring: each of the
``M + S - 1`` ticks every stage applies its blocks to the activation it
holds (when it holds one of the ``M`` microbatches) and sends the result
one hop downstream (``collectives.stage_hop``). Embed runs only on stage
0 and the final LayerNorm, head and loss only on the last stage, which
banks each microbatch in order as it completes; the loss is summed over
``stage``.

Backward is autograd through the ticks: each hop's gradient goes the
reverse hop, so every rank must run the same hops in the same order.
Each tick's input therefore depends on the previous tick's hop on every
stage (stage 0 adds it times 0 to its embedding), and the last hop's
output enters the loss times 0: every rank's backward is one chain of
``M + S - 1`` reverse hops, the last tick's first. The shared
parameters (embeddings on stage 0, ``ln_f`` and the head on the last)
get their gradients summed over ``stage``, as the reference's ``psum``
transpose sums them, so every rank steps identically.

Its ``TransformerLM`` keeps the default attention: on the card the
blocks run the flash-attention kernels (B2-B4), once a layer a
microbatch.

Restrictions (as the reference's): ``n_layers`` must be a multiple of
``n_stages`` and the batch must split into ``n_micro`` equal
microbatches.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.parallel.collectives import stage_hop
from fedml_tpu_torch.parallel.lm_step import seeded_params
from fedml_tpu_torch.parallel.multihost import all_reduce_sum
from fedml_tpu_torch.utils.torch_import import (stack_pp_params,
                                                unstack_pp_params)

STAGE_AXIS = "stage"


def make_pp_mesh(n_stages: int, devices=None, device=None):
    from fedml_tpu_torch.parallel.mesh import make_mesh
    return make_mesh((n_stages,), (STAGE_AXIS,), devices, device)


def _check_layers(n_layers, S):
    if n_layers % S:
        raise ValueError(f"n_layers={n_layers} must be a multiple of the "
                         f"{S}-stage mesh")


def place_pp_params(pp_params, mesh):
    """This rank's stage of the stacked layout (:func:`stack_pp_params`)
    and the shared leaves, as leaf tensors on the mesh's device that
    require gradients."""
    me = mesh.index(STAGE_AXIS)
    leaf = lambda t: t.detach().clone().to(mesh.device).requires_grad_(  # noqa: E731
        True)
    return {"stages": {k: leaf(t[me]) for k, t in pp_params["stages"].items()},
            "shared": {k: leaf(t) for k, t in pp_params["shared"].items()}}


def init_pp_params(mesh, seed, *, vocab_size, n_heads=4, d_model=256,
                   max_len=2048, mlp_ratio=4, dtype=torch.float32,
                   attention_fn=None, n_layers=None):
    """A ``TransformerLM`` with ``n_layers`` blocks (default: one a
    stage), its initialisers drawn from ``seed``, laid out for pp: this
    rank's stage of blocks stacked ``[k, ...]`` and the shared leaves.
    Returns ``(params, model)``; ``model.apply_params`` on the unstacked
    parameters is the single-device oracle."""
    from fedml_tpu_torch.models.transformer import TransformerLM

    S = mesh.shape[STAGE_AXIS]
    n_layers = S if n_layers is None else int(n_layers)
    _check_layers(n_layers, S)
    model = TransformerLM(vocab_size=vocab_size, n_layers=n_layers,
                          n_heads=n_heads, d_model=d_model, max_len=max_len,
                          mlp_ratio=mlp_ratio, dtype=dtype,
                          attention_fn=attention_fn)
    return (place_pp_params(stack_pp_params(seeded_params(model, seed), S),
                            mesh), model)


def gather_pp_params(params, mesh):
    """Every stage's blocks all-gathered over ``stage``: the stacked
    layout ``{"stages": [S, k, ...], "shared"}`` on every rank (detached
    copies; :func:`unstack_pp_params` gives the model's)."""
    import torch.distributed as dist

    group, S = mesh.group(STAGE_AXIS), mesh.shape[STAGE_AXIS]
    stages = {}
    for k, t in params["stages"].items():
        parts = [torch.empty_like(t) for _ in range(S)]
        dist.all_gather(parts, t.detach().contiguous(), group=group)
        stages[k] = torch.stack(parts)
    return {"stages": stages,
            "shared": {k: t.detach().clone()
                       for k, t in params["shared"].items()}}


def make_pp_lm_step(model, mesh, n_micro: int = 4):
    """``(prep_fn, step_fn)`` for pp training.

    ``prep_fn(idx, tgt)`` splits the ``[B, T]`` batch into ``[M, B/M,
    T]`` microbatches (int64 tensors on the rank's device); ``step_fn(
    params, opt, idx_m, tgt_m) -> (params, opt, loss)`` with params from
    :func:`init_pp_params` and ``opt`` a ``torch.optim.Optimizer`` over
    :func:`pp_leaves` (``tx(pp_leaves(params))``, where the reference
    calls ``tx.init(params)``)."""
    from fedml_tpu_torch.models.transformer import lm_loss

    S, me = mesh.shape[STAGE_AXIS], mesh.index(STAGE_AXIS)
    if model.n_layers % S:
        raise ValueError(
            f"pp requires whole blocks per stage: model.n_layers="
            f"{model.n_layers} is not a multiple of the {S}-stage mesh")
    group, dev = mesh.group(STAGE_AXIS), mesh.device
    first, last = me == 0, me == S - 1
    per_stage = model.n_layers // S

    def blocks(stage, x):
        """This stage's blocks over fp32 ``x [mB, T, C]``, computing in
        the model's dtype."""
        P = {n: t.unsqueeze(0) for n, t in stage.items()}
        h, _ = model.apply_blocks(P, x.unsqueeze(0).to(model.dtype),
                                  per_stage, get=lambda P, j, n: P[n][:, j])
        return h[0].float()

    def forward(params, idx_m, tgt_m):
        shared = {n: t.unsqueeze(0) for n, t in params["shared"].items()}
        M, mB, T = idx_m.shape
        buf = torch.zeros((mB, T, model.d_model), device=dev,
                          requires_grad=True)
        outs = []
        for t in range(M + S - 1):
            m = t - me  # the microbatch this stage holds at tick t
            if first:
                x = buf * 0.0
                if t < M:
                    x = x + model.embed_tokens(shared, idx_m[t][None])[0] \
                        .float()
            else:
                x = buf
            h = blocks(params["stages"], x) if 0 <= m < M else x
            if last and 0 <= m < M:
                outs.append(h)
            buf = stage_hop(h, group)
        tail = (buf * 0.0).sum()
        if not last:
            return tail
        o = torch.cat(outs).to(model.dtype)
        logits = model.head_logits(shared, o[None])[0]
        return lm_loss(logits, tgt_m.reshape(M * mB, T)) + tail

    def prep_fn(idx, tgt):
        idx, tgt = (torch.as_tensor(a).long().to(dev) for a in (idx, tgt))
        B = idx.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by "
                             f"n_micro={n_micro}")
        shp = (n_micro, B // n_micro) + tuple(idx.shape[1:])
        return idx.reshape(shp), tgt.reshape(shp)

    def step_fn(params, opt, idx_m, tgt_m):
        opt.zero_grad(set_to_none=True)
        loss = forward(params, idx_m, tgt_m)
        loss.backward()
        with torch.no_grad():
            shared = {k: (p.grad if p.grad is not None
                          else torch.zeros_like(p))
                      for k, p in params["shared"].items()}
            total, shared = all_reduce_sum((loss, shared), group)
            for k, p in params["shared"].items():
                p.grad = shared[k].to(p.dtype)
        opt.step()
        return params, opt, total

    return prep_fn, step_fn


def pp_leaves(params):
    """This rank's leaves in the optimizer's order: stages, then
    shared."""
    return list(params["stages"].values()) + list(params["shared"].values())


__all__ = ["make_pp_mesh", "init_pp_params", "make_pp_lm_step",
           "stack_pp_params", "unstack_pp_params", "place_pp_params",
           "gather_pp_params", "pp_leaves", "STAGE_AXIS"]
