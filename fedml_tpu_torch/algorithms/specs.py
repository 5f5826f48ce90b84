"""TrainSpec builders (counterpart of ``fedml_tpu/algorithms/specs.py``:
``make_classification_spec``, ``make_seq_classification_spec``,
``make_multilabel_spec`` and ``make_segmentation_spec``).

Softmax cross-entropy over logits (or the sigmoid multilabel loss over
probabilities); metrics are sums (``loss_sum``, ``correct``, ``count``)
that the host divides.

Every spec has a ``stacked_loss_fn`` that trains K clients at once over a
leading client axis: the round runners (waves, flat, vmap lanes, the
host-packed round and the bucketed stream) all train through it. The
classification spec maps one client's loss over the axis with
``torch.func.vmap`` over ``functional_call`` (each client's BatchNorm
statistics and dropout masks batched with it); the TransformerLM writes
the axis out in its own forward (its attention is a custom autograd
Function with no vmap rule).
"""

from __future__ import annotations

import torch
from torch.func import functional_call, vmap

from fedml_tpu_torch.core.trainer import TrainSpec
from fedml_tpu_torch.models.lane_packed import (LOWERINGS, builder_for,
                                               lane_kernel_libraries)
from fedml_tpu_torch.models.layers import fp32_or_wider, lecun_init_
from fedml_tpu_torch.utils.torch_import import module_state


def _loss_and_metrics(logits, y, mask):
    logp = torch.log_softmax(fp32_or_wider(logits), dim=-1)
    per_sample = -logp.gather(-1, y.long()[..., None])[..., 0]
    count = mask.sum()
    loss = (per_sample * mask).sum() / torch.clamp(count, min=1.0)
    correct = ((logits.argmax(dim=-1) == y).float() * mask).sum()
    return loss, {"loss_sum": (per_sample * mask).sum(), "correct": correct,
                  "count": count}


def _multilabel_loss_and_metrics(probs, y, mask):
    """Binary cross-entropy of the clipped probabilities ``[B, L]``
    against multi-hot ``y``, summed over labels; ``tp``/``fp``/``fn`` of
    the 0.5 threshold (``correct`` is ``tp``, as in the reference)."""
    probs = torch.clamp(probs.float(), 1e-7, 1 - 1e-7)
    y = y.float()
    per_sample = -(y * torch.log(probs)
                   + (1 - y) * torch.log(1 - probs)).sum(dim=-1)
    count = mask.sum()
    loss = (per_sample * mask).sum() / torch.clamp(count, min=1.0)
    pred = (probs > 0.5).float()
    m = mask[:, None]
    tp = (pred * y * m).sum()
    return loss, {"loss_sum": (per_sample * mask).sum(), "tp": tp,
                  "fp": (pred * (1 - y) * m).sum(),
                  "fn": ((1 - pred) * y * m).sum(), "count": count,
                  "correct": tp}


def _dropout_masks(model, n, seeds, device):
    """Per-client dropout masks for models that take them: each client's
    drawn from a generator seeded with its step seed, stacked on a
    leading client axis; None for models without dropout."""
    if not hasattr(model, "draw_dropout_masks"):
        return None
    gen = torch.Generator(device=device)
    draws = [model.draw_dropout_masks(n, gen.manual_seed(int(s)))
             for s in seeds]
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


def make_classification_spec(model, example_x=None, num_classes=None,
                             name="classification", augment_fn=None,
                             aux_loss_weight=0.01, lane_lowering=None):
    """Spec for a classification ``nn.Module`` taking NHWC (or flat)
    batches.

    ``init_fn(seed, device)`` draws the reference initialisers from a
    generator seeded with ``seed``; the state is ``{"params"}`` plus
    ``{"batch_stats"}`` for models with BatchNorm. ``loss_fn`` and
    ``metrics_fn`` apply the model functionally on one client's state;
    ``stacked_loss_fn(state, batch, train, seeds=None)`` on K clients'
    (``seeds [K]`` seed the dropout masks of models that have dropout);
    ``lane_loss_builder`` is the packed lowering
    (``models/lane_packed.py``) picked by ``lane_lowering``, or None for
    families without one. A model whose ``sows_losses`` is true takes
    ``with_sown=True`` and returns ``(logits, aux)``; the training loss
    then adds ``aux_loss_weight * aux`` (a model that sows nothing adds
    nothing). ``example_x`` and ``num_classes`` are accepted for
    signature parity with the reference and unused: a torch module knows
    its shapes."""
    del example_x, num_classes
    if lane_lowering not in (None,) + LOWERINGS:
        raise ValueError(f"unknown lane_lowering {lane_lowering!r}; "
                         "choose blockdiag, bgc, auto or pallas")
    return _module_spec(model, _loss_and_metrics, name, augment_fn,
                        aux_loss_weight,
                        builder_for(model, lowering=lane_lowering),
                        lane_kernels=lane_kernel_libraries(model,
                                                           lane_lowering))


def make_multilabel_spec(model, example_x=None, name="tag_prediction",
                         aux_loss_weight=0.01):
    """Sigmoid binary cross-entropy multilabel spec (the reference's
    ``stackoverflow_lr`` tag prediction) for a module that emits
    probabilities (LR with its sigmoid): clipped to ``[1e-7, 1 - 1e-7]``,
    metrics ``loss_sum``, ``tp``, ``fp``, ``fn``, ``count`` and
    ``correct`` (= ``tp``). Built as :func:`make_classification_spec`
    is, with its ``stacked_loss_fn``; no packed lowering. ``example_x``
    is accepted for signature parity and unused."""
    del example_x
    return _module_spec(model, _multilabel_loss_and_metrics, name, None,
                        aux_loss_weight, None)


def _module_spec(model, loss_and_metrics, name, augment_fn, aux_loss_weight,
                 lane_loss_builder, lane_kernels=()):
    """The spec of an ``nn.Module`` applied functionally (one client's
    state, or K clients' through ``torch.func.vmap``), its loss and
    metrics from ``loss_and_metrics(out, y, mask)``. A search network
    (``init_arch_``, ``arch_names``) keeps its architecture weights in
    the state's ``"arch"``."""
    sows = getattr(model, "sows_losses", False)

    def init_fn(seed, device):
        gen = torch.Generator().manual_seed(int(seed))
        lecun_init_(model, gen)
        state = {k: {n: t.to(device) for n, t in v.items()}
                 for k, v in module_state(model).items()}
        if not state["batch_stats"]:
            del state["batch_stats"]
        if hasattr(model, "init_arch_"):
            model.init_arch_(gen)
            state["arch"] = {n: getattr(model, n).detach().clone().to(device)
                             for n in model.arch_names}
        return state

    def _apply(params, stats, x, train, masks=None, with_sown=False,
               arch=None):
        """Logits, the new running statistics and (``with_sown``, for a
        model that sows) the sown aux loss, else None, of one client;
        ``arch`` holds a search network's architecture weights. The
        module writes updated statistics into the buffers it is given:
        hand it copies so the caller's state stays untouched."""
        tensors = dict(params)
        if arch:
            tensors.update(arch)
        stats = {k: v.clone() for k, v in stats.items()}
        tensors.update(stats)
        kwargs = {"train": train}
        if masks is not None:
            kwargs["dropout_masks"] = masks
        if with_sown and sows:
            kwargs["with_sown"] = True
            logits, aux = functional_call(model, tensors, (x,), kwargs)
            return logits, stats, aux
        return functional_call(model, tensors, (x,), kwargs), stats, None

    def _state(params, state, stats):
        new_state = {"params": params}
        if "batch_stats" in state:
            new_state["batch_stats"] = {k: v.detach()
                                        for k, v in stats.items()}
        if "arch" in state:
            new_state["arch"] = state["arch"]
        return new_state

    def loss_fn(state, batch, train, seed=0):
        x = batch["x"]
        masks = (_dropout_masks(model, x.shape[0], [seed], x.device)
                 if train else None)
        masks = None if masks is None else {k: v[0]
                                            for k, v in masks.items()}
        logits, stats, aux = _apply(state["params"],
                                    state.get("batch_stats", {}), x, train,
                                    masks, with_sown=True,
                                    arch=state.get("arch"))
        loss, metrics = loss_and_metrics(logits, batch["y"], batch["mask"])
        if aux is not None:
            loss = loss + aux_loss_weight * aux
        return loss, (_state(state["params"], state, stats), metrics)

    def stacked_loss_fn(state, batch, train, seeds=None):
        x = batch["x"]
        K = x.shape[0]
        masks = None
        if train and hasattr(model, "draw_dropout_masks"):
            if seeds is None:
                raise ValueError(f"{type(model).__name__} trains with "
                                 "per-client seeds for its dropout masks")
            masks = _dropout_masks(model, x.shape[1], seeds[:K], x.device)

        def one(params, stats, x, y, mask, masks, arch):
            logits, new_stats, aux = _apply(params, stats, x, train, masks,
                                            with_sown=True, arch=arch)
            loss, metrics = loss_and_metrics(logits, y, mask)
            if aux is not None:
                loss = loss + aux_loss_weight * aux
            return loss, new_stats, metrics

        in_dims = (0, 0, 0, 0, 0, None if masks is None else 0, 0)
        losses, stats, metrics = vmap(one, in_dims=in_dims)(
            state["params"], state.get("batch_stats", {}), x, batch["y"],
            batch["mask"], masks, state.get("arch", {}))
        return losses.sum(), (_state(state["params"], state, stats),
                              metrics)

    def metrics_fn(state, batch):
        with torch.no_grad():
            logits, _, _ = _apply(state["params"],
                                  state.get("batch_stats", {}), batch["x"],
                                  False, arch=state.get("arch"))
            return loss_and_metrics(logits, batch["y"], batch["mask"])[1]

    return TrainSpec(init_fn=init_fn, loss_fn=loss_fn, metrics_fn=metrics_fn,
                     name=name, augment_fn=augment_fn,
                     lane_loss_builder=lane_loss_builder,
                     stacked_loss_fn=stacked_loss_fn,
                     kernels=tuple(getattr(model, "kernel_libraries", ())),
                     lane_kernels=tuple(lane_kernels))


def _seg_loss_and_metrics(logits, y, mask, num_classes, ignore_index):
    """Per-pixel cross-entropy over ``logits [B, H, W, C]`` with the
    pixels labelled ``ignore_index`` (or outside ``[0, C)``) and the
    masked samples left out; metrics ``loss_sum``, ``correct``, ``count``
    and the summed ``[C, C]`` ``confusion`` (fp32 counts, rows ground
    truth), counted as a product of one-hot rows, which ``vmap`` maps
    over stacked clients (``torch.bincount`` does not map); each count
    stays far below fp32's 2^24."""
    y = y.long()
    pix = ((y != ignore_index) & (y >= 0) & (y < num_classes)).float()
    pix = pix * mask.reshape(mask.shape + (1,) * (y.dim() - mask.dim()))
    logp = torch.log_softmax(logits.float(), dim=-1)
    y_safe = torch.clamp(y, 0, logits.shape[-1] - 1)
    ll = logp.gather(-1, y_safe[..., None])[..., 0]
    count = pix.sum()
    loss_sum = (-ll * pix).sum()
    pred = logits.argmax(dim=-1)
    correct = ((pred == y).float() * pix).sum()
    with torch.no_grad():
        classes = torch.arange(num_classes, device=y.device)
        truth = (y_safe[..., None] == classes).float() * pix[..., None]
        cm = torch.einsum("...i,...j->ij", truth,
                          (pred[..., None] == classes).float())
    return loss_sum / torch.clamp(count, min=1.0), {
        "loss_sum": loss_sum, "correct": correct, "count": count,
        "confusion": cm}


def make_segmentation_spec(model, example_x=None, num_classes=None,
                           ignore_index=255, name="segmentation",
                           aux_loss_weight=0.01):
    """Per-pixel cross-entropy over ``[B, H, W, C]`` logits with the
    ignore label 255 (the reference FedSeg trainer's loss); the metrics
    carry the summed ``[C, C]`` confusion matrix, so mIoU and FWIoU are
    exact (``core/seg_eval.py``). A model that sows an aux loss adds
    ``aux_loss_weight`` times it, as in :func:`make_classification_spec`.
    ``example_x`` is accepted for signature parity and unused."""
    del example_x
    if num_classes is None:
        num_classes = model.num_classes
    return _module_spec(
        model,
        lambda out, y, mask: _seg_loss_and_metrics(
            out, y, mask, num_classes, ignore_index),
        name, None, aux_loss_weight, None)


def _seq_loss_and_metrics(logits, y, mask, ignore_index, dims):
    """Per-token cross-entropy over ``logits [..., T, V]``, token mask =
    sample mask x ``(y != ignore_index)``; sums over ``dims``."""
    tok_mask = (y != ignore_index).float() * mask[..., None]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, y.long()[..., None])[..., 0]
    count = tok_mask.sum(dim=dims)
    loss_sum = (-ll * tok_mask).sum(dim=dims)
    correct = ((logits.argmax(dim=-1) == y).float() * tok_mask).sum(dim=dims)
    return (loss_sum / torch.clamp(count, min=1.0),
            {"loss_sum": loss_sum, "correct": correct, "count": count})


def make_seq_classification_spec(model, example_x=None, ignore_index=0,
                                 name="nwp", aux_loss_weight=0.01):
    """Per-token cross-entropy over ``[B, T, V]`` logits with padding-id
    masking (the reference NWP trainer's ``ignore_index=0``), for a
    :class:`~fedml_tpu_torch.models.transformer.TransformerLM`.

    ``init_fn(seed, device)`` draws the reference initialisers from a
    generator seeded with ``seed``. ``stacked_loss_fn`` trains K clients
    at once over the client axis the model writes out; ``seeds`` is
    accepted and unused (the model draws nothing). The training loss adds
    ``aux_loss_weight`` times the load-balancing loss the MoE model sows,
    per client (a model that sows nothing adds nothing); the metrics
    leave it out, as the reference's do. Labels are ``[n, T]`` next-token
    sequences: rank-1 labels (one next token a sample, the LEAF
    Shakespeare flavor) raise ``ValueError``, as they do in the
    reference. ``example_x`` is accepted for signature parity with the
    reference and unused."""
    del example_x
    sows = getattr(model, "sows_losses", False)

    def init_fn(seed, device):
        model.reset_parameters_(torch.Generator().manual_seed(int(seed)))
        return {"params": {k: v.detach().clone().to(device)
                           for k, v in model.named_parameters()}}

    def _loss(state, batch, stacked, with_sown):
        y = batch["y"]
        if y.dim() != batch["x"].dim():
            raise ValueError(
                f"sequence labels must be [..., n, T] like the tokens: got "
                f"labels {tuple(y.shape)} for tokens "
                f"{tuple(batch['x'].shape)} (one next token a sample, the "
                "LEAF Shakespeare flavor, does not train through the "
                "sequence spec, in the reference either)")
        out = model.apply_params(state["params"], batch["x"],
                                 stacked=stacked,
                                 with_sown=with_sown and sows)
        logits, aux = out if with_sown and sows else (out, None)
        loss, metrics = _seq_loss_and_metrics(
            logits, y, batch["mask"], ignore_index,
            (1, 2) if stacked else (0, 1))
        if aux is not None:
            loss = loss + aux_loss_weight * aux
        return loss, metrics

    def loss_fn(state, batch, train, seed=0):
        loss, metrics = _loss(state, batch, False, True)
        return loss, (state, metrics)

    def stacked_loss_fn(state, batch, train, seeds=None):
        loss, metrics = _loss(state, batch, True, True)
        return loss.sum(), (state, metrics)

    def metrics_fn(state, batch):
        with torch.no_grad():
            return _loss(state, batch, False, False)[1]

    return TrainSpec(init_fn=init_fn, loss_fn=loss_fn, metrics_fn=metrics_fn,
                     name=name, stacked_loss_fn=stacked_loss_fn,
                     kernels=tuple(getattr(model, "kernel_libraries", ())))


__all__ = ["make_classification_spec", "make_seq_classification_spec",
           "make_multilabel_spec", "make_segmentation_spec"]
