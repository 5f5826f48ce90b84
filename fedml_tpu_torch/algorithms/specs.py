"""TrainSpec builders (counterpart of ``fedml_tpu/algorithms/specs.py``:
``make_classification_spec`` and ``make_seq_classification_spec``).

Softmax cross-entropy over logits; metrics are sums (``loss_sum``,
``correct``, ``count``) that the host divides.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from fedml_tpu_torch.core.trainer import TrainSpec
from fedml_tpu_torch.models.lane_packed import LOWERINGS, builder_for
from fedml_tpu_torch.models.resnet import init_resnet_
from fedml_tpu_torch.utils.torch_import import module_state


def _loss_and_metrics(logits, y, mask):
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_sample = -logp.gather(1, y.long()[:, None])[:, 0]
    count = mask.sum()
    loss = (per_sample * mask).sum() / torch.clamp(count, min=1.0)
    correct = ((logits.argmax(dim=-1) == y).float() * mask).sum()
    return loss, {"loss_sum": (per_sample * mask).sum(), "correct": correct,
                  "count": count}


def make_classification_spec(model, example_x=None, num_classes=None,
                             name="classification", augment_fn=None,
                             lane_lowering=None):
    """Spec for a classification ``nn.Module`` taking NHWC batches.

    ``init_fn(seed, device)`` draws the reference initialisers from a
    generator seeded with ``seed``; ``loss_fn``/``metrics_fn`` apply the
    model functionally on a state; ``lane_loss_builder`` is the packed
    lowering (``models/lane_packed.py``) picked by ``lane_lowering``.
    ``example_x`` and ``num_classes`` are accepted for signature parity
    with the reference and unused: a torch module knows its shapes."""
    del example_x, num_classes
    if lane_lowering not in (None,) + LOWERINGS:
        raise ValueError(f"unknown lane_lowering {lane_lowering!r}; "
                         "choose blockdiag, bgc, auto or pallas")

    def init_fn(seed, device):
        gen = torch.Generator().manual_seed(int(seed))
        init_resnet_(model, gen)
        return {k: {n: t.to(device) for n, t in v.items()}
                for k, v in module_state(model).items()}

    def _apply(state, x, train):
        tensors = {**state["params"], **state["batch_stats"]}
        # the module writes updated running stats into the buffers it is
        # given: hand it copies so the caller's state stays untouched
        if train:
            tensors.update({k: v.clone()
                            for k, v in state["batch_stats"].items()})
        logits = functional_call(model, tensors, (x,), {"train": train})
        new_state = {"params": state["params"],
                     "batch_stats": {k: tensors[k].detach()
                                     for k in state["batch_stats"]}}
        return logits, new_state

    def loss_fn(state, batch, train):
        logits, new_state = _apply(state, batch["x"], train)
        loss, metrics = _loss_and_metrics(logits, batch["y"], batch["mask"])
        return loss, (new_state, metrics)

    def metrics_fn(state, batch):
        with torch.no_grad():
            logits, _ = _apply(state, batch["x"], False)
            return _loss_and_metrics(logits, batch["y"], batch["mask"])[1]

    return TrainSpec(init_fn=init_fn, loss_fn=loss_fn, metrics_fn=metrics_fn,
                     name=name, augment_fn=augment_fn,
                     lane_loss_builder=builder_for(model,
                                                   lowering=lane_lowering))


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


def make_seq_classification_spec(model, ignore_index=0, name="nwp"):
    """Per-token cross-entropy over ``[B, T, V]`` logits with padding-id
    masking (the reference NWP trainer's ``ignore_index=0``), for a
    :class:`~fedml_tpu_torch.models.transformer.TransformerLM`.

    ``init_fn(seed, device)`` draws the reference initialisers from a
    generator seeded with ``seed``. ``stacked_loss_fn`` trains K clients
    at once (the streamed client update). The dense model sows no
    auxiliary loss; the reference's ``aux_loss_weight`` comes with the
    MoE model (ROADMAP A10)."""

    def init_fn(seed, device):
        model.reset_parameters_(torch.Generator().manual_seed(int(seed)))
        return {"params": {k: v.detach().clone().to(device)
                           for k, v in model.named_parameters()}}

    def loss_fn(state, batch, train):
        logits = model.apply_params(state["params"], batch["x"])
        loss, metrics = _seq_loss_and_metrics(
            logits, batch["y"], batch["mask"], ignore_index, (0, 1))
        return loss, (state, metrics)

    def stacked_loss_fn(state, batch, train):
        logits = model.apply_params(state["params"], batch["x"],
                                    stacked=True)
        loss, metrics = _seq_loss_and_metrics(
            logits, batch["y"], batch["mask"], ignore_index, (1, 2))
        return loss.sum(), (state, metrics)

    def metrics_fn(state, batch):
        with torch.no_grad():
            return loss_fn(state, batch, False)[1][1]

    return TrainSpec(init_fn=init_fn, loss_fn=loss_fn, metrics_fn=metrics_fn,
                     name=name, stacked_loss_fn=stacked_loss_fn)


__all__ = ["make_classification_spec", "make_seq_classification_spec"]
