"""The trainer seam (counterpart of ``fedml_tpu/core/trainer.py``).

``TrainSpec`` bundles the model-specific functions an FL engine calls.
The port's state is ``{"params": {name: tensor}, "batch_stats": {name:
tensor}}`` with the torch ``state_dict`` names of the model
(``models/resnet.py``; ``{"params": ...}`` alone for the models without
BatchNorm: LR, the CNNs, the TransformerLM);
lane- or client-stacked state carries a leading axis on every leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Model-specific functions of one task.

    init_fn(seed, device) -> state
    loss_fn(state, batch, train, seed=0) -> (loss, (new_state, metrics))
        ``batch`` is ``{"x","y","mask"}``; masked samples contribute zero;
        ``seed`` seeds the dropout masks of models that have dropout.
    metrics_fn(state, batch) -> dict of summed metrics
    augment_fn
        optional train-time augmentation with explicit draws:
        ``augment_fn.draw(n, generator) -> draws`` and
        ``augment_fn(x, draws) -> x`` (``data/augment.py``).
    lane_loss_builder(n_lanes) -> lane_loss_fn
        ``lane_loss_fn(stacked_state, batch, rng, train) -> (loss_sum,
        (new_stacked_state, per_lane_metrics))`` over all lanes at once
        with the lane axis folded into channels (``models/lane_packed.py``).
    stacked_loss_fn(stacked_state, batch, train, seeds=None) -> (loss_sum,
        (new_stacked_state, per_client_metrics))
        K clients at once over a client axis: every leaf of the state and
        of ``batch`` (``x``/``y`` ``[K, B, ...]``, ``mask`` ``[K, B]``)
        leads with K, ``seeds [K]`` are the clients' step seeds (dropout
        masks); ``loss_sum`` is the sum of the K per-client losses, so one
        backward gives each client its own gradient (every client update
        of ``parallel/engine.py`` trains through it).
    kernels, lane_kernels
        names of the kernel libraries (``ops/_build.py``) the spec's
        training launches on a card through ``stacked_loss_fn`` and
        through the packed lowering: what the warmup
        (``fedml_tpu_torch/compile``) builds before the round loop.
    """
    init_fn: Callable[..., Any]
    loss_fn: Callable[..., Any]
    metrics_fn: Optional[Callable[..., Any]] = None
    name: str = "model"
    augment_fn: Optional[Any] = None
    lane_loss_builder: Optional[Callable[..., Any]] = None
    stacked_loss_fn: Optional[Callable[..., Any]] = None
    kernels: tuple = ()
    lane_kernels: tuple = ()


__all__ = ["TrainSpec"]
