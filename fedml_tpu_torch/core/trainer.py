"""The trainer seam (counterpart of ``fedml_tpu/core/trainer.py``).

``TrainSpec`` bundles the model-specific functions an FL engine calls.
The port's state is ``{"params": {name: tensor}, "batch_stats": {name:
tensor}}`` with the torch ``state_dict`` names of the model
(``models/resnet.py``); lane-stacked state carries a leading lane axis on
every leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Model-specific functions of one task.

    init_fn(seed, device) -> state
    loss_fn(state, batch, train) -> (loss, (new_state, metrics))
        ``batch`` is ``{"x","y","mask"}``; masked samples contribute zero.
    metrics_fn(state, batch) -> dict of summed metrics
    augment_fn
        optional train-time augmentation with explicit draws:
        ``augment_fn.draw(n, generator) -> draws`` and
        ``augment_fn(x, draws) -> x`` (``data/augment.py``).
    lane_loss_builder(n_lanes) -> lane_loss_fn
        ``lane_loss_fn(stacked_state, batch, rng, train) -> (loss_sum,
        (new_stacked_state, per_lane_metrics))`` over all lanes at once
        with the lane axis folded into channels (``models/lane_packed.py``).
    """
    init_fn: Callable[..., Any]
    loss_fn: Callable[..., Any]
    metrics_fn: Optional[Callable[..., Any]] = None
    name: str = "model"
    augment_fn: Optional[Any] = None
    lane_loss_builder: Optional[Callable[..., Any]] = None


__all__ = ["TrainSpec"]
