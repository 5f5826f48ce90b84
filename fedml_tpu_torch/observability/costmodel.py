"""FLOPs of one local training step, counted from the ops it runs
(counterpart of ``train_step_cost`` in
``fedml_tpu/observability/costmodel.py``).

The reference asks XLA's cost model of the compiled step. The port has
no compiled program to ask, so :func:`train_step_flops` runs the step
once under ``torch.utils.flop_counter.FlopCounterMode`` on a CPU replica
of the model state. On CPU tensors every kernel wrapper takes its plain
PyTorch version, so the counter sees the aten ops (products,
convolutions, attention) that the card's kernels replace; a ctypes
kernel launch would be invisible to it. Nothing here is timed.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from fedml_tpu_torch.parallel.engine import make_optimizer

#: the record's name for where its FLOPs come from (the reference writes
#: ``"xla-cost-model"``)
FLOPS_SOURCE = "torch-flop-counter"


def train_step_flops(spec, cfg, batch_shapes, seed=0):
    """FLOPs of ONE single-client local step for ``spec``/``cfg`` -- the
    step the engine runs for each client: the spec's augmentation (when
    present), the loss's forward and backward, and the optimizer update
    (fresh optimizer state, as every client update starts).

    ``batch_shapes``: ``{"x", "y", "mask"}`` to ``(shape, dtype)``. The
    state comes from ``spec.init_fn(seed, "cpu")`` and the batch is
    zeros with a full mask: the count depends on shapes only. Divide by
    the batch size (and sequence length) for per-sample (per-token)
    FLOPs."""
    cpu = torch.device("cpu")
    optimizer = make_optimizer(cfg)
    state = spec.init_fn(seed, cpu)
    batch = {k: torch.zeros(shape, dtype=dtype, device=cpu)
             for k, (shape, dtype) in batch_shapes.items()}
    batch["mask"] = torch.ones_like(batch["mask"])
    params = {k: v.detach().requires_grad_(True)
              for k, v in state["params"].items()}
    step_state = dict(state)
    step_state["params"] = params
    with FlopCounterMode(display=False) as counter:
        opt_state = optimizer.init(params)
        if spec.augment_fn is not None:
            n, H, W = batch["x"].shape[:3]
            draws = spec.augment_fn.draw(
                n, H, W, torch.Generator(device=cpu).manual_seed(seed))
            batch["x"] = spec.augment_fn(batch["x"], draws)
        loss, _ = spec.loss_fn(step_state, batch, True)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            optimizer.update(dict(zip(params, grads)), opt_state, params)
    return float(counter.get_total_flops())


__all__ = ["FLOPS_SOURCE", "train_step_flops"]
