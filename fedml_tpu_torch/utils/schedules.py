"""Learning-rate schedules with FedSeg's semantics (counterpart of
``fedml_tpu/utils/schedules.py``):

  step:   lr * 0.1^(epoch // lr_step)
  cos:    0.5 * lr * (1 + cos(pi * T / N))
  poly:   lr * (1 - T/N)^0.9

with linear warmup over ``warmup_epochs`` epochs, where T is the local
iteration and N = num_epochs * iters_per_epoch; T is clamped at N. The
schedule is a ``fn(step) -> lr`` that the local SGD takes as its ``lr``
(``parallel/engine.py`` ``SGD`` then counts steps per client, from 0
at each round), so it spans one round's local training.

The arithmetic runs in fp32 as the reference's ``jnp`` does: ``step``
may be an int, an array or a tensor of counts (one a client), and the
result is an fp32 tensor of the same shape.
"""

from __future__ import annotations

import math

import torch


def make_lr_schedule(mode, base_lr, num_epochs, iters_per_epoch,
                     lr_step=0, warmup_epochs=0):
    if mode == "step" and not lr_step:
        raise ValueError("step mode requires lr_step")
    if mode not in ("cos", "poly", "step"):
        raise ValueError(f"unknown schedule mode {mode}")
    N = max(1, num_epochs * iters_per_epoch)
    warmup_iters = warmup_epochs * iters_per_epoch
    f32 = torch.float32

    def schedule(step):
        # clamp past the horizon: cos would otherwise climb back toward
        # base_lr and poly would go negative for T > N
        T = torch.clamp(torch.as_tensor(step).to(f32), max=float(N))
        const = lambda v: torch.tensor(v, dtype=f32, device=T.device)
        if mode == "cos":
            lr = 0.5 * base_lr * (1 + torch.cos(const(math.pi) * T / N))
        elif mode == "poly":
            lr = base_lr * torch.pow(torch.clamp(1.0 - T / N, 0.0, 1.0),
                                     0.9)
        else:
            epoch = torch.floor(T / iters_per_epoch)
            lr = base_lr * torch.pow(const(0.1),
                                     torch.floor(epoch / lr_step))
        if warmup_iters > 0:
            lr = torch.where(T < warmup_iters, lr * T / warmup_iters, lr)
        return lr

    return schedule


__all__ = ["make_lr_schedule"]
