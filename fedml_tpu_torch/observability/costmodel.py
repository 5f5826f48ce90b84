"""FLOPs counted from the ops a program runs (counterpart of
``fedml_tpu/observability/costmodel.py``).

The reference asks XLA's cost model of a compiled program. The port has
no compiled program to ask, so it runs the program once under
``torch.utils.flop_counter.FlopCounterMode`` on a CPU replica of its
inputs. On CPU tensors every kernel wrapper takes its plain PyTorch
version, so the counter sees the aten ops (products, convolutions,
attention) that the card's kernels replace; a ctypes kernel launch would
be invisible to it. Nothing here is timed, and nothing reads or draws
from a global random stream.

- :func:`program_flops` -- FLOPs of one call of a callable at given
  inputs (the reference's ``program_cost``, whose bytes the counter
  does not count).
- :func:`train_step_flops` -- FLOPs of ONE single-client local step of
  a ``TrainSpec`` + ``ClientUpdateConfig`` (the reference's
  ``train_step_cost``).
- :class:`CostModel` -- a default-off process global, as the tracer,
  registry and recorder are: when armed, ``BucketedStreamRunner``
  attributes FLOPs and FLOP-weighted padding waste to each bucket shape
  in its round info, and the ``enable()`` scope pushes the per-program
  catalog to the metrics sink on exit. Disabled cost: one module-global
  read per round.

A bucket's FLOPs are ``train_step_flops`` of one client's step, counted
once per runner (a step's shape does not depend on the bucket edge),
times the bucket's executed client-steps; the catalog notes each edge's
chunk program at one step across its ``client_chunk`` lanes, as the
reference's cost analysis charges a dynamic-trip loop body once.
"""

from __future__ import annotations

import threading

import torch
from torch.utils.flop_counter import FlopCounterMode

#: the record's name for where its FLOPs come from (the reference writes
#: ``"xla"`` in the bucket info and ``"xla-cost-model"`` in the bench)
FLOPS_SOURCE = "torch-flop-counter"


def program_flops(fn, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)``, run once under the flop counter
    (pass CPU tensors: a kernel launch on the card is invisible to it)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


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
    # lazy: the engine imports this module at its top
    from fedml_tpu_torch.parallel.engine import make_optimizer

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

    def step():
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

    return program_flops(step)


class CostModel:
    """Per-program FLOP catalog, armed through :func:`set_cost_model`.

    Instrumentation points (the bucketed stream runner) call
    :meth:`note` once per distinct program they attribute;
    :meth:`record` renders the catalog as a metrics-record fragment
    (``cost/<name>_flops``) that the ``enable()`` scope pushes to the
    metrics sink on exit. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.programs = {}  # name -> FLOPs of one call

    def note(self, name, flops):
        with self._lock:
            self.programs.setdefault(name, flops)
        return flops

    def record(self, prefix="cost/") -> dict:
        with self._lock:
            out = {prefix + "programs": len(self.programs)}
            for name, flops in sorted(self.programs.items()):
                out[prefix + name + "_flops"] = flops
        return out


_cost_model = None


def get_cost_model():
    """The process-wide cost model, or None when attribution is off --
    instrumentation points guard with ``if cm is not None``."""
    return _cost_model


def set_cost_model(cm):
    global _cost_model
    prev = _cost_model
    _cost_model = cm
    return prev


__all__ = ["FLOPS_SOURCE", "program_flops",
           "train_step_flops", "CostModel", "get_cost_model",
           "set_cost_model"]
