"""One fp32 training step of the port's CV zoo against ``jax.grad`` of
the JAX package's flax module in fp32, at the narrowest configuration
each class accepts (ResNetGN ``stage_sizes=(1, 1, 1, 1)`` with the
bottleneck block, BatchNorm and the 7x7/2 stem, MobileNetV3 SMALL at
``multiplier=0.25``, EfficientNet ``width_coef=0.25``, VGG11 with
``classifier_dims=(64,)``), dropout and drop-connect at rate 0, from
the same weights (``zoo_cv_cases.py``).

Tolerance 1e-4 throughout: the loss absolute; the logits and the new
BatchNorm statistics relative to their largest magnitude; every
gradient relative to the model's largest |gradient| (the conv biases
before a BatchNorm have a gradient of 0 up to rounding, so no
per-tensor scale). At these inputs both frameworks' fp32 gradients are
within 3.3e-5 of float64 (XLA's, worst on EfficientNet) and 2e-5 (the
port's). Where XLA's fp32 strays -- the GroupNorm ResNet at 32x32,
3.7% of the largest |gradient| off its float64 in ``layer1_block0``
(ROADMAP §C) -- the port is held to float64 instead: GroupNorm's
gradients in ``test_torch_zoo_cv.py``, the fed CIFAR-100 round in
``test_torch_zoo_round.py``. Train-mode BatchNorm over two values is
ill-conditioned in fp32, so the inputs keep every BatchNorm at 8 values
or more."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu_torch.utils.torch_import import cv_variables_to_state
from zoo_cv_cases import NARROW, STEP_TOL, _Case, _close


def _jax_step(jm, variables, x, y):
    """Loss, logits, new batch statistics and gradients of one fp32
    training step of flax module ``jm`` (softmax cross-entropy)."""
    has_bs = "batch_stats" in variables

    def loss_fn(params):
        if has_bs:
            logits, mut = jm.apply({"params": params,
                                    "batch_stats": variables["batch_stats"]},
                                   x, train=True, mutable=["batch_stats"])
        else:
            logits, mut = jm.apply({"params": params}, x, train=True), {}
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, mut)

    (loss, (logits, mut)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return jax.tree.map(np.asarray, (loss, logits, mut, grads))


@pytest.mark.parametrize("name", sorted(NARROW))
def test_training_step_matches_jax_grad(name):
    jctor, tctor, shape = NARROW[name]
    case = _Case(jctor(), tctor(), shape, seed=1)
    y = np.array([3, 7])
    loss, logits, mut, grads = _jax_step(jctor(), case.variables,
                                         jnp.asarray(case.x), jnp.asarray(y))
    params = {k: v.clone().requires_grad_(True)
              for k, v in case.state["params"].items()}
    stats = {k: v.clone() for k, v in case.state["batch_stats"].items()}
    got_logits = torch.func.functional_call(
        case.tm, {**params, **stats}, (torch.as_tensor(case.x),),
        {"train": True})
    got_loss = torch.nn.functional.cross_entropy(got_logits,
                                                 torch.as_tensor(y))
    got_grads = dict(zip(params, torch.autograd.grad(got_loss,
                                                     list(params.values()))))
    assert abs(float(got_loss.detach()) - float(loss)) <= STEP_TOL
    _close(got_logits.detach().numpy(), logits, STEP_TOL, "logits")
    want = cv_variables_to_state({"params": grads, **mut})
    assert sorted(want["batch_stats"]) == sorted(stats)
    for k, v in want["batch_stats"].items():
        _close(stats[k].numpy(), v.numpy(), STEP_TOL, k)
    assert sorted(want["params"]) == sorted(got_grads)
    scale = max(float(g.abs().max()) for g in want["params"].values())
    for k, g in want["params"].items():
        err = float((got_grads[k] - g).abs().max())
        assert err <= STEP_TOL * scale, (k, err, scale)
