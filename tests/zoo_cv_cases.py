"""Shared configurations of the CV-zoo conformance tests
(``test_torch_zoo_cv.py``, ``test_torch_zoo_cv_step.py``): both
frameworks' modules for each configuration, a seeded port state carried
to flax and checked against ``jax.eval_shape`` of flax's init, and the
tolerance check."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fedml_tpu import models as J
from fedml_tpu_torch import models as T
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                module_state)

LOGIT_TOL, STEP_TOL, BF16_TOL = 1e-5, 1e-4, 0.1

#: full-width configurations: (flax module, port module, input shape)
FULL = {
    "resnet18_gn": (lambda: J.resnet18_gn(class_num=100),
                    lambda **kw: T.resnet18_gn(class_num=100, **kw),
                    (2, 32, 32, 3)),
    "resnet50_gn_large_stem": (
        lambda: J.resnet50_gn(class_num=10, small_input=False),
        lambda **kw: T.resnet50_gn(class_num=10, small_input=False, **kw),
        (2, 32, 32, 3)),
    "mobilenet": (lambda: J.MobileNet(num_classes=10),
                  lambda **kw: T.MobileNet(num_classes=10, **kw),
                  (2, 32, 32, 3)),
    "mobilenet_v3_large": (
        lambda: J.MobileNetV3("LARGE", num_classes=10),
        lambda **kw: T.MobileNetV3("LARGE", num_classes=10, **kw),
        (2, 32, 32, 3)),
    "mobilenet_v3_small": (
        lambda: J.MobileNetV3("SMALL", num_classes=10),
        lambda **kw: T.MobileNetV3("SMALL", num_classes=10, **kw),
        (2, 32, 32, 3)),
    "efficientnet_b0": (
        lambda: J.efficientnet("efficientnet-b0", num_classes=10),
        lambda **kw: T.efficientnet("efficientnet-b0", num_classes=10, **kw),
        (2, 32, 32, 3)),
    "vgg16_bn_64px": (
        lambda: J.vgg16(class_num=10, batch_norm=True),
        lambda **kw: T.vgg16(class_num=10, batch_norm=True,
                             input_shape=(64, 64, 3), **kw),
        (2, 64, 64, 3)),
}

#: the narrowest configuration of each class, dropout at rate 0, with
#: its input: (flax module, port module, input shape). 64x64 where a
#: BatchNorm would otherwise see batch 2 at 1x1 (an ill-conditioned
#: normalisation of two values)
NARROW = {
    "resnet_bottleneck_bn_large_stem": (
        lambda: J.ResNetGN(stage_sizes=(1, 1, 1, 1), block="bottleneck",
                           num_classes=10, group_norm=0, small_input=False),
        lambda: T.ResNetGN(stage_sizes=(1, 1, 1, 1), block="bottleneck",
                           num_classes=10, group_norm=0, small_input=False),
        (2, 64, 64, 3)),
    "mobilenet_v3_small": (
        lambda: J.MobileNetV3("SMALL", num_classes=10, multiplier=0.25),
        lambda: T.MobileNetV3("SMALL", num_classes=10, multiplier=0.25),
        (2, 64, 64, 3)),
    "efficientnet": (
        lambda: J.EfficientNet(num_classes=10, width_coef=0.25,
                               dropout_rate=0.0, drop_connect_rate=0.0),
        lambda: T.EfficientNet(num_classes=10, width_coef=0.25,
                               dropout_rate=0.0, drop_connect_rate=0.0),
        (2, 64, 64, 3)),
    "vgg11": (
        lambda: J.vgg11(class_num=10, classifier_dims=(64,),
                        dropout_rate=0.0),
        lambda: T.vgg11(class_num=10, classifier_dims=(64,),
                        dropout_rate=0.0),
        (2, 32, 32, 3)),
}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _perturbed_state(model, seed):
    """A seeded state of ``model``: every kernel normal with variance
    1/fan-in (flax's lecun scale, untruncated: faster to draw), every
    1-D parameter (norm scales and biases, dense and conv biases) and
    the running statistics moved off their constructor values, so that
    the comparisons see them."""
    state = module_state(model)
    gen = torch.Generator().manual_seed(seed)
    for part in ("params", "batch_stats"):
        for k, v in state[part].items():
            n = torch.randn(v.shape, generator=gen)
            if v.dim() > 1:
                state[part][k] = n / (v[0].numel() ** 0.5)
            elif k.endswith("running_var"):
                state[part][k] = 0.5 + n.abs()
            elif k.endswith(".weight"):
                state[part][k] = 1.0 + 0.1 * n
            else:
                state[part][k] = 0.1 * n
    return state


class _Case:
    """One configuration: both modules, the port state and its flax
    variables (checked against ``jax.eval_shape`` of flax's init)."""

    def __init__(self, jm, tm, shape, seed=0):
        self.jm, self.tm, self.x = jm, tm, _x(shape, seed)
        self.state = _perturbed_state(tm, seed)
        self.variables = cv_state_to_variables(self.state)
        abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  jnp.asarray(self.x))
        assert (jax.tree.structure(self.variables)
                == jax.tree.structure(abstract))
        for got, want in zip(jax.tree.leaves(self.variables),
                             jax.tree.leaves(abstract)):
            assert got.shape == want.shape
        self.flax_count = sum(int(np.prod(a.shape)) for a in
                              jax.tree.leaves(abstract["params"]))

    def port(self, x=None, train=False, dtype_model=None, **kw):
        """Port logits (and the new running statistics) on this state."""
        model = dtype_model or self.tm
        stats = {k: v.clone() for k, v in self.state["batch_stats"].items()}
        with torch.no_grad():
            out = torch.func.functional_call(
                model, {**self.state["params"], **stats},
                (torch.as_tensor(self.x if x is None else x),),
                {"train": train, **kw})
        return out, stats


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


