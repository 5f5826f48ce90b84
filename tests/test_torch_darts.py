"""The DARTS search space against the JAX package on the CPU: every op
(each at stride 1 and 2 over even and odd sides, where flax's ``"SAME"``
pads (0, 1) or (1, 2), dilated kernels by their effective size, max
pools with -inf and average pools over the in-bounds count) in train and
eval mode, the search network's logits (C 4, 3 layers, 1 step a cell,
8x8 images; 2 steps in the slow tier), the fixed network (DARTS_V1 at
C 4, 3 layers) at drop path 0, the carrier's round trip
with the ``arch`` collection (exact), and ``derive_genotype`` (equal).
Tolerance 3e-5 (fp32 reassociation through BatchNorm). ``models/
layers.py``'s ``same_pad``, ``same_conv2d`` and the ``"SAME"`` pools
against ``lax.conv_general_dilated`` and flax's pools within 1e-5.

The reference's jax-free case of ``tests/test_fednas.py`` runs
retargeted at the port; its model cases whose bodies call jax have
counterparts here with the same asserts (the search rounds' are in
``test_torch_fednas.py``)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from reference_scenarios import retarget
from seeded_variables import seeded_variables

from fedml_tpu.models import darts as jdarts
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.models import darts
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

TOL = 3e-5
C_, LAYERS, STEPS, HW = 4, 3, 2, 8

# -- the reference's own case, through the port -------------------------------
_nas = retarget("test_fednas.py")
test_genotype_derivation_valid = _nas.test_genotype_derivation_valid


def test_the_retargeted_scenarios_run_the_port():
    assert _nas.derive_genotype is darts.derive_genotype


# -- ops ----------------------------------------------------------------------

class _Op(nn.Module):
    primitive: str
    stride: int

    @nn.compact
    def __call__(self, x, train):
        return jdarts.make_op(self.primitive, x.shape[-1], self.stride,
                              name="op")(x, train)


def _apply_port(model, state, x, train):
    tensors = {**state["params"], **state.get("arch", {}),
               **{k: v.clone() for k, v in state["batch_stats"].items()}}
    with torch.no_grad():
        return functional_call(model, tensors, (torch.as_tensor(x),),
                               {"train": train})


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("side", [8, 7])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("primitive", darts.PRIMITIVES)
def test_op_is_the_reference(primitive, stride, side):
    x = np.random.default_rng(0).normal(size=(3, side, side, C_)).astype(
        np.float32)
    jm = _Op(primitive, stride)
    v = {k: c["op"] for k, c in seeded_variables(jm, x, 1,
                                                  train=False).items()}
    state = cv_variables_to_state(v)
    op = darts.make_op(primitive, C_, stride)
    assert sorted(op.state_dict()) == sorted(
        list(state["params"]) + list(state["batch_stats"]))
    for train in (True, False):
        wrapped = {k: {"op": c} for k, c in v.items()}
        if train:
            want, _ = jm.apply(wrapped, jnp.asarray(x), True,
                               mutable=["batch_stats"])
        else:
            want = jm.apply(wrapped, jnp.asarray(x), False)
        op.train(train)
        tensors = {**state["params"], **{k: t.clone() for k, t in
                                         state["batch_stats"].items()}}
        with torch.no_grad():
            got = functional_call(op, tensors, (_nchw(x),))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=TOL)


# -- networks -----------------------------------------------------------------

def _x(n=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, HW, HW, 3)).astype(
        np.float32)


def _carried(jm, x):
    v = seeded_variables(jm, x, train=False)
    if "arch" in v:  # alphas a softmax apart, not 1e-3 (ties otherwise)
        rng = np.random.default_rng(7)
        v["arch"] = {k: rng.normal(size=a.shape).astype(np.float32)
                     for k, a in v["arch"].items()}
    return v


@pytest.mark.parametrize("name,steps", [
    ("search", 1), ("fixed", STEPS),
    # flax runs the 120 ops of this search network eagerly in about 25 s
    pytest.param("search", STEPS, marks=pytest.mark.slow)])
def test_network_logits_and_carrier_are_the_reference(name, steps):
    x = _x()
    if name == "search":
        jm = jdarts.DARTSNetwork(C=C_, layers=LAYERS, num_classes=4,
                                 steps=steps)
        model = darts.DARTSNetwork(C=C_, layers=LAYERS, num_classes=4,
                                   steps=steps)
    else:
        jm = jdarts.DARTSFixedNetwork(C=C_, layers=LAYERS, num_classes=4)
        model = darts.DARTSFixedNetwork(C=C_, layers=LAYERS, num_classes=4)
    v = _carried(jm, x)
    state = cv_variables_to_state(v)
    assert ("arch" in state) == (name == "search")
    rt = cv_state_to_variables(state)
    assert jax.tree.structure(rt) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(rt), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    for train in (True, False):
        if train:
            want, _ = jm.apply(v, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        else:
            want = jm.apply(v, jnp.asarray(x), train=False)
        got = _apply_port(model, state, x, train)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("seed", range(6))
def test_derive_genotype_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    k = darts.n_edges(4)
    arch = {"alphas_normal": rng.normal(size=(k, 8)),
            "alphas_reduce": rng.normal(size=(k, 8)) * 1e-3}
    want = jdarts.derive_genotype(arch)
    assert darts.derive_genotype(arch) == want
    assert darts.derive_genotype(
        {n: torch.as_tensor(a, dtype=torch.float32)
         for n, a in arch.items()}) == want


# -- counterparts of test_fednas.py's cases that call jax ---------------------

def test_search_network_forward_and_collections():
    model = darts.DARTSNetwork(C=4, layers=2, num_classes=4, steps=2)
    state = make_classification_spec(model).init_fn(0, "cpu")
    assert set(state) >= {"params", "arch", "batch_stats"}
    k = darts.n_edges(2)
    assert state["arch"]["alphas_normal"].shape == (k, len(darts.PRIMITIVES))
    out = _apply_port(model, state, np.zeros((2, 8, 8, 3), np.float32),
                      False)
    assert out.shape == (2, 4)


def test_fixed_network_from_genotype():
    model = darts.DARTSFixedNetwork(genotype=darts.DARTS_V1, C=8, layers=3,
                                    num_classes=4, drop_path_prob=0.2)
    x = torch.zeros((2, 8, 8, 3))
    out = model(x, train=False)
    assert out.shape == (2, 4)
    masks = model.draw_dropout_masks(2, torch.Generator().manual_seed(1))
    out2 = model(x, train=True, dropout_masks=masks)
    assert torch.isfinite(out2).all()


# -- flax's "SAME" padding ----------------------------------------------------

@pytest.mark.parametrize("side", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel,dilation", [(3, 1), (5, 1), (3, 2),
                                             (5, 2), (1, 1)])
def test_same_pad_is_flax_same(side, stride, kernel, dilation):
    """``same_pad`` against ``lax.conv_general_dilated(..., "SAME")`` and
    ``same_conv2d`` (which hands a symmetric pad to the convolution),
    and the two pools against ``nn.max_pool`` / ``nn.avg_pool(
    count_include_pad=False)`` (3x3 windows), at odd and even sides."""
    from fedml_tpu_torch.models import layers
    rng = np.random.default_rng(side + 10 * stride + kernel + dilation)
    x = rng.normal(size=(2, side, side, 3)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    wt = torch.as_tensor(w).permute(3, 2, 0, 1)
    padded = layers.same_pad(xt, kernel, stride, dilation)
    got = torch.nn.functional.conv2d(padded, wt, None, stride, 0, dilation)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    conv = torch.nn.Conv2d(3, 4, kernel, stride=stride, dilation=dilation,
                           bias=False)
    with torch.no_grad():
        conv.weight.copy_(wt)
        via = layers.same_conv2d(conv, xt, torch.float32)
    np.testing.assert_allclose(via.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    if kernel == 3 and dilation == 1:
        for pool, jpool in (
                (layers.max_pool_same, lambda a: nn.max_pool(
                    a, (3, 3), strides=(stride, stride), padding="SAME")),
                (layers.avg_pool_same, lambda a: nn.avg_pool(
                    a, (3, 3), strides=(stride, stride), padding="SAME",
                    count_include_pad=False))):
            np.testing.assert_allclose(
                pool(xt, 3, stride).permute(0, 2, 3, 1).numpy(),
                np.asarray(jpool(jnp.asarray(x))), atol=1e-6)
        # the -inf pad never wins a max, even over all-negative windows
        neg = layers.max_pool_same(-torch.abs(xt) - 1.0, 3, stride)
        assert bool((neg < -1.0 + 1e-6).all())


@pytest.mark.parametrize("stride,dilation,groups", [(1, 1, 1), (2, 1, 1),
                                                    (1, 2, 4), (2, 2, 4),
                                                    (2, 1, 4)])
def test_conv2d_twice_is_conv2d_to_second_order(stride, dilation, groups):
    """``conv2d_twice``'s value, gradients and second-order gradients
    (the gradient of a function of the first gradients, as the unrolled
    arch step takes it) equal ``F.conv2d``'s within 1e-5."""
    from fedml_tpu_torch.models.layers import conv2d_twice
    g = torch.Generator().manual_seed(stride + 3 * dilation + groups)
    x0 = torch.randn(2, 4, 9, 9, generator=g, dtype=torch.float64)
    w0 = torch.randn(6 if groups == 1 else 4, 4 // groups, 3, 3,
                     generator=g, dtype=torch.float64)
    out = {}
    for name, fn in (("native", torch.nn.functional.conv2d),
                     ("twice", conv2d_twice)):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        y = fn(x, w, None, stride, 1, dilation, groups)
        r = torch.sin(torch.arange(y.numel(), dtype=y.dtype)).reshape(y.shape)
        gx, gw = torch.autograd.grad((y * r).sum() + (y * y).sum(), (x, w),
                                     create_graph=True)
        s = (gx.sin()).sum() + (gw * gw).sum()
        hx, hw = torch.autograd.grad(s, (x, w))
        out[name] = (y, gx, gw, hx, hw)
    for a, b in zip(out["native"], out["twice"]):
        torch.testing.assert_close(b, a, rtol=1e-7, atol=1e-5)


def test_only_the_search_network_convolves_through_conv2d_twice():
    """The search network's ops run ``conv2d_twice`` (its second-order
    step differentiates through each weight gradient); the fixed
    network's run ``F.conv2d``, which maps under the engine's ``vmap``."""
    from fedml_tpu_torch.models.layers import conv2d_twice
    search = darts.DARTSNetwork(C=4, layers=3, num_classes=4, steps=2)
    fixed = darts.DARTSFixedNetwork(darts.DARTS_V1, C=4, layers=3,
                                    num_classes=4)
    ops = lambda net: [m for m in net.modules()
                       if isinstance(m, darts._ConvOp)]
    assert ops(search) and ops(fixed)
    assert all(m.conv is conv2d_twice for m in ops(search))
    assert all(m.conv is torch.nn.functional.conv2d for m in ops(fixed))
