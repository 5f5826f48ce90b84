"""The port's CifarResNet module and weight carrier against the JAX
package: forward (eval and train, with the running statistics a train
step writes) on weights carried over from flax, and exact round trips of
the carrier, single and lane-stacked. Forward tolerance atol 1e-5: fp32
on both sides, convs in different implementations."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.utils.torch_import import (module_state,
                                                state_to_variables,
                                                variables_to_state)

DEPTH, H = 8, 16


def _jax_variables(seed=0):
    model = JaxResNet(depth=DEPTH, num_classes=10)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, H, 3)))
    return model, jax.tree.map(np.asarray, v)


def _load(state):
    model = CifarResNet(depth=DEPTH, num_classes=10)
    model.load_state_dict({**state["params"], **state["batch_stats"]},
                          strict=True)
    return model


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax(train):
    jmodel, v = _jax_variables()
    x = np.random.default_rng(3).normal(size=(6, H, H, 3)).astype(np.float32)
    if train:
        ref, mut = jmodel.apply(v, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    else:
        ref = jmodel.apply(v, jnp.asarray(x), train=False)
    model = _load(variables_to_state(v, DEPTH))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if train:
        back = state_to_variables(module_state(model), DEPTH)["batch_stats"]
        want = dict(jax.tree_util.tree_leaves_with_path(mut["batch_stats"]))
        got_l = jax.tree_util.tree_leaves_with_path(back)
        assert len(got_l) == len(want)
        for path, leaf in got_l:
            np.testing.assert_allclose(leaf, np.asarray(want[path]),
                                       atol=1e-5)


@pytest.mark.parametrize("lanes", [None, 3])
def test_weight_carrier_round_trip_is_exact(lanes):
    _, v = _jax_variables(seed=1)
    if lanes:
        v = jax.tree.map(lambda a: np.stack([a + i for i in range(lanes)]),
                         v)
    back = state_to_variables(variables_to_state(v, DEPTH), DEPTH)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


def test_carrier_names_are_the_module_state():
    _, v = _jax_variables()
    state = variables_to_state(v, DEPTH)
    mine = module_state(CifarResNet(depth=DEPTH))
    for part in ("params", "batch_stats"):
        assert set(state[part]) == set(mine[part])
        for k in state[part]:
            assert state[part][k].shape == mine[part][k].shape, k


def test_bf16_compute_keeps_fp32_logits_and_masters():
    model = CifarResNet(depth=DEPTH, dtype=torch.bfloat16)
    out = model(torch.randn(2, H, H, 3), train=True)
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.bn1.running_var.dtype == torch.float32
