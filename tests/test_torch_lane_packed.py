"""The port's lane-packed ResNet (fedml_tpu_torch/models/lane_packed.py)
held against the JAX package's ``make_lane_packed_apply`` on the same
lane-stacked weights and inputs: all four lowerings, train and eval,
logits and BatchNorm statistics. Depth 8, L=4, fp32; tolerance atol
1e-5 (fp32 convs in different implementations), the reference's own
packed-vs-vmap tolerance."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.lane_packed import (
    make_lane_packed_apply as jax_packed_apply)
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu_torch.models.lane_packed import (
    _lanes_per_group, lane_merge, lane_unmerge, make_lane_packed_apply,
    merged_to_stacked)
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.utils.torch_import import (state_to_variables,
                                                variables_to_state)

L, B, H, DEPTH = 4, 8, 16, 8


def _stacked_variables(seed=1):
    model = JaxResNet(depth=DEPTH, num_classes=10)
    keys = jax.random.split(jax.random.PRNGKey(seed), L)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[
        model.init(k, jnp.zeros((1, H, H, 3))) for k in keys])
    # running stats away from their init, so eval mode reads them
    rng = np.random.default_rng(seed)
    stacked["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        stacked["batch_stats"])
    return model, stacked


@pytest.mark.parametrize("lowering", ["blockdiag", "bgc", "auto", "pallas"])
@pytest.mark.parametrize("train", [False, True])
def test_packed_apply_matches_jax(train, lowering):
    jmodel, stacked = _stacked_variables()
    x = np.random.default_rng(2).normal(size=(L, B, H, H, 3)).astype(
        np.float32)
    ref_logits, ref_bs = jax_packed_apply(jmodel, L, lowering)(
        stacked, jnp.asarray(x), train=train)

    state = variables_to_state(stacked, DEPTH)
    apply = make_lane_packed_apply(CifarResNet(depth=DEPTH), L, lowering)
    with torch.no_grad():
        logits, new_bs = apply(state, torch.from_numpy(x), train)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-5)
    got_bs = state_to_variables({"params": state["params"],
                                 "batch_stats": new_bs}, DEPTH)
    want = jax.tree_util.tree_leaves_with_path(ref_bs)
    got = dict(jax.tree_util.tree_leaves_with_path(got_bs["batch_stats"]))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=1e-5)


def test_merge_layouts_roundtrip():
    x = torch.randn(3, 2, 5, 4, 4)
    m = lane_merge(x)
    assert m.shape == (2, 15, 4, 4)
    torch.testing.assert_close(lane_unmerge(m, 3), x, rtol=0, atol=0)
    torch.testing.assert_close(merged_to_stacked(m, 3),
                               x.reshape(6, 5, 4, 4), rtol=0, atol=0)


def test_lanes_per_group_matches_reference():
    from fedml_tpu.models.lane_packed import _lanes_per_group as jax_lpg

    for lanes in (1, 2, 4, 6, 8):
        for ci in (3, 16, 32, 64, 128):
            assert _lanes_per_group(lanes, ci) == jax_lpg(lanes, ci)
