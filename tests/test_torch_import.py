"""torch<->flax ResNet checkpoint conversion (migration aid for reference
users' state_dict checkpoints; naming per fedml_api/model/cv/resnet.py)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np

from fedml_tpu import models
from fedml_tpu.utils.torch_import import (
    export_torch_resnet, load_torch_resnet)


def _flax_state(depth=20, seed=0):
    model = models.CifarResNet(depth=depth, num_classes=10)
    state = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)),
                       train=False)
    return model, dict(state)


def test_roundtrip_is_bit_exact():
    _, state = _flax_state(depth=20)
    sd = export_torch_resnet(state, depth=20)
    back = load_torch_resnet(sd, depth=20)
    flat_a = jax.tree_util.tree_leaves_with_path(
        {"params": state["params"], "batch_stats": state["batch_stats"]})
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    # same structure, bit-identical leaves
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_b[path]))


def test_imported_weights_drive_forward_pass():
    """An imported dict must apply() cleanly and change the output vs a
    fresh init (i.e. the weights actually landed)."""
    model, state = _flax_state(depth=20, seed=0)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(4, 32, 32, 3)).astype(np.float32))
    out_orig = model.apply(state, x, train=False)

    sd = export_torch_resnet(state, depth=20)
    # perturb one torch-side tensor; the perturbation must flow through
    sd["fc.bias"] = sd["fc.bias"] + 1.0
    imported = load_torch_resnet(sd, depth=20)
    out_new = model.apply(imported, x, train=False)
    np.testing.assert_allclose(np.asarray(out_new),
                               np.asarray(out_orig) + 1.0, atol=1e-5)


def test_torch_layout_conventions():
    """Exported tensors use torch layouts: conv OIHW, linear [out, in]."""
    _, state = _flax_state(depth=20)
    sd = export_torch_resnet(state, depth=20)
    hwio = state["params"]["conv1"]["kernel"].shape  # (3, 3, 3, 16)
    assert sd["conv1.weight"].shape == (hwio[3], hwio[2], hwio[0], hwio[1])
    assert sd["fc.weight"].shape == (10, 64)
    # downsample entries exist exactly at stage transitions
    assert "layer2.0.downsample.0.weight" in sd
    assert "layer1.0.downsample.0.weight" not in sd


def test_export_covers_torch_bn_buffers():
    """torch state_dicts carry num_batches_tracked per BN; strict
    load_state_dict on the torch side needs the exported dict to too."""
    _, state = _flax_state(depth=20)
    sd = export_torch_resnet(state, depth=20)
    for key in sd:
        if key.endswith(".running_mean"):
            bn = key[: -len(".running_mean")]
            assert f"{bn}.num_batches_tracked" in sd
    # and the roundtrip must tolerate (ignore) them
    load_torch_resnet(sd, depth=20)


def test_wrong_depth_fails_fast():
    _, state = _flax_state(depth=20)
    sd = export_torch_resnet(state, depth=20)
    try:
        load_torch_resnet(sd, depth=56)
    except KeyError:
        return
    raise AssertionError("expected KeyError for wrong-depth state_dict")
