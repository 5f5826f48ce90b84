"""The depth-8 ResNet through every single-device round path against
the JAX ``FedAvgAPI`` (the configuration, tolerances and helpers of
``test_torch_rounds.py``), the port's modes 0, 1 and 2 against one
another with augmentation on, and the conditioning of a zero-padded
BatchNorm step that sets the host-packed ResNet's data."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest
import torch

from fedml_tpu.data.synthetic import load_synthetic_images
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.data.augment import make_cifar_augment
from fedml_tpu_torch.models.resnet import CifarResNet
from test_torch_rounds import H, PATHS, _args, check_rounds, run_paths


@pytest.fixture(scope="module")
def runs():
    return run_paths(("resnet",))


@pytest.mark.parametrize("mode,resident", PATHS)
def test_resnet_rounds_match_jax_fedavg(runs, mode, resident):
    check_rounds(runs[("resnet", mode, resident)])


def test_resnet_mode_3_packs_lanes(runs):
    _, _, _, api = runs[("resnet", 3, "auto")]
    assert api.packed_lane_runner is not None and api.device_data is not None


def test_host_packed_path_keeps_no_resident_shards(runs):
    _, _, _, api = runs[("resnet", 1, "0")]
    assert api.device_data is None and api._last_trip is None


def _augmented_round(mode):
    dataset = load_synthetic_images(client_num=4, n_train=150, n_test=40,
                                    image_size=H, partition="hetero",
                                    partition_alpha=0.5, seed=0)
    spec = make_classification_spec(
        CifarResNet(depth=8), augment_fn=make_cifar_augment(
            pad=2, cutout_length=4))
    api = FedAvgAPI(dataset, spec, _args(mode, "auto"), device="cpu")
    api.metrics = api.train_one_round()
    return api


@pytest.fixture(scope="module")
def augmented():
    return {mode: _augmented_round(mode) for mode in (0, 1, 2)}


@pytest.mark.parametrize("mode", [0, 2])
def test_modes_agree_with_augmentation_on(augmented, mode):
    """Modes 0 and 2 against waves (mode 1), augmentation on: the same
    draws per (client, local step), so the global states agree to float
    reassociation (1e-5) and the train metrics too."""
    ref, got = augmented[1], augmented[mode]
    for part, leaves in ref.global_state.items():
        for k, v in leaves.items():
            torch.testing.assert_close(got.global_state[part][k], v,
                                       rtol=0, atol=1e-5)
    for k in ("Train/Loss", "Train/Acc"):
        np.testing.assert_allclose(got.metrics[k], ref.metrics[k],
                                   atol=1e-4)


def test_augmentation_changes_the_round():
    """The draws reach the step: a round with augmentation differs from
    one without."""
    plain = FedAvgAPI(
        load_synthetic_images(client_num=4, n_train=150, n_test=40,
                              image_size=H, partition="hetero", seed=0),
        make_classification_spec(CifarResNet(depth=8)), _args(1, "auto"),
        device="cpu")
    plain.train_one_round()
    aug = _augmented_round(1)
    diff = max(float((aug.global_state["params"][k] - v).abs().max())
               for k, v in plain.global_state["params"].items())
    assert diff > 1e-4


_FP64_CHECK = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np, torch
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.utils.torch_import import (state_to_variables,
                                                variables_to_state)
H = 8
init = jax.tree.map(np.array, jax_spec(
    JaxResNet(depth=8), jnp.zeros((1, H, H, 3), jnp.float32)).init_fn(
    jax.random.PRNGKey(0)))
rng = np.random.default_rng(14)
x = np.zeros((16, H, H, 3), np.float32)
x[:14] = rng.normal(size=(14, H, H, 3))
y = rng.integers(0, 10, 16)
m = (np.arange(16) < 14).astype(np.float32)
jg = {}
for dt in (jnp.float32, jnp.float64):
    spec = jax_spec(JaxResNet(depth=8, dtype=dt), jnp.zeros((1, H, H, 3), dt))
    st = jax.tree.map(lambda a: jnp.asarray(a, dt), init)
    def loss(p):
        s = dict(st)
        s["params"] = p
        return spec.loss_fn(s, {"x": jnp.asarray(x, dt), "y": jnp.asarray(y),
                                "mask": jnp.asarray(m, dt)}, None, True)[0]
    jg[dt] = jax.grad(loss)(st["params"])
spec = make_classification_spec(CifarResNet(depth=8))
st = variables_to_state(init, 8)
params = {k: v.requires_grad_(True) for k, v in st["params"].items()}
st["params"] = params
loss, _ = spec.loss_fn(st, {"x": torch.as_tensor(x), "y": torch.as_tensor(y),
                            "mask": torch.as_tensor(m)}, True)
g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
tg = state_to_variables({"params": g, "batch_stats": st["batch_stats"]},
                        8)["params"]
err = lambda a, b: max(jax.tree.leaves(jax.tree.map(
    lambda u, v: float(np.abs(np.asarray(u, np.float64)
                              - np.asarray(v, np.float64)).max()), a, b)))
print(json.dumps({"port32_vs_ref64": err(tg, jg[jnp.float64]),
                  "ref32_vs_ref64": err(jg[jnp.float32], jg[jnp.float64])}))
"""


def test_zero_padded_batchnorm_step_matches_fp64():
    """One ResNet step on a batch of 14 samples and 2 zero rows (a ragged
    last batch of the host-packed path), from the reference's initial
    weights: the port's fp32 gradient agrees with the reference's fp64
    gradient to 1e-5, and the reference's own fp32 gradient is more than
    ten times further from it (the reason the host-packed ResNet is held
    on whole batches). fp64 needs ``jax_enable_x64``, which is
    process-wide: the check runs in a child process."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _FP64_CHECK], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    errs = json.loads(proc.stdout.strip().splitlines()[-1])
    print(errs)
    assert errs["port32_vs_ref64"] < 1e-5
    assert errs["ref32_vs_ref64"] > 10 * errs["port32_vs_ref64"]
