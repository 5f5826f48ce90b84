"""Two rounds of the port's ``FedAvgAPI`` against the JAX package's on
every single-device round path: ``wave_mode`` 0 (flat), 1 (waves), 2
(vmap lanes), 3 (packed lanes; for LR, which has no packed lowering, the
fallback to vmap lanes) and the host-packed round (``device_resident=0``),
each on LR (LEAF synthetic, 60 features), the FedAvg CNN
(``CNNOriginalFedAvg`` on 8x8x3 images) and a depth-8 ResNet (8x8x3).
4 clients, ``client_chunk`` 3 (a ragged last wave and chunk, 2 lanes
running clients back to back), batch 16, SGD with weight decay, fp32, no
augmentation, the port starting from the reference's initial weights
carried over, both sides packing schedules with numpy (byte-equal).
Tolerance 1e-4 on the global state and on the round metrics (train and
test loss and accuracy), as the packed-lane test holds them.

The host-packed ResNet runs on an IID split whose shards are whole
batches: through BatchNorm, a batch padded with zero rows is
ill-conditioned in the reference's fp32, whose gradient on one such step
lies more than ten times further from its own fp64 gradient than the
port's fp32 gradient does
(``test_torch_rounds_resnet.py::test_zero_padded_batchnorm_step_matches_fp64``
prints both).

This file runs LR and the CNN; ``test_torch_rounds_resnet.py`` runs the
ResNet with the same helpers, and holds the port's modes 0, 1 and 2 to
one another with augmentation on (every runner derives a client's draws
import torch_threads  # noqa: F401  (caps torch threads under xdist)
from its cohort slot)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import (
    make_classification_spec as jax_spec)
from fedml_tpu.data.synthetic import (load_synthetic_federated as
                                      jax_load_federated)
from fedml_tpu.data.synthetic import load_synthetic_images
from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNN
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.utils.torch_import import (state_to_variables,
                                                variables_to_state,
                                                cv_state_to_variables,
                                                cv_variables_to_state)

ROUNDS, H, TOL = 2, 8, 1e-4
# (wave_mode, device_resident)
PATHS = [(0, "auto"), (1, "auto"), (2, "auto"), (3, "auto"), (1, "0")]


def _args(mode, resident):
    return types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=ROUNDS,
        epochs=1, batch_size=16, lr=0.05, wd=0.001, client_optimizer="sgd",
        frequency_of_the_test=1, seed=0, client_chunk=3, wave_mode=mode,
        device_resident=resident, device_data_cap_gb=1.0, device_dtype=None)


def _family(name, resident):
    """(dataset, jax model, example x, port model, to_state, to_vars)."""
    if name == "lr":
        ds = jax_load_federated(client_num=4, n_train=150, n_test=40,
                                seed=0)
        return (ds, JaxLR(num_classes=10), jnp.zeros((1, 60)),
                LogisticRegression(60, 10), cv_variables_to_state,
                cv_state_to_variables)
    if name == "resnet" and resident == "0":
        # whole batches: no zero-padded rows through BatchNorm
        ds = load_synthetic_images(client_num=4, n_train=128, n_test=32,
                                   image_size=H, partition="homo", seed=0)
    else:
        ds = load_synthetic_images(client_num=4, n_train=150, n_test=40,
                                   image_size=H, partition="hetero",
                                   partition_alpha=0.5, seed=0)
    ex = jnp.zeros((1, H, H, 3))
    if name == "cnn":
        return (ds, JaxCNN(), ex, CNNOriginalFedAvg(input_shape=(H, H, 3)),
                lambda v: cv_variables_to_state(v),
                lambda s: cv_state_to_variables(s))
    return (ds, JaxResNet(depth=8, num_classes=10), ex, CifarResNet(depth=8),
            lambda v: variables_to_state(v, 8),
            lambda s: state_to_variables(s, 8))


def _run(name, mode, resident):
    ds, jmodel, ex, model, to_state, to_vars = _family(name, resident)
    japi = JaxFedAvgAPI(ds, jax_spec(jmodel, ex), _args(mode, resident))
    init = jax.tree.map(np.array, japi.global_state)
    api = FedAvgAPI(ds, make_classification_spec(model),
                    _args(mode, resident), device="cpu")
    api.global_state = to_state(init)
    ref, got = [], []
    japi.train(on_round=lambda a, m: ref.append(
        (dict(m), jax.tree.map(np.array, a.global_state))))
    api.train(on_round=lambda a, m: got.append(
        (dict(m), to_vars(a.global_state))))
    return ref, got, init, api


def run_paths(names):
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        return {(name, mode, res): _run(name, mode, res)
                for name in names for mode, res in PATHS}
    finally:
        mp.undo()


def check_rounds(run):
    ref, got, init, _ = run
    assert len(got) == len(ref) == ROUNDS
    start = dict(jax.tree_util.tree_leaves_with_path(init))
    for rnd, ((rm, rs), (gm, gs)) in enumerate(zip(ref, got)):
        assert gm["round"] == rm["round"] == rnd
        for key in ("Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc"):
            np.testing.assert_allclose(gm[key], rm[key], atol=TOL)
        want = jax.tree_util.tree_leaves_with_path(rs)
        have = dict(jax.tree_util.tree_leaves_with_path(gs))
        assert len(want) == len(have)
        moved = 0.0
        for path, leaf in want:
            np.testing.assert_allclose(have[path], leaf, atol=TOL)
            moved = max(moved, float(np.abs(leaf - start[path]).max()))
        assert moved > 1e-3  # the round really trained


@pytest.fixture(scope="module")
def runs():
    return run_paths(("lr", "cnn"))


@pytest.mark.parametrize("mode,resident", PATHS)
@pytest.mark.parametrize("name", ["lr", "cnn"])
def test_rounds_match_jax_fedavg(runs, name, mode, resident):
    check_rounds(runs[(name, mode, resident)])


@pytest.mark.parametrize("name,packed", [("lr", False), ("cnn", True)])
def test_mode_3_packs_lanes_where_the_family_has_a_lowering(runs, name,
                                                            packed):
    _, _, _, api = runs[(name, 3, "auto")]
    assert (api.packed_lane_runner is not None) == packed
    assert api.device_data is not None


@pytest.mark.parametrize("cap_gb,on_device", [(1.0, True), (1e-9, False)])
def test_global_eval_is_packed_once(cap_gb, on_device):
    """``evaluate_global`` packs the test set once: on the device within
    25% of ``device_data_cap_gb``, else on the host; either way its
    values equal the plain per-batch evaluation."""
    from fedml_tpu_torch.data.synthetic import load_synthetic_federated
    from fedml_tpu_torch.parallel.packing import pack_eval

    args = _args(1, "auto")
    args.device_data_cap_gb = cap_gb
    dataset = load_synthetic_federated(client_num=4, n_train=150, n_test=37,
                                       seed=0)
    spec = make_classification_spec(LogisticRegression(60, 10))
    api = FedAvgAPI(dataset, spec, args, device="cpu")
    first = api.evaluate_global()
    packed = api._eval_packed
    assert isinstance(packed["x"], torch.Tensor) == on_device
    assert api.evaluate_global() == first and api._eval_packed is packed
    plain = pack_eval(dataset[3], args.batch_size)
    tot = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
    for s in range(plain["mask"].shape[0]):
        m = spec.metrics_fn(api.global_state, {
            k: torch.as_tensor(v[s]) for k, v in plain.items()})
        for k in tot:
            tot[k] += float(m[k])
    assert tot["count"] == 37
    np.testing.assert_allclose(first["Test/Loss"],
                               tot["loss_sum"] / tot["count"], atol=1e-6)
    np.testing.assert_allclose(first["Test/Acc"],
                               tot["correct"] / tot["count"], atol=1e-6)
