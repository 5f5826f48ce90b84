"""One and two rounds of the port's FedAvgAPI (wave_mode=3, packed lanes,
``lane_lowering="pallas"``) against the JAX package's FedAvgAPI on a tiny
configuration: depth-8 ResNet, 4 clients on 2 lanes (lanes run clients
back to back: flush-and-reset and fully masked steps both occur), 16x16
images, no augmentation, fp32, the port starting from the reference's
initial weights carried over. Both sides use the numpy packing backend,
so schedules are byte-equal. Tolerance 1e-4 on the global state and the
round metrics: multi-step BatchNorm trajectories reassociate (ROADMAP
A5). Both sides run ``train()`` with a test evaluation after every
round, and record each round through its ``on_round`` hook. One more
round runs with ``client_optimizer="adam"`` (AMSGrad over lanes) at the
tolerance its test states."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import (
    make_classification_spec as jax_spec)
from fedml_tpu.data.synthetic import load_synthetic_images
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.parallel.engine import ClipByGlobalNorm, make_optimizer
from fedml_tpu_torch.utils.torch_import import (state_to_variables,
                                                variables_to_state)

DEPTH, H, ROUNDS = 8, 16, 2


@pytest.fixture(scope="module", autouse=True)
def default_threads():
    """torch's default thread count for this file: its 1e-4 tolerance on
    two rounds of zero-padded BatchNorm trajectories was set at one
    thread a core, and a capped run splits the CPU reductions otherwise
    (a round-2 running variance then reads 1.14e-4 off the reference at
    1, 2 and 4 threads)."""
    capped = torch.get_num_threads()
    torch.set_num_threads(torch_threads.DEFAULT)
    yield
    torch.set_num_threads(capped)


def _args():
    return types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=ROUNDS,
        epochs=1, batch_size=16, lr=0.05, wd=0.001, client_optimizer="sgd",
        frequency_of_the_test=1, seed=0, client_chunk=2, wave_mode=3,
        device_resident="auto", device_data_cap_gb=1.0, device_dtype=None)


@pytest.fixture(scope="module")
def trajectories():
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        dataset = load_synthetic_images(client_num=4, n_train=120, n_test=32,
                                        image_size=H, partition="hetero",
                                        partition_alpha=0.5, seed=0)
        jspec = jax_spec(JaxResNet(depth=DEPTH, num_classes=10),
                         jnp.zeros((1, H, H, 3)), lane_lowering="pallas")
        japi = JaxFedAvgAPI(dataset, jspec, _args())
        assert japi.packed_lane_runner is not None
        init = jax.tree.map(np.array, japi.global_state)

        spec = make_classification_spec(CifarResNet(depth=DEPTH),
                                         lane_lowering="pallas")
        api = FedAvgAPI(dataset, spec, _args(), device="cpu")
        api.global_state = variables_to_state(init, DEPTH)

        ref, got = [], []
        japi.train(on_round=lambda a, m: ref.append(
            (dict(m), jax.tree.map(np.array, a.global_state))))
        api.train(on_round=lambda a, m: got.append(
            (dict(m), state_to_variables(a.global_state, DEPTH))))
        return ref, got, init, api
    finally:
        mp.undo()


@pytest.mark.parametrize("rnd", range(ROUNDS))
def test_round_matches_jax_fedavg(trajectories, rnd):
    ref, got, init, _ = trajectories
    (rm, rs), (gm, gs) = ref[rnd], got[rnd]
    assert gm["round"] == rm["round"] == rnd
    for key in ("Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc"):
        np.testing.assert_allclose(gm[key], rm[key], atol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(rs)
    have = dict(jax.tree_util.tree_leaves_with_path(gs))
    assert len(want) == len(have)
    moved = 0.0
    for path, leaf in want:
        np.testing.assert_allclose(have[path], leaf, atol=1e-4)
        moved = max(moved, float(np.abs(leaf - dict(
            jax.tree_util.tree_leaves_with_path(init))[path]).max()))
    assert moved > 1e-3  # the round really trained


ADAM_LR = 1e-3


@pytest.fixture(scope="module")
def adam_round():
    """One packed-lane round with ``client_optimizer="adam"`` (AMSGrad,
    a per-lane count reset at each flush) on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        dataset = load_synthetic_images(client_num=4, n_train=120, n_test=32,
                                        image_size=H, partition="hetero",
                                        partition_alpha=0.5, seed=0)
        args = _args()
        args.client_optimizer, args.lr = "adam", ADAM_LR
        jspec = jax_spec(JaxResNet(depth=DEPTH, num_classes=10),
                         jnp.zeros((1, H, H, 3)), lane_lowering="pallas")
        japi = JaxFedAvgAPI(dataset, jspec, args)
        init = jax.tree.map(np.array, japi.global_state)
        spec = make_classification_spec(CifarResNet(depth=DEPTH),
                                         lane_lowering="pallas")
        api = FedAvgAPI(dataset, spec, args, device="cpu")
        api.global_state = variables_to_state(init, DEPTH)
        ref = (japi.train_one_round(), jax.tree.map(np.array,
                                                    japi.global_state))
        got = (api.train_one_round(),
               state_to_variables(api.global_state, DEPTH))
        return ref, got, init
    finally:
        mp.undo()


def test_packed_lanes_adam_round_matches_jax_fedavg(adam_round):
    """Train loss to 1e-4 (the SGD rounds' tolerance); parameters to
    lr/2 elementwise, 99.9% of them within lr/10. Adam's update is about
    lr * g / (|g| + eps) whatever the size of g, so BatchNorm's
    reassociated fp32 sums move an element whose gradient sits near 0 by
    up to lr either way (observed: 0.04% of elements past lr/10, the
    largest 5.0e-4; torch's AMSGrad, which takes the maximum of the
    uncorrected moment, puts 17% past lr/10)."""
    (rm, rs), (gm, gs), init = adam_round
    np.testing.assert_allclose(gm["Train/Loss"], rm["Train/Loss"], atol=1e-4)
    np.testing.assert_allclose(gm["Train/Acc"], rm["Train/Acc"], atol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(rs)
    have = dict(jax.tree_util.tree_leaves_with_path(gs))
    start = dict(jax.tree_util.tree_leaves_with_path(init))
    assert len(want) == len(have)
    errs, moved = [], 0.0
    for path, leaf in want:
        np.testing.assert_allclose(have[path], leaf, rtol=0, atol=ADAM_LR / 2)
        errs.append(np.abs(have[path] - leaf).ravel())
        moved = max(moved, float(np.abs(leaf - start[path]).max()))
    assert np.mean(np.concatenate(errs) > ADAM_LR / 10) < 1e-3
    assert moved > ADAM_LR  # the round really trained


def test_train_loop_keeps_a_record_per_round(trajectories):
    ref, got, _, api = trajectories
    assert len(got) == len(ref) == ROUNDS
    assert api.round_idx == ROUNDS
    assert [m for m, _ in got] == api.history
    assert all(m["round_time_s"] > 0 for m in api.history)


def test_entry_point_refuses_unported_paths():
    dataset = load_synthetic_images(client_num=4, n_train=80, n_test=16,
                                    image_size=8, seed=0)
    spec = make_classification_spec(CifarResNet(depth=DEPTH))
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        FedAvgAPI(dataset, spec, _args(), mesh=object(), device="cpu")
    args = _args()
    args.grad_clip = 5.0
    # clipping is ported (FedNAS): the local optimizer clips first
    api = FedAvgAPI(dataset, spec, args, device="cpu")
    assert isinstance(make_optimizer(api.cfg), ClipByGlobalNorm)
    args = _args()
    args.compressor = "topk:0.1"
    # a compressor on a mesh stays a refusal under the mesh's item
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        FedAvgAPI(dataset, spec, args, mesh=object(), device="cpu")


def test_masked_step_leaves_lane_untouched():
    """A fully masked step changes nothing; a flush resets the lane."""
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 make_packed_lane_update)

    model = CifarResNet(depth=DEPTH)
    spec = make_classification_spec(model, lane_lowering="bgc")
    state = spec.init_fn(0, "cpu")
    upd = make_packed_lane_update(
        spec, ClientUpdateConfig(lr=0.1), lambda s, g, a: s)
    data_x = torch.randn(2 * 4, H, H, 3)
    data_y = torch.randint(0, 10, (2 * 4,))
    lanes = {"idx": torch.zeros(2, 1, 4, dtype=torch.long),
             "mask": torch.tensor([[[1., 1., 1., 1.]], [[0., 0., 0., 0.]]]),
             "slot": torch.tensor([[0], [1]]),
             "flush": torch.ones(2, 1), "flush_n": torch.tensor([[4.], [1.]]),
             "flush_steps": torch.ones(2, 1)}
    pay, w, _ = upd(state, data_x, data_y, 4, torch.tensor([0, 1]), lanes,
                    np.zeros((2, 1), np.int64), 1)
    torch.testing.assert_close(w, torch.tensor([4.0, 1.0]))
    for k, v in state["params"].items():
        # lane 1 was fully masked: its flushed payload is the global model
        torch.testing.assert_close(pay["params"][k][1], v, rtol=0, atol=0)
    assert any(not torch.equal(pay["params"][k][0] / 4.0, v)
               for k, v in state["params"].items())


@pytest.mark.parametrize("trip", [1, 2])
def test_packed_update_returns_no_autograd_graph(trip):
    """The summed metrics, payloads and weights come back detached, so no
    step's autograd graph outlives the round (a one-step trip once
    returned step 0's metrics with their graph)."""
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 make_packed_lane_update)

    model = CifarResNet(depth=DEPTH)
    spec = make_classification_spec(model, lane_lowering="bgc")
    state = spec.init_fn(0, "cpu")
    upd = make_packed_lane_update(
        spec, ClientUpdateConfig(lr=0.1), lambda s, g, a: s)
    data_x = torch.randn(2 * 4, H, H, 3)
    data_y = torch.randint(0, 10, (2 * 4,))
    flush = torch.zeros(2, trip)
    flush[:, -1] = 1.0
    lanes = {"idx": torch.arange(4).repeat(2, trip, 1),
             "mask": torch.ones(2, trip, 4),
             "slot": torch.tensor([[0], [1]]).repeat(1, trip),
             "flush": flush, "flush_n": 4.0 * flush,
             "flush_steps": trip * flush}
    pay, w, msum = upd(state, data_x, data_y, 4, torch.tensor([0, 1]),
                       lanes, np.zeros((2, trip), np.int64), trip)
    leaves = list(msum.values()) + list(pay["params"].values()) + [w]
    assert msum and all(t.grad_fn is None and not t.requires_grad
                        for t in leaves)
    assert all(float(c) == 4.0 * trip for c in msum["count"])
