"""Augmentation on the bucketed path's streamed client update. JAX's PRNG
streams cannot be matched, so with augmentation on the port is held to
its own seed rule: on a cohort whose step-sorted order differs from its
slot order, lane ``i`` of each chunk at local step ``t`` is augmented
with the draws of ``fold_seed(client_seeds_for(round_seed, C)[chunk[i]],
t)``, the padded lanes of a ragged chunk with its first client's, so a
client draws the same whatever chunk and lane it lands in. With
augmentation off, two bucketed rounds of LR on 32x32x3 images equal the
JAX ``FedAvgAPI``'s within 1e-4 (the round tests' tolerance), from the
reference's initial weights, numpy packing in both."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.data.synthetic import load_synthetic_images
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.data.augment import make_cifar_augment
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.parallel import engine
from fedml_tpu_torch.parallel.packing import _steps_for
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

IMG, CHUNK, BS, SEED = 32, 3, 4, 7
SIZES = (30, 5, 17, 2, 9, 40, 12)


def _shards():
    rng = np.random.default_rng(0)
    return [{"x": rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
             "y": rng.integers(0, 10, n).astype(np.int32)} for n in SIZES]


def _aug_spec():
    return make_classification_spec(
        LogisticRegression(IMG * IMG * 3, 10),
        augment_fn=make_cifar_augment(pad=4, cutout_length=16))


@pytest.fixture(scope="module")
def recorded():
    """Every ``_augment`` call of one augmented bucketed round: the
    lanes' inputs, the seeds they drew from and the outputs."""
    calls = []
    inner = engine._augment

    def recording(spec, x, seeds):
        out = inner(spec, x, seeds)
        calls.append((x.clone(), np.asarray(seeds).copy(), out.clone()))
        return out

    spec = _aug_spec()
    runner = engine.BucketedStreamRunner(
        spec, engine.ClientUpdateConfig(lr=0.01), client_chunk=CHUNK,
        batch_size=BS, epochs=1, edges=(8, 16))
    mp = pytest.MonkeyPatch()
    mp.setattr(engine, "_augment", recording)
    try:
        state = spec.init_fn(0, "cpu")
        out = runner.run_round(state, (), _shards(), SEED,
                               data_rng=np.random.default_rng(1))
    finally:
        mp.undo()
    return spec, calls, out, state


def test_cohort_order_differs_from_its_sorted_order():
    steps = np.asarray([_steps_for(n, BS, 1) for n in SIZES])
    assert list(np.argsort(steps, kind="stable")) != list(range(len(SIZES)))
    assert len(SIZES) % CHUNK  # a ragged last chunk with padded lanes


def test_each_lane_draws_from_its_cohort_slot_and_step(recorded):
    spec, calls, _, _ = recorded
    steps = np.asarray([_steps_for(n, BS, 1) for n in SIZES])
    order = np.argsort(steps, kind="stable")
    seeds = engine.client_seeds_for(SEED, len(SIZES))
    want = []
    for c0 in range(0, len(SIZES), CHUNK):
        chunk = order[c0:c0 + CHUNK]
        lane_seeds = np.concatenate(
            [seeds[chunk], np.repeat(seeds[chunk[:1]], CHUNK - len(chunk))])
        for t in range(int(steps[chunk].max())):
            want.append(engine.fold_seed(lane_seeds, t))
    assert len(calls) == len(want)
    for (x, got_seeds, out), w in zip(calls, want):
        np.testing.assert_array_equal(got_seeds, w)
        assert x.shape[0] == CHUNK
        # the batch each lane trains on is _augment's with those seeds
        assert torch.equal(out, engine._augment(spec, x, w))
        assert not torch.equal(out, x)


def test_augmented_round_differs_from_the_plain_round(recorded):
    spec, _, out, state = recorded
    plain = make_classification_spec(LogisticRegression(IMG * IMG * 3, 10))
    runner = engine.BucketedStreamRunner(
        plain, engine.ClientUpdateConfig(lr=0.01), client_chunk=CHUNK,
        batch_size=BS, epochs=1, edges=(8, 16))
    ref = runner.run_round(state, (), _shards(), SEED,
                           data_rng=np.random.default_rng(1))
    assert ref[2]["bucket"] == out[2]["bucket"]
    diff = max(float((ref[0]["params"][k] - out[0]["params"][k]).abs().max())
               for k in ref[0]["params"])
    assert diff > 1e-4 and np.isfinite(out[2]["metrics"]["loss_sum"])


def test_plain_bucketed_rounds_on_images_match_jax(monkeypatch):
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    ds = load_synthetic_images(client_num=5, n_train=120, n_test=20,
                               image_size=IMG, partition="hetero",
                               partition_alpha=0.5, seed=0)
    args = types.SimpleNamespace(
        client_num_in_total=5, client_num_per_round=5, comm_round=2,
        epochs=1, batch_size=8, lr=0.05, wd=0.001, client_optimizer="sgd",
        frequency_of_the_test=1, seed=0, client_chunk=2,
        bucket_edges="geometric", device_resident="0")
    japi = JaxFedAvgAPI(ds, jax_spec(JaxLR(num_classes=10),
                                     jnp.zeros((1, IMG, IMG, 3))), args)
    api = FedAvgAPI(ds, make_classification_spec(
        LogisticRegression(IMG * IMG * 3, 10)), args, device="cpu")
    init = jax.tree.map(np.array, japi.global_state)
    api.global_state = cv_variables_to_state(init)
    for _ in range(2):
        rm, gm = japi.train_one_round(), api.train_one_round()
        for key in ("Train/Loss", "Train/Acc"):
            np.testing.assert_allclose(gm[key], rm[key], atol=1e-4)
        assert gm["bucket/executed_steps"] == rm["bucket/executed_steps"]
    want = jax.tree.map(np.asarray, japi.global_state)
    got = cv_state_to_variables(api.global_state)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0,
                                                         atol=1e-4),
                 got, want)
    assert float(np.abs(want["params"]["linear"]["kernel"]
                        - init["params"]["linear"]["kernel"]).max()) > 1e-3
