"""The port's MPC primitives and TurboAggregate against the JAX package's,
on the CPU.

- ``core/mpc.py``: the reference's ``TestMPC`` asserts (its module
  imports FedGKT, which the port has not yet, so they are written out
  here), and every function bit-equal to the reference's on the same
  inputs and the same rng: ``quantize``, ``dequantize``,
  ``modular_inverse``, ``additive_shares``, ``reconstruct_additive``,
  ``lagrange_coefficients``, ``bgw_encode``, ``bgw_decode``,
  ``secure_aggregate`` and ``mask_rng``, with the explicit-rng refusals.
- ``TurboAggregateAPI``: one round against the port's ``FedAvgAPI`` on
  the same cohort and against the reference's ``TurboAggregateAPI``
  from the same weights, within ``1e-5 + 2 / mpc_scale`` (and within
  ``1e-5 + C / (2 * mpc_scale)`` of FedAvg), on LR and on a depth-8
  ResNet, whose BatchNorm statistics go through the secure sum too.
- ``main_turboaggregate``'s command line of ``test_experiments.py``
  through the port with ``--platform cpu``; the sum is always masked, so
  the reference's unread ``--secure`` switch does not parse.
"""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import models as jmodels
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.algorithms.turboaggregate import (
    TurboAggregateAPI as JaxTurboAggregateAPI)
from fedml_tpu.core import mpc as jmpc
from fedml_tpu.data import load_synthetic_federated
from fedml_tpu.data.synthetic import load_synthetic_images
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state,
                                                state_to_variables,
                                                variables_to_state)


def _equal(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


# -- the reference's TestMPC ---------------------------------------------------

class TestMPC:
    def test_quantize_roundtrip(self):
        x = np.random.default_rng(0).normal(size=(4, 7))
        back = mpc.dequantize(mpc.quantize(x))
        np.testing.assert_allclose(back, x, atol=1e-4)

    def test_additive_shares_hide_and_reconstruct(self):
        secret = mpc.quantize(np.array([1.5, -2.25, 0.0]))
        shares = mpc.additive_shares(secret, 5, rng=np.random.default_rng(1))
        assert len(shares) == 5
        assert all(not np.array_equal(s, secret) for s in shares[:-1])
        rec = mpc.reconstruct_additive(shares)
        np.testing.assert_array_equal(rec, secret)

    def test_bgw_encode_decode(self):
        secret = mpc.quantize(np.array([3.0, -1.5]))
        points = [1, 2, 3, 4, 5]
        shares = mpc.bgw_encode(secret, points, t=2,
                                rng=np.random.default_rng(2))
        rec = mpc.bgw_decode(shares[:3], points[:3])
        np.testing.assert_array_equal(rec, secret)
        rec2 = mpc.bgw_decode(shares[2:], points[2:])
        np.testing.assert_array_equal(rec2, secret)

    def test_secure_aggregate_equals_plain_sum(self):
        rng = np.random.default_rng(3)
        updates = [rng.normal(size=(6,)) for _ in range(4)]
        agg = mpc.secure_aggregate(updates, rng=rng)
        np.testing.assert_allclose(agg, sum(updates), atol=1e-3)

    def test_masking_requires_an_explicit_rng(self):
        secret = mpc.quantize(np.array([1.0, 2.0]))
        with pytest.raises(ValueError, match="explicit rng"):
            mpc.additive_shares(secret, 3)
        with pytest.raises(ValueError, match="explicit rng"):
            mpc.bgw_encode(secret, [1, 2, 3], t=1)
        with pytest.raises(ValueError, match="explicit rng"):
            mpc.secure_aggregate([np.array([1.0])])

    def test_mask_rng_is_keyed_and_domain_separated(self):
        from fedml_tpu.program.privacy import DP_SEED_SALT
        from fedml_tpu_torch.compression.wire import encode_rng
        a = mpc.mask_rng(1, 4).integers(0, 2 ** 31, size=8)
        b = mpc.mask_rng(1, 4).integers(0, 2 ** 31, size=8)
        np.testing.assert_array_equal(a, b)
        c = mpc.mask_rng(2, 4).integers(0, 2 ** 31, size=8)
        assert not np.array_equal(a, c)
        assert mpc.MASK_SEED_SALT not in (0x5EED, DP_SEED_SALT)
        d = encode_rng((1, 4)).integers(0, 2 ** 31, size=8)
        assert not np.array_equal(a, d)


# -- bit-equal to the reference --------------------------------------------------

def test_constants_are_the_reference():
    assert mpc.DEFAULT_PRIME == jmpc.DEFAULT_PRIME
    assert mpc.MASK_SEED_SALT == jmpc.MASK_SEED_SALT


@pytest.mark.parametrize("scale", [2 ** 16, 2 ** 20])
def test_quantize_dequantize_are_the_reference(scale):
    x = np.random.default_rng(0).normal(size=(5, 3)) * 100
    q = mpc.quantize(x, scale)
    _equal(q, jmpc.quantize(x, scale))
    _equal(mpc.dequantize(q, scale), jmpc.dequantize(q, scale))
    _equal(mpc.quantize(x.astype(np.float32), scale),
           jmpc.quantize(x.astype(np.float32), scale))


@pytest.mark.parametrize("a", [1, 2, 12345, 2 ** 31 - 2, -7])
def test_modular_inverse_is_the_reference(a):
    assert mpc.modular_inverse(a) == jmpc.modular_inverse(a)
    if a % mpc.DEFAULT_PRIME:
        assert (mpc.modular_inverse(a) * a) % mpc.DEFAULT_PRIME == 1


@pytest.mark.parametrize("n", [2, 5])
def test_additive_shares_are_the_reference(n):
    secret = mpc.quantize(np.random.default_rng(1).normal(size=(3, 4)))
    got = mpc.additive_shares(secret, n, rng=mpc.mask_rng(n, 0))
    want = jmpc.additive_shares(secret, n, rng=jmpc.mask_rng(n, 0))
    _equal(got, want)
    _equal(mpc.reconstruct_additive(got), jmpc.reconstruct_additive(want))


@pytest.mark.parametrize("points, target", [([1, 2, 3], 0),
                                            ([2, 5, 7, 11], 0),
                                            ([1, 2, 3, 4, 5], 3)])
def test_lagrange_coefficients_are_the_reference(points, target):
    _equal(mpc.lagrange_coefficients(points, target),
           jmpc.lagrange_coefficients(points, target))


@pytest.mark.parametrize("t", [1, 2, 3])
def test_bgw_is_the_reference(t):
    secret = mpc.quantize(np.random.default_rng(2).normal(size=(6,)))
    points = [1, 2, 3, 4, 5, 6]
    got = mpc.bgw_encode(secret, points, t, rng=mpc.mask_rng(t))
    want = jmpc.bgw_encode(secret, points, t, rng=jmpc.mask_rng(t))
    _equal(got, want)
    _equal(mpc.bgw_decode(got[:t + 1], points[:t + 1]),
           jmpc.bgw_decode(want[:t + 1], points[:t + 1]))
    np.testing.assert_array_equal(
        mpc.bgw_decode(got[-(t + 1):], points[-(t + 1):]), secret)


@pytest.mark.parametrize("scale", [2 ** 16, 2 ** 20])
def test_secure_aggregate_is_the_reference(scale):
    rng = np.random.default_rng(4)
    updates = [rng.normal(size=(3, 5)) for _ in range(4)]
    got_rng, want_rng = mpc.mask_rng(9), jmpc.mask_rng(9)
    got = mpc.secure_aggregate(updates, scale=scale, rng=got_rng)
    want = jmpc.secure_aggregate(updates, scale=scale, rng=want_rng)
    _equal(got, want)
    # the same draws were taken: the streams stay in step
    _equal(got_rng.integers(0, 2 ** 31, 4), want_rng.integers(0, 2 ** 31, 4))
    # the masks cancel: another stream, the same sum
    _equal(mpc.secure_aggregate(updates, scale=scale,
                                rng=np.random.default_rng(0)), got)


# -- TurboAggregate --------------------------------------------------------------

SCALE = 2 ** 20


def _args(**kw):
    base = dict(client_num_in_total=4, client_num_per_round=4, comm_round=1,
                epochs=1, batch_size=16, lr=0.3, client_optimizer="sgd",
                wd=0.0, frequency_of_the_test=100, ci=0, seed=0,
                device_resident="0", mpc_scale=SCALE)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _family(name):
    """(dataset, jax model, example x, port model, to_state, to_vars)."""
    if name == "lr":
        ds = load_synthetic_federated(client_num=4, n_train=400, n_test=80,
                                      alpha=0.0, beta=0.0, seed=0)
        return (ds, jmodels.LogisticRegression(num_classes=10,
                                               apply_sigmoid=False),
                jnp.zeros((1, 60)), LogisticRegression(60, 10, False),
                cv_variables_to_state, cv_state_to_variables)
    # whole batches: no zero-padded rows through BatchNorm
    ds = load_synthetic_images(client_num=4, n_train=128, n_test=32,
                               image_size=8, partition="homo", seed=0)
    return (ds, jmodels.CifarResNet(depth=8, num_classes=10),
            jnp.zeros((1, 8, 8, 3)), CifarResNet(depth=8),
            lambda v: variables_to_state(v, 8),
            lambda s: state_to_variables(s, 8))


@pytest.fixture(scope="module")
def turbo_runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    out = {}
    try:
        for name in ("lr", "resnet"):
            ds, jmodel, ex, model, to_state, to_vars = _family(name)
            japi = JaxTurboAggregateAPI(ds, jax_spec(jmodel, ex), _args())
            init = to_state(jax.tree.map(np.array, japi.global_state))
            spec = make_classification_spec(model)
            api = TurboAggregateAPI(ds, spec, _args(), device="cpu")
            plain = FedAvgAPI(ds, spec, _args(), device="cpu")
            for a in (api, plain):
                a.global_state = {k: dict(v) for k, v in init.items()}
            japi.train_one_round()
            rec = api.train_one_round()
            plain.train_one_round()
            out[name] = (japi, api, plain, rec, init, to_vars)
    finally:
        mp.undo()
    return out


def _gap(got, want):
    leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    have = jax.tree_util.tree_leaves_with_path(got)
    assert len(have) == len(leaves)
    return max(float(np.abs(v - leaves[p]).max()) for p, v in have)


@pytest.mark.parametrize("name", ["lr", "resnet"])
def test_turboaggregate_is_the_reference(turbo_runs, name):
    japi, api, _, rec, init, to_vars = turbo_runs[name]
    bound = 1e-5 + 2 / SCALE
    got = to_vars(api.global_state)
    assert _gap(got, jax.tree.map(np.array, japi.global_state)) <= bound
    # the round trained (the bound is not vacuous)
    assert _gap(got, to_vars(init)) > 100 * bound
    assert rec["round"] == 0 and np.isfinite(rec["Train/Loss"])
    assert api.round_idx == 1
    for part in api.global_state.values():
        assert all(v.dtype == torch.float32 for v in part.values())


@pytest.mark.parametrize("name", ["lr", "resnet"])
def test_turboaggregate_is_fedavg_within_the_fixed_point(turbo_runs, name):
    _, api, plain, _, _, to_vars = turbo_runs[name]
    C = 4
    gap = _gap(to_vars(api.global_state), to_vars(plain.global_state))
    assert gap <= 1e-5 + C / (2 * SCALE)
    if name == "resnet":   # the statistics went through the secure sum
        assert set(api.global_state) == {"params", "batch_stats"}


def test_turboaggregate_matches_fedavg():
    """The reference's case: one round at scale 2**20 within 1e-3 of
    FedAvg."""
    ds = load_synthetic_federated(client_num=4, n_train=400, n_test=80,
                                  alpha=0.0, beta=0.0, seed=0)
    spec = make_classification_spec(LogisticRegression(60, 10, False))
    a1 = FedAvgAPI(ds, spec, _args(mpc_scale=None), device="cpu")
    a2 = TurboAggregateAPI(ds, spec, _args(mpc_scale=2 ** 20), device="cpu")
    a1.train_one_round()
    a2.train_one_round()
    for k, v in a1.global_state["params"].items():
        np.testing.assert_allclose(v.numpy(),
                                   a2.global_state["params"][k].numpy(),
                                   atol=1e-3)


def test_main_turboaggregate():
    from fedml_tpu_torch.experiments import main_turboaggregate
    api, state = main_turboaggregate.main(
        ["--dataset", "synthetic", "--model", "lr", "--lr", "0.1",
         "--client_num_in_total", "4", "--client_num_per_round", "2",
         "--comm_round", "2", "--epochs", "1", "--batch_size", "8",
         "--frequency_of_the_test", "1", "--ci", "1", "--platform", "cpu"])
    assert api.round_idx == 2
    assert api.device.type == "cpu"
    assert "Test/Acc" in api.history[-1]


@pytest.mark.parametrize("secure", ["0", "1"])
def test_main_turboaggregate_takes_no_secure_switch(secure, capsys):
    from fedml_tpu_torch.experiments import main_turboaggregate
    with pytest.raises(SystemExit) as exc:
        main_turboaggregate.main(["--dataset", "synthetic", "--model", "lr",
                                  "--secure", secure, "--platform", "cpu"])
    assert exc.value.code == 2
    assert "unrecognized arguments: --secure" in capsys.readouterr().err


def test_main_turboaggregate_checkpoints_and_resumes(tmp_path):
    from fedml_tpu_torch.experiments import main_turboaggregate
    base = ["--dataset", "synthetic", "--model", "lr",
            "--client_num_in_total", "4", "--comm_round", "2",
            "--checkpoint_dir", str(tmp_path), "--save_frequency", "1",
            "--platform", "cpu"]
    main_turboaggregate.main(base)
    api, _ = main_turboaggregate.main(base + ["--resume", "1",
                                              "--comm_round", "3"])
    assert api.round_idx == 3 and len(api.history) == 1
