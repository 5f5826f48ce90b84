"""FedGKT's modules against the JAX package on the CPU: ``kl_divergence``,
the split ResNets (``resnet5_56`` and ``resnet8_56`` clients, the
server at ``n`` 1) in train and eval mode through the GKT carrier
(exact both ways), and two rounds of the reference's ``FedGKTAPI``
(``resnet5_56`` clients, server ``n`` 1, 8x8 images, 2 clients of 16
samples at batch 8) from carried states, so that round 2's clients
distil from the teacher logits round 1's server scattered back by slot
index: the client states, the server state, the per-sample teacher
logits and the records within 1e-4. The shards are whole batches:
BatchNorm over a zero-padded batch is ill-conditioned in the reference's
fp32 (ROADMAP §C).

The reference's FedGKT cases in ``tests/test_split_vertical_mpc.py``
call jax in their bodies: the extractor and model-shape cases have
counterparts here with the same asserts; the server phase over a
``model`` mesh axis waits for ROADMAP A15 and is refused."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from seeded_variables import seeded_variables

from fedml_tpu.algorithms import fedgkt as jfedgkt
from fedml_tpu.data.synthetic import load_synthetic_images
from fedml_tpu.models import gkt as jgkt
from fedml_tpu_torch.algorithms import fedgkt
from fedml_tpu_torch.models import gkt
from fedml_tpu_torch.utils.torch_import import (gkt_state_to_variables,
                                                gkt_variables_to_state)

TOL = 1e-4
MODEL_TOL = 1e-5


def test_kl_divergence_is_the_reference():
    rng = np.random.default_rng(0)
    s, t = (rng.normal(size=(6, 10)).astype(np.float32) * 3 for _ in "st")
    for T in (1.0, 3.0):
        want = np.asarray(jfedgkt.kl_divergence(jnp.asarray(s),
                                                jnp.asarray(t), T))
        got = fedgkt.kl_divergence(torch.as_tensor(s), torch.as_tensor(t), T)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _apply(model, state, x, train):
    tensors = {**state["params"],
               **{k: v.clone() for k, v in state["batch_stats"].items()}}
    with torch.no_grad():
        return functional_call(model, tensors, (torch.as_tensor(x),),
                               {"train": train})


@pytest.mark.parametrize("maker", ["resnet5_56", "resnet8_56"])
def test_split_resnets_are_the_reference(maker):
    x = np.random.default_rng(1).normal(size=(4, 8, 8, 3)).astype(
        np.float32)
    jc, jsrv = getattr(jgkt, maker)(class_num=10), jgkt.GKTServerResNet(
        n=1, num_classes=10)
    cv = seeded_variables(jc, x, 0, train=False)
    feats = np.asarray(jc.apply(cv, jnp.asarray(x), train=False)[0])
    sv = seeded_variables(jsrv, feats, 1, train=False)
    pairs = ((jc, getattr(gkt, maker)(class_num=10), cv, x),
             (jsrv, gkt.GKTServerResNet(n=1, num_classes=10), sv, feats))
    for jm, model, v, inp in pairs:
        state = gkt_variables_to_state(v)
        assert sorted(model.state_dict()) == sorted(
            list(state["params"]) + list(state["batch_stats"]))
        rt = gkt_state_to_variables(state)
        assert jax.tree.structure(rt) == jax.tree.structure(v)
        for a, b in zip(jax.tree.leaves(rt), jax.tree.leaves(v)):
            np.testing.assert_array_equal(a, b)
        for train in (True, False):
            if train:
                want, _ = jm.apply(v, jnp.asarray(inp), train=True,
                                   mutable=["batch_stats"])
            else:
                want = jm.apply(v, jnp.asarray(inp), train=False)
            got = _apply(model, state, inp, train)
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=MODEL_TOL)


def _args(**kw):
    base = dict(client_num_per_round=2, comm_round=2, epochs=1,
                batch_size=8, lr=0.1, client_optimizer="sgd", wd=1e-4,
                frequency_of_the_test=100, ci=0, seed=0, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def gkt_rounds():
    ds = load_synthetic_images(client_num=2, n_train=32, n_test=16,
                               image_size=8, partition="homo", seed=0)
    japi = jfedgkt.FedGKTAPI(ds, jgkt.resnet5_56(class_num=10),
                             jgkt.GKTServerResNet(n=1, num_classes=10),
                             _args())
    api = fedgkt.FedGKTAPI(ds, gkt.resnet5_56(class_num=10),
                           gkt.GKTServerResNet(n=1, num_classes=10),
                           _args())
    host = lambda t: jax.tree.map(np.asarray, dict(t))
    api.client_states = gkt_variables_to_state(host(japi.client_states),
                                               lead=1)
    api.server_state = gkt_variables_to_state(host(japi.server_state))
    start = (gkt_variables_to_state(host(japi.client_states), lead=1),
             gkt_variables_to_state(host(japi.server_state)))
    records = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("FEDML_TPU_PACKING", "python")  # byte-equal shuffles
        for _ in range(2):
            records.append((japi.train_one_round(), api.train_one_round(),
                            japi.teacher_logits.copy(),
                            api.teacher_logits.copy()))
    finally:
        mp.undo()
    return ds, japi, api, start, records


def _close(got, want, start, tol, what):
    moved = 0.0
    for coll in want:
        assert sorted(got[coll]) == sorted(want[coll]), (what, coll)
        for k, w in want[coll].items():
            moved = max(moved, float((w - start[coll][k]).abs().max()))
            err = float((got[coll][k] - w).abs().max())
            assert err <= tol, (what, coll, k, err)
    assert moved > 10 * tol, what  # the rounds trained


def test_gkt_rounds_states_are_the_reference(gkt_rounds):
    _, japi, api, (c0, s0), _ = gkt_rounds
    host = lambda t: jax.tree.map(np.asarray, dict(t))
    _close(api.client_states,
           gkt_variables_to_state(host(japi.client_states), lead=1), c0,
           TOL, "clients")
    _close(api.server_state, gkt_variables_to_state(host(japi.server_state)),
           s0, TOL, "server")


def test_gkt_teacher_scatter_is_the_reference(gkt_rounds):
    ds, _, api, _, records = gkt_rounds
    for rnd, (_, _, jt, t) in enumerate(records):
        assert t.shape == jt.shape == (2, 16, 10)
        # every sample's slot was written by its round's server
        assert np.abs(t).min(axis=-1).max() > 0
        np.testing.assert_allclose(t, jt, atol=TOL, err_msg=f"round {rnd}")
    # round 2's teachers are not round 1's: the scatter moved them
    assert np.abs(records[1][3] - records[0][3]).max() > 10 * TOL


def test_gkt_round_records_are_the_reference(gkt_rounds):
    _, japi, api, _, records = gkt_rounds
    for jrec, rec, _, _ in records:
        assert sorted(rec) == sorted(jrec)
        for k in jrec:
            np.testing.assert_allclose(rec[k], jrec[k], atol=TOL, err_msg=k)
    want, got = japi.evaluate(), api.evaluate()
    assert got["Test/Samples"] == want["Test/Samples"]
    assert abs(got["Test/Correct"] - want["Test/Correct"]) <= 1


def test_gkt_server_phase_over_a_model_axis_waits_for_a15():
    ds = load_synthetic_images(client_num=2, n_train=32, n_test=16,
                               image_size=8, seed=0)
    mesh = types.SimpleNamespace(shape={"clients": 1, "model": 8})
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        fedgkt.FedGKTAPI(ds, gkt.resnet5_56(class_num=10),
                         gkt.GKTServerResNet(n=1, num_classes=10), _args(),
                         mesh=mesh)
    # a mesh without a model axis over 1 runs unsharded, as it does there
    api = fedgkt.FedGKTAPI(ds, gkt.resnet5_56(class_num=10),
                           gkt.GKTServerResNet(n=1, num_classes=10), _args(),
                           mesh=types.SimpleNamespace(shape={"model": 1}))
    assert api.round_idx == 0


# -- counterparts of test_split_vertical_mpc.py's FedGKT cases ----------------

def test_gkt_eval_uses_every_clients_extractor():
    """evaluate() routes each client's local test shard through that
    client's own edge model, not client 0's only."""
    ds = load_synthetic_images(client_num=3, n_train=96, n_test=48,
                               image_size=8, seed=1)
    api = fedgkt.FedGKTAPI(ds, gkt.resnet5_56(class_num=10),
                           gkt.GKTServerResNet(n=1, num_classes=10),
                           _args(batch_size=8, epochs=2, lr=0.1))
    for _ in range(5):  # enough rounds that predictions are not a
        api.train_one_round()  # constant class (which would make the
    base = api.evaluate()      # perturbation check below vacuous)
    assert base["Test/Samples"] == sum(len(ds[6][i]["y"]) for i in range(3))
    # zeroing client 2's extractor must change the combined pipeline's
    # predictions (a client-0-only eval is invariant to this)
    api.client_states = {c: {k: torch.cat([v[:2], torch.zeros_like(v[2:])])
                             for k, v in t.items()}
                         for c, t in api.client_states.items()}
    moved = api.evaluate()
    assert moved["Test/Correct"] != base["Test/Correct"]
    assert moved["Test/Samples"] == base["Test/Samples"]


def test_gkt_models_shapes():
    x = torch.zeros((2, 32, 32, 3))
    for maker in (gkt.resnet5_56, gkt.resnet8_56):
        feats, logits = maker(class_num=10)(x, train=True)
        assert feats.shape == (2, 32, 32, 16)
        assert logits.shape == (2, 10)
    out = gkt.resnet56_server(class_num=10)(feats, train=False)
    assert out.shape == (2, 10)


def test_main_fedgkt_trains_on_the_cpu():
    from fedml_tpu_torch.experiments import main_fedgkt
    api, server_state = main_fedgkt.main(
        ["--dataset", "synthetic_images", "--n_train", "32", "--n_test",
         "16", "--image_size", "8", "--client_num_in_total", "2",
         "--comm_round", "2", "--batch_size", "8", "--client_model",
         "resnet8_56", "--server_blocks", "1", "--temperature", "2.0",
         "--alpha_distill", "0.5", "--server_epochs", "2", "--platform",
         "cpu"])
    assert api.round_idx == 2 and api.T == 2.0 and api.alpha == 0.5
    assert api.server_epochs == 2 and api.device.type == "cpu"
    assert "layer2_block0.downsample.0.weight" in server_state["params"]
