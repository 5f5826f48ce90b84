"""The port's LSTM language models against flax (``fedml_tpu/models/rnn.py``)
at a tiny width (embedding 8, hidden 12, vocabulary 16, T 5), weights
carried from the reference's init: the three factory names' logits and
gradients within 1e-5, K stacked clients equal to K separate
applications, the weight carrier's round trip exact under flax's
``OptimizedLSTMCell_{j}`` names, and one bucketed FedAvg round of
``rnn_stackoverflow`` against the JAX ``FedAvgAPI`` within 1e-4 (numpy
packing in both)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import models as jmodels
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import (
    make_seq_classification_spec as jax_seq_spec)
from fedml_tpu.models.factory import create_model as jax_create_model
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
from fedml_tpu_torch.models import rnn
from fedml_tpu_torch.models.factory import create_model
from fedml_tpu_torch.utils.torch_import import (rnn_state_to_variables,
                                                rnn_variables_to_state)

E, H, V, T, B = 8, 12, 16, 5, 3
TOL = 1e-5
#: factory name -> (JAX model, port model) at the tiny width
MODELS = {
    "rnn": lambda: (jmodels.RNNOriginalFedAvg(vocab_size=V, hidden_size=H),
                    rnn.RNNOriginalFedAvg(vocab_size=V, hidden_size=H)),
    "rnn_fed_shakespeare": lambda: (
        jmodels.RNNOriginalFedAvg(vocab_size=V, hidden_size=H,
                                  output_all_timesteps=True),
        rnn.RNNOriginalFedAvg(vocab_size=V, hidden_size=H,
                              output_all_timesteps=True)),
    "rnn_stackoverflow": lambda: (
        jmodels.RNNStackOverflow(vocab_size=V - 4, embedding_size=E,
                                 latent_size=H),
        rnn.RNNStackOverflow(vocab_size=V - 4, embedding_size=E,
                             latent_size=H)),
}


def _tokens(seed, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    jm, tm = MODELS[request.param]()
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(_tokens(0))))
    return request.param, jm, tm, variables


def test_factory_builds_the_reference_classes_and_sizes():
    for name, cls in (("rnn", rnn.RNNOriginalFedAvg),
                      ("rnn_fed_shakespeare", rnn.RNNOriginalFedAvg),
                      ("rnn_stackoverflow", rnn.RNNStackOverflow)):
        model = create_model(None, name, 90)
        jm = jax_create_model(None, name, 90)
        assert isinstance(model, cls)
        variables = jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 4), jnp.int32)))
        shapes = {k: tuple(v.shape) for k, v in rnn_variables_to_state(
            variables)["params"].items()}
        assert shapes == {k: tuple(v.shape)
                          for k, v in model.named_parameters()}, name
        assert getattr(model, "output_all_timesteps",
                       True) == getattr(jm, "output_all_timesteps", True)


def test_carrier_round_trip_is_exact(pair):
    name, _, _, variables = pair
    cells = sorted(k for k in variables["params"]
                   if k.startswith("OptimizedLSTMCell_"))
    assert cells == (["OptimizedLSTMCell_0", "OptimizedLSTMCell_1"]
                     if name != "rnn_stackoverflow"
                     else ["OptimizedLSTMCell_0"])
    back = rnn_state_to_variables(rnn_variables_to_state(variables))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 variables, back)
    assert (jax.tree.structure(back) == jax.tree.structure(variables))
    # client-stacked variables carry across too
    stacked = jax.tree.map(lambda a: np.stack([a, a + 1]), variables)
    back = rnn_state_to_variables(rnn_variables_to_state(stacked))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 stacked, back)


def test_logits_and_gradients_match_flax(pair):
    name, jm, tm, variables = pair
    x = _tokens(1)
    w = np.random.default_rng(2).standard_normal(
        np.asarray(jm.apply(variables, jnp.asarray(x))).shape
    ).astype(np.float32)

    def jloss(params):
        return jnp.sum(jm.apply({"params": params}, jnp.asarray(x)) * w)

    want_logits = np.asarray(jm.apply(variables, jnp.asarray(x)))
    want_grads = jax.grad(jloss)(variables["params"])
    params = {k: v.requires_grad_() for k, v in
              rnn_variables_to_state(variables)["params"].items()}
    logits = tm.apply_params(params, torch.as_tensor(x))
    (logits * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=0, atol=TOL)
    got_grads = rnn_state_to_variables(
        {"params": {k: v.grad for k, v in params.items()}})["params"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=TOL), got_grads,
        jax.tree.map(np.asarray, want_grads))


def test_stacked_clients_equal_separate_applications(pair):
    _, jm, tm, variables = pair
    K = 3
    stacked_vars = jax.tree.map(
        lambda a: np.stack([a * (1 + 0.1 * k) for k in range(K)]),
        variables)
    P = rnn_variables_to_state(stacked_vars)["params"]
    x = torch.as_tensor(_tokens(3, (K, B, T)))
    got = tm.apply_params(P, x, stacked=True)
    for k in range(K):
        one = tm.apply_params({n: v[k] for n, v in P.items()}, x[k])
        torch.testing.assert_close(got[k], one, rtol=0, atol=1e-6)
    logits, aux = tm.apply_params(P, x, stacked=True, with_sown=True)
    assert torch.equal(logits, got) and torch.equal(aux, torch.zeros(K))


def test_init_draws_flax_distributions():
    model = rnn.RNNStackOverflow(vocab_size=200, embedding_size=32,
                                 latent_size=48)
    model.reset_parameters_(torch.Generator().manual_seed(0))
    hh = model.lstm1.weight_hh.detach()
    for g in range(4):
        blk = hh[g * 48:(g + 1) * 48]
        torch.testing.assert_close(blk @ blk.T, torch.eye(48), atol=1e-5,
                                   rtol=0)
    assert torch.equal(model.lstm1.bias_hh, torch.zeros(4 * 48))
    std = model.word_embeddings.weight.std().item()
    assert abs(std - 32 ** -0.5) < 0.02
    assert model.fc1.weight.abs().max() <= 2 * 48 ** -0.5 / .8796 + 1e-6


# -- one bucketed FedAvg round ------------------------------------------------

def _sequences():
    rng = np.random.default_rng(4)
    local, num = {}, {}
    for c, n in enumerate((3, 9, 1, 14, 6)):
        seq = rng.integers(1, V, (n, T + 1))
        local[c] = {"x": seq[:, :-1].astype(np.int32),
                    "y": seq[:, 1:].astype(np.int64)}
        num[c] = n
    x = np.concatenate([d["x"] for d in local.values()])
    y = np.concatenate([d["y"] for d in local.values()])
    test = {"x": x[:8], "y": y[:8]}
    return [len(y), 8, {"x": x, "y": y}, test, num, local,
            {c: test for c in local}, V]


def test_bucketed_round_of_rnn_stackoverflow_matches_jax(monkeypatch):
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    ds = _sequences()
    args = types.SimpleNamespace(
        client_num_in_total=5, client_num_per_round=5, comm_round=1,
        epochs=1, batch_size=4, lr=0.5, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=1, seed=0, client_chunk=2,
        bucket_edges="geometric", device_resident="0")
    # the factory's model, cut from its full width (96/670) to the tiny one
    jm = jax_create_model(None, "rnn_stackoverflow", V).clone(
        embedding_size=E, latent_size=H)
    tm = rnn.RNNStackOverflow(vocab_size=V - 4, embedding_size=E,
                              latent_size=H)
    japi = JaxFedAvgAPI(ds, jax_seq_spec(jm, jnp.asarray(ds[2]["x"][:1])),
                        args)
    api = FedAvgAPI(ds, make_seq_classification_spec(tm), args,
                    device="cpu")
    init = jax.tree.map(np.array, japi.global_state)
    api.global_state = rnn_variables_to_state(init)
    rm, gm = japi.train_one_round(), api.train_one_round()
    for k in ("bucket/chunks", "bucket/executed_steps", "bucket/true_steps"):
        assert gm[k] == rm[k]
    np.testing.assert_allclose(gm["Train/Loss"], rm["Train/Loss"],
                               atol=1e-4)
    got = rnn_state_to_variables(api.global_state)
    want = jax.tree.map(np.asarray, japi.global_state)
    moved = jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.abs(a - b).max()), want, init))
    assert max(moved) > 1e-3
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-4), got, want)
    np.testing.assert_allclose(api.evaluate_global()["Test/Loss"],
                               japi.evaluate_global()["Test/Loss"],
                               atol=1e-4)
