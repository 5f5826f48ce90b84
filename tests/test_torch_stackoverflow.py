"""StackOverflow in the port against the JAX package: the h5 loader on
the reference's own fixture (``fedml_tpu/data/prepare.py``'s
``_fx_stackoverflow``; skipped without h5py), both tasks' 8-tuples byte
for byte, directly and through the registry; the tokenizer's ids; the
multilabel spec's loss and ``tp/fp/fn/count`` within 1e-6 (one client
and K stacked); ``make_spec`` picking it for ``stackoverflow_lr``; the
full-width next-word LSTM trained one async bucketed round through
``main_fedavg`` on the fixture; and the out-of-vocabulary caveat: the
reference's tokenizer gives an unknown word the id ``V + 4``, one past
its model's extended vocabulary, where the reference's model returns
NaN logits, and the port refuses the id on the host with a
``ValueError``."""

import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.specs import make_multilabel_spec as jax_ml_spec
from fedml_tpu.data import registry as jregistry
from fedml_tpu.data import stackoverflow as jso
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.models.rnn import RNNStackOverflow as JaxRNN
from fedml_tpu_torch.algorithms.specs import make_multilabel_spec
from fedml_tpu_torch.data import registry, stackoverflow
from fedml_tpu_torch.experiments import common, main_fedavg
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.utils.torch_import import zoo_variables_to_state
from test_torch_data import _assert_eight_tuple_equal

h5py = pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from fedml_tpu.data.prepare import _fx_stackoverflow
    d = str(tmp_path_factory.mktemp("stackoverflow"))
    _fx_stackoverflow(d, 4, np.random.default_rng(0))
    # a client absent from the test split gets an empty test shard
    with h5py.File(os.path.join(d, "stackoverflow_test.h5"), "a") as f:
        del f["examples"]["user00002"]
    return d


@pytest.mark.parametrize("task", ["nwp", "lr"])
@pytest.mark.parametrize("client_num", [None, 3])
def test_loader_is_byte_equal(fixture_dir, task, client_num):
    got = stackoverflow.load_stackoverflow(fixture_dir, task, client_num)
    want = jso.load_stackoverflow(fixture_dir, task, client_num)
    _assert_eight_tuple_equal(got, want)
    assert len(got[5]) == (client_num or 4)
    if task == "nwp":
        assert got[7] == 10004 and got[2]["x"].shape[1:] == (20,)
    else:
        assert got[7] == 500 and got[2]["y"].dtype == np.float32
    if client_num is None:
        assert len(got[6][2]["y"]) == 0


@pytest.mark.parametrize("name", ["stackoverflow_nwp", "stackoverflow_lr"])
def test_registry_loads_stackoverflow(fixture_dir, name):
    args = types.SimpleNamespace(
        client_num_in_total=2, partition_method="hetero",
        partition_alpha=0.5, seed=0, n_train=None, n_test=None,
        image_size=None, data_dir=fixture_dir)
    _assert_eight_tuple_equal(registry.load_dataset(args, name),
                              jregistry.load_dataset(args, name))


@pytest.mark.parametrize("sentence,seq_len", [
    ("the to how", 20), ("a zzz python qqq", 6), ("", 4),
    (" ".join(["java"] * 30), 20)])
def test_tokens_to_ids_is_the_reference(fixture_dir, sentence, seq_len):
    vocab = stackoverflow.load_word_vocab(fixture_dir)
    assert vocab == jso.load_word_vocab(fixture_dir)
    assert (stackoverflow.tokens_to_ids(sentence, vocab, seq_len)
            == jso.tokens_to_ids(sentence, vocab, seq_len))


def test_oov_id_is_nan_in_the_reference_and_refused_by_the_port(
        fixture_dir, tmp_path):
    vocab = {"a": 0, "b": 1, "c": 2}
    ids = jso.tokens_to_ids("a zzz c", vocab, seq_len=6)
    assert ids == stackoverflow.tokens_to_ids("a zzz c", vocab, seq_len=6)
    assert ids == [4, 1, 7, 3, 5, 0, 0]          # the unknown word is V + 4
    model = JaxRNN(vocab_size=3, embedding_size=4, latent_size=5)
    x = jnp.asarray([ids[:-1]], jnp.int32)
    logits = np.asarray(model.apply(model.init(jax.random.PRNGKey(0), x), x))
    assert np.isnan(logits[0, 2]).all()          # the step that read id 7
    assert np.isfinite(logits[0, :2]).all()
    seq = np.asarray([ids])
    with pytest.raises(ValueError, match="out-of-vocabulary"):
        stackoverflow.check_nwp_ids(seq[:, :-1], seq[:, 1:], 3)
    stackoverflow.check_nwp_ids(seq[:, :-1], seq[:, 1:], 4)  # in range
    # the loader refuses such a file before anything reaches a device:
    # a vocabulary cut to V words makes every other word out of it
    vocab_size = 5
    with pytest.raises(ValueError, match="out-of-vocabulary"):
        stackoverflow.load_stackoverflow(fixture_dir, "nwp",
                                         vocab_size=vocab_size)
    want = jso.load_stackoverflow(fixture_dir, "nwp", vocab_size=vocab_size)
    assert int(want[2]["y"].max()) == vocab_size + 4


def _multilabel_batch(seed, n=6, d=10, labels=7):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, d)).astype(np.float32),
            "y": (rng.random((n, labels)) < 0.3).astype(np.float32),
            "mask": (np.arange(n) < n - 2).astype(np.float32)}


def test_multilabel_spec_matches_the_reference():
    d, labels = 10, 7
    jspec = jax_ml_spec(JaxLR(num_classes=labels), jnp.zeros((1, d)))
    variables = jax.tree.map(np.array, jspec.init_fn(
        jax.random.PRNGKey(3)))
    # push some probabilities past 0.5 and some into the clip
    variables["params"]["linear"]["kernel"] *= 8.0
    state = zoo_variables_to_state(variables)
    spec = make_multilabel_spec(LogisticRegression(d, labels))
    batches = [_multilabel_batch(s) for s in (0, 1)]
    stacked_m = spec.stacked_loss_fn(
        {"params": {k: torch.stack([v, v]) for k, v in
                    state["params"].items()}},
        {k: torch.stack([torch.as_tensor(b[k]) for b in batches])
         for k in batches[0]}, True)[1][1]
    for i, batch in enumerate(batches):
        jloss, (_, jm) = jspec.loss_fn(variables, jax.tree.map(
            jnp.asarray, batch), None, True)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss, (_, m) = spec.loss_fn(state, tb, True)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6,
                                   atol=1e-6)
        assert sorted(m) == sorted(jm) == ["correct", "count", "fn", "fp",
                                           "loss_sum", "tp"]
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(float(stacked_m[k][i]), float(jm[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        em = spec.metrics_fn(state, tb)
        for k in jm:
            np.testing.assert_allclose(float(em[k]), float(jm[k]), rtol=1e-6,
                                       atol=1e-6)
    assert float(stacked_m["tp"].sum()) > 0 and float(
        stacked_m["fp"].sum()) > 0


def test_make_spec_picks_the_multilabel_spec():
    args = types.SimpleNamespace(dataset="stackoverflow_lr",
                                 data_augmentation=1)
    spec = common.make_spec(args, LogisticRegression(10, 7), None)
    assert spec.name == "tag_prediction"


def test_next_word_lstm_trains_an_async_round_through_the_main(
        fixture_dir, monkeypatch):
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    api, _ = main_fedavg.main([
        "--dataset", "stackoverflow_nwp", "--model", "rnn_stackoverflow",
        "--data_dir", fixture_dir, "--client_num_in_total", "4",
        "--client_num_per_round", "4", "--batch_size", "2",
        "--async_agg", "1", "--buffer_k", "2", "--client_chunk", "2",
        "--comm_round", "1", "--platform", "cpu"])
    rec = api.history[-1]
    n = sum(v.numel() for v in api.global_state["params"].values())
    assert n == 4_050_748                 # 10,004 x 96 embedding, LSTM 670
    assert math.isfinite(rec["Train/Loss"]) and math.isfinite(
        rec["Test/Loss"])
    assert rec["async/flushes_this_round"] == 2
