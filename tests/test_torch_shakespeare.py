"""The Shakespeare file loaders in the port against the JAX package, on
the reference's own fixtures (``fedml_tpu/data/prepare.py``'s
``_fx_fed_shakespeare`` and ``_fx_leaf_shakespeare`` written into a
temporary directory): both 8-tuples byte-equal, directly and through the
dataset registry, whole and cut to fewer clients; the LEAF flavor's
one-next-character labels refused by the sequence spec in both packages
(a caveat of the reference, kept); the TFF h5 flavor trained through
``main_fedavg``; and the bench's LM smoke on the h5 fixture, with V and
T read from the file."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.specs import (
    make_seq_classification_spec as jax_seq_spec)
from fedml_tpu.data import leaf as jleaf
from fedml_tpu.data import registry as jregistry
from fedml_tpu.data import shakespeare as jshakespeare
from fedml_tpu.data.prepare import _fx_fed_shakespeare, _fx_leaf_shakespeare
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu_torch import bench as tbench
from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
from fedml_tpu_torch.data import leaf, registry, shakespeare
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models.transformer import TransformerLM
from test_torch_data import _assert_eight_tuple_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("shakespeare")
    _fx_fed_shakespeare(str(d / "h5"), 4, np.random.default_rng(0))
    _fx_leaf_shakespeare(str(d / "leaf"), 4, np.random.default_rng(1))
    # a client absent from the test split gets an empty test shard
    import h5py
    with h5py.File(str(d / "h5" / "shakespeare_test.h5"), "a") as f:
        del f["examples"]["bard003"]
    return {"h5": str(d / "h5"), "leaf": str(d / "leaf")}


@pytest.mark.parametrize("flavor", ["h5", "leaf"])
@pytest.mark.parametrize("client_num", [None, 2])
def test_loader_is_byte_equal(fixtures, flavor, client_num):
    leaf_ = flavor == "leaf"
    got = shakespeare.load_shakespeare(fixtures[flavor], client_num, leaf_)
    want = jshakespeare.load_shakespeare(fixtures[flavor], client_num, leaf_)
    _assert_eight_tuple_equal(got, want)
    assert len(got[5]) == (client_num or 4)
    assert got[7] == shakespeare.VOCAB_SIZE == 90
    if leaf_:
        assert got[2]["y"].shape == (got[0],)           # one next char
    else:
        assert got[2]["x"].shape[1:] == got[2]["y"].shape[1:] == (80,)
        if client_num is None:
            assert len(got[6][3]["y"]) == 0


@pytest.mark.parametrize("name", ["shakespeare", "fed_shakespeare"])
def test_registry_loads_the_shakespeare_files(fixtures, name):
    args = types.SimpleNamespace(
        client_num_in_total=3, partition_method="hetero",
        partition_alpha=0.5, seed=0, n_train=None, n_test=None,
        image_size=None,
        data_dir=fixtures["leaf" if name == "shakespeare" else "h5"])
    _assert_eight_tuple_equal(registry.load_dataset(args, name),
                              jregistry.load_dataset(args, name))


def test_leaf_reader_matches_the_reference(fixtures, tmp_path):
    split = os.path.join(fixtures["leaf"], "train")
    assert leaf.read_leaf_dir(split) == jleaf.read_leaf_dir(split)
    for bad in (str(tmp_path / "absent"), str(tmp_path)):
        with pytest.raises(FileNotFoundError):
            leaf.read_leaf_dir(bad)
        with pytest.raises(FileNotFoundError):
            jleaf.read_leaf_dir(bad)


def test_missing_h5_files_raise_in_both(tmp_path):
    for mod in (shakespeare, jshakespeare):
        with pytest.raises(FileNotFoundError, match="shakespeare h5"):
            mod.load_shakespeare(str(tmp_path))


def test_leaf_labels_are_refused_by_the_sequence_spec_in_both(fixtures):
    """One next character a sample (``y [n]``) does not train through
    the sequence spec, which reads ``y [n, T]``: the reference raises
    from its gather, the port says why."""
    ds = shakespeare.load_shakespeare(fixtures["leaf"], leaf=True)
    x, y = ds[2]["x"][:4], ds[2]["y"][:4]
    batch = {"x": x, "y": y, "mask": np.ones(4, np.float32)}
    jmodel = JaxLM(vocab_size=90, n_layers=1, n_heads=2, d_model=16,
                   max_len=80)
    jspec = jax_seq_spec(jmodel, jnp.zeros((1, 80), jnp.int32))
    import jax
    state = jspec.init_fn(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="same number of dimensions"):
        jspec.loss_fn(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      None, True)
    spec = make_seq_classification_spec(TransformerLM(
        90, n_layers=1, n_heads=2, d_model=16, max_len=80))
    tstate = spec.init_fn(0, "cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="LEAF Shakespeare"):
        spec.loss_fn(tstate, tb, True)
    stacked = {"params": {k: v[None] for k, v in tstate["params"].items()}}
    with pytest.raises(ValueError, match="LEAF Shakespeare"):
        spec.stacked_loss_fn(stacked, {k: v[None] for k, v in tb.items()},
                             True)
    with pytest.raises(ValueError, match="LEAF Shakespeare"):
        main_fedavg.main(["--dataset", "shakespeare", "--data_dir",
                          fixtures["leaf"], "--model", "transformer",
                          "--comm_round", "1", "--client_num_in_total", "2",
                          "--client_num_per_round", "2", "--platform",
                          "cpu"])


def test_fed_shakespeare_trains_through_the_main(fixtures):
    api, _ = main_fedavg.main(["--dataset", "fed_shakespeare", "--data_dir",
                               fixtures["h5"], "--model", "moe_transformer",
                               "--moe_experts", "2", "--comm_round", "1",
                               "--client_num_in_total", "3",
                               "--client_num_per_round", "3",
                               "--batch_size", "4", "--platform", "cpu"])
    assert api.round_idx == 1 and api.class_num == 90
    assert np.isfinite(api.history[-1]["Train/Loss"])
    assert np.isfinite(api.history[-1]["Test/Loss"])


def test_bench_lm_smoke_reads_v_and_t_from_the_file(fixtures, tmp_path):
    """As ``test_torch_bench.py`` runs the smoke, with ``--lm_data_dir``:
    T is the file's 80 (the smoke's cut to 32 does not apply) and V its
    90."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.bench", "--lm", "--smoke",
         "--lm_data_dir", fixtures["h5"], "--platform", "cpu", "--ledger",
         str(tmp_path / "ledger.jsonl")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "error" not in record and record["value"] > 0
    assert " T80 V90," in record["metric"]
    assert record["tokens_per_round"] % 80 == 0


def test_bench_lm_leaf_fails_as_the_reference_does(fixtures, capsys):
    record = tbench.main(["--lm", "--smoke", "--lm_data_dir",
                          fixtures["leaf"], "--lm_leaf", "1", "--platform",
                          "cpu", "--ledger", ""])
    assert record["value"] == 0.0 and "LEAF Shakespeare" in record["error"]
    assert tbench._exit_code(record) == 1
