"""The port's split and vertical FL against the JAX package's, on the CPU.

- ``SplitNNAPI``: 2 rounds over 3 ragged clients (SGD with momentum, so
  the optimizer states count) from the reference's weights carried over,
  both sides packing with numpy: client halves, server half, round
  metrics and each client's evaluation within 1e-5, and the halves
  personal.
- ``main_splitnn``'s halves (the conv stem with flax's ``"SAME"`` padding
  at 16x16 and 32x32, the dense stem, the dense head) against the
  reference main's flax modules from the same weights.
- ``VerticalFLAPI``: ``fit`` for 2 epochs with 2 and 3 parties, the
  reference's weights carried over: every epoch's record and the party
  models within 1e-5.
- The finance loaders bit-equal to the reference's (which parse through
  pandas) on Lending Club and NUS-WIDE fixtures with empty fields,
  trailing separators and NaN columns; the reference's own
  ``TestVerticalFinance`` runs retargeted in ``test_torch_data_files.py``.
- ``main_splitnn`` and ``main_vfl``'s command lines of
  ``test_experiments.py`` through the port with ``--platform cpu``, and
  ``main_vfl`` on the file-backed vertical sets against the reference's
  main (the synthetic set's loader is ``test_vfl_fit_is_the_reference``'s).
"""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import csv
import os
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.splitnn import SplitNNAPI as JaxSplitNNAPI
from fedml_tpu.algorithms.vertical import VerticalFLAPI as JaxVerticalFLAPI
from fedml_tpu.data import load_synthetic_federated
from fedml_tpu.data import vertical_finance as jvf
from fedml_tpu.experiments import main_splitnn as jmain_splitnn
from fedml_tpu.models import linear as jlinear
from fedml_tpu_torch.algorithms.splitnn import SplitNNAPI
from fedml_tpu_torch.algorithms.vertical import VerticalFLAPI
from fedml_tpu_torch.data import vertical_finance as vf
from fedml_tpu_torch.experiments import main_splitnn
from fedml_tpu_torch.models.linear import LocalModel
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

TOL = 1e-5


def _args(**kw):
    base = dict(client_num_per_round=3, comm_round=2, epochs=1,
                batch_size=16, lr=0.2, client_optimizer="sgd", wd=0.0,
                momentum=0.9, frequency_of_the_test=100, ci=0, seed=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _params(tree, lead=0):
    return cv_variables_to_state(jax.tree.map(np.array, tree),
                                 lead=lead)["params"]


def _same(got_params, want_tree, lead=0):
    """Port params against a flax params tree, leaf by leaf."""
    have = dict(jax.tree_util.tree_leaves_with_path(
        cv_state_to_variables({"params": got_params}, lead=lead)["params"]))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.array, want_tree))
    assert len(have) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(have[path], leaf, atol=TOL)


# -- SplitNN ------------------------------------------------------------------

class _JaxClientHalf(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.relu(nn.Dense(16)(x.reshape((x.shape[0], -1))))


class _JaxServerHalf(nn.Module):
    classes: int = 10

    @nn.compact
    def __call__(self, acts):
        return nn.Dense(self.classes)(nn.relu(nn.Dense(32)(acts)))


class _ClientHalf(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(d, 16)

    def forward(self, x):
        return torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))


class _ServerHalf(torch.nn.Module):
    # flax numbers the outer Dense first: Dense_0 is the output layer
    def __init__(self, classes=10):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(32, classes)
        self.Dense_1 = torch.nn.Linear(16, 32)

    def forward(self, acts):
        return self.Dense_0(torch.relu(self.Dense_1(acts)))


@pytest.fixture(scope="module")
def split_runs():
    # three clients of different sizes (ragged step counts: 4, 2, 3)
    ds = list(load_synthetic_federated(client_num=3, n_train=150, n_test=60,
                                       seed=0))
    ds[5] = {i: {k: v[:n] for k, v in ds[5][i].items()}
             for i, n in enumerate((50, 30, 41))}
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        japi = JaxSplitNNAPI(ds, _JaxClientHalf(), _JaxServerHalf(), _args())
        api = SplitNNAPI(ds, _ClientHalf(60), _ServerHalf(), _args(),
                         device="cpu")
        api.client_params = _params(japi.client_params, lead=1)
        api.server_params = _params(japi.server_params)
        init = {k: v.clone() for k, v in api.client_params.items()}
        rounds = [(japi.train_one_round(), api.train_one_round())
                  for _ in range(2)]
    finally:
        mp.undo()
    return japi, api, rounds, init


def _trace(opt_state):
    """The momentum buffer of an optax chain's state."""
    for leaf in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(
            x, "trace")):
        if hasattr(leaf, "trace"):
            return leaf.trace
    raise AssertionError("no TraceState")


def test_split_rounds_are_the_reference(split_runs):
    japi, api, rounds, _ = split_runs
    for want, got in rounds:
        assert sorted(got) == sorted(want)
        for k in ("Train/Loss", "Train/Acc"):
            np.testing.assert_allclose(got[k], want[k], atol=TOL)
    _same(api.client_params, japi.client_params["params"], lead=1)
    _same(api.server_params, japi.server_params["params"])
    # the server half's momentum moved through every client's steps
    _same(api.server_opt, _trace(japi.server_opt)["params"])
    _same(api.client_opt, _trace(japi.client_opt)["params"], lead=1)
    for c in range(3):
        np.testing.assert_allclose(api.evaluate(c)["Test/Acc"],
                                   japi.evaluate(c)["Test/Acc"], atol=TOL)


def test_client_halves_are_personal(split_runs):
    _, api, _, init = split_runs
    p = api.client_params["Dense_0.weight"]
    assert not torch.allclose(p[0], p[1])
    # every client trained its own half
    for c in range(3):
        assert not torch.allclose(p[c], init["Dense_0.weight"][c])


def test_masked_steps_leave_the_state_untouched():
    """A client with no data runs only masked steps: its half and its
    optimizer state, and the server's, stay as they were."""
    ds = load_synthetic_federated(client_num=2, n_train=60, n_test=20,
                                  seed=0)
    empty = {"x": ds[5][1]["x"][:0], "y": ds[5][1]["y"][:0]}
    ds = list(ds)
    ds[5] = {0: empty, 1: ds[5][1]}
    api = SplitNNAPI(ds, _ClientHalf(60), _ServerHalf(), _args(),
                     device="cpu")
    before = {k: v.clone() for k, v in api.client_params.items()}
    api.train_one_round()
    for k, v in api.client_params.items():
        torch.testing.assert_close(v[0], before[k][0], rtol=0, atol=0)
        assert not torch.equal(v[1], before[k][1])
        assert not api.client_opt[k][0].any()


def test_splitnn_learns():
    ds = load_synthetic_federated(client_num=3, n_train=300, n_test=60,
                                  alpha=0.0, beta=0.0, seed=0)
    api = SplitNNAPI(ds, _ClientHalf(60), _ServerHalf(),
                     _args(lr=0.2, momentum=0.0), device="cpu")
    m1 = api.train_one_round()
    for _ in range(4):
        m2 = api.train_one_round()
    assert m2["Train/Acc"] > m1["Train/Acc"]
    assert 0.0 <= api.evaluate(client_idx=0)["Test/Acc"] <= 1.0


@pytest.mark.parametrize("cut, shape", [("conv", (16, 16, 3)),
                                        ("conv", (32, 32, 3)),
                                        ("conv", (15, 15, 1)),
                                        ("dense", (8, 8, 3))])
def test_split_pair_is_the_reference_main(cut, shape):
    """The main's halves against flax's from the same weights; the stride-2
    convs pad as ``"SAME"`` does ((0, 1) on an even side)."""
    x = np.random.default_rng(0).normal(size=(4,) + shape).astype(np.float32)
    jstem = (jmain_splitnn.ConvStem() if cut == "conv"
             else jmain_splitnn.DenseStem())
    sv = jstem.init(jax.random.PRNGKey(0), jnp.asarray(x))
    acts = np.asarray(jstem.apply(sv, jnp.asarray(x)))
    jhead = jmain_splitnn.DenseHead(classes=7)
    hv = jhead.init(jax.random.PRNGKey(1), jnp.asarray(acts))
    logits = np.asarray(jhead.apply(hv, jnp.asarray(acts)))
    stem, head = main_splitnn.split_pair(cut, shape, 7)
    stem.load_state_dict(_params(sv))
    head.load_state_dict(_params(hv))
    with torch.no_grad():
        got = stem(torch.as_tensor(x))
        np.testing.assert_allclose(got.numpy(), acts, atol=1e-5)
        np.testing.assert_allclose(head(got).numpy(), logits, atol=1e-5)
    assert got.shape[1] == acts.shape[1]


# -- vertical FL ---------------------------------------------------------------

def _vfl_pair(party_num):
    # 256 training rows: whole batches of 32, one jit of the reference's
    train, test = jvf.load_synthetic_vertical(party_num=party_num, n=320,
                                              seed=1)
    args = _args(epochs=2, lr=0.1, batch_size=32, momentum=0.0)
    kw = dict(test_party_data=test[:-1], test_labels=test[-1])
    japi = JaxVerticalFLAPI(
        [jlinear.LocalModel(hidden_dims=(16,), output_dim=1)
         for _ in range(party_num)], train[:-1], train[-1], args, **kw)
    api = VerticalFLAPI(
        [LocalModel(x.shape[1], hidden_dims=(16,), output_dim=1)
         for x in train[:-1]], train[:-1], train[-1], args, device="cpu",
        **kw)
    api.params = [_params(p) for p in japi.params]
    return japi, japi.fit(), api, api.fit()


@pytest.mark.parametrize("party_num", [2, 3])
def test_vfl_fit_is_the_reference(party_num):
    japi, want, api, got = _vfl_pair(party_num)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, atol=TOL)
    for p, jp in zip(api.params, japi.params):
        _same(p, jp["params"])


def test_vfl_two_party_learns():
    rng = np.random.default_rng(0)
    n = 600
    x = rng.normal(size=(n, 20)).astype(np.float32)
    w = rng.normal(size=20)
    y = (x @ w > 0).astype(np.float32)
    api = VerticalFLAPI(
        [LocalModel(12, hidden_dims=(16,), output_dim=1),
         LocalModel(8, hidden_dims=(16,), output_dim=1)],
        [x[:500, :12], x[:500, 12:]], y[:500],
        _args(epochs=8, lr=0.1, batch_size=64, momentum=0.0),
        test_party_data=[x[500:, :12], x[500:, 12:]], test_labels=y[500:],
        device="cpu")
    hist = api.fit()
    assert hist[-1]["Train/Acc"] > hist[0]["Train/Acc"]
    assert hist[-1]["Test/Acc"] > 0.6


def test_vfl_refuses_mismatched_parties():
    with pytest.raises(ValueError, match="party models"):
        VerticalFLAPI([LocalModel(3)], [np.zeros((4, 3)), np.zeros((4, 2))],
                      np.zeros(4), _args(), device="cpu")


# -- the finance loaders against pandas ----------------------------------------

def _equal_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, list):
            _equal_arrays(a, b)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _loan_fixture(path, n=40, widths=5):
    """A loan csv with every feature group's first names, a column the
    loaders do not take, empty fields and pandas' NA strings, values
    of ``widths`` magnitudes and a blank line."""
    cols = (jvf.QUALIFICATION_FEAT[:4] + jvf.LOAN_FEAT[:3]
            + jvf.DEBT_FEAT[:3] + jvf.REPAYMENT_FEAT[:2]
            + jvf.MULTI_ACC_FEAT[:3] + jvf.MAL_BEHAVIOR_FEAT[:2])
    rng = np.random.default_rng(1)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id"] + cols + ["target"])
        for i in range(n):
            row = [f"r{i}"] + [repr(float(v)) for v in
                               rng.normal(size=len(cols)) * 10 ** (i % widths)]
            if i % 7 == 3:
                row[2] = ""
            if i % 11 == 5:
                row[-1] = "NA"
            if i == 9:
                row[4] = "1e-3"
            w.writerow(row + [int(rng.integers(0, 2))])
            if i == 20:
                f.write("\n")
    return path


@pytest.mark.parametrize("parties", [2, 3])
def test_loan_loaders_are_pandas(tmp_path, parties):
    d = tmp_path / "lc"
    d.mkdir()
    _loan_fixture(d / "loan_processed.csv")
    name = "two" if parties == 2 else "three"
    fn = f"loan_load_{name}_party_data"
    got = getattr(vf, fn)(str(d))
    want = getattr(jvf, fn)(str(d))
    _equal_arrays(got, want)
    assert np.isnan(got[0][0]).any()  # the empty fields came through
    # a file path works as the directory does
    _equal_arrays(getattr(vf, fn)(str(d / "loan_processed.csv")), want)


def test_loan_missing_names_the_stand_in(tmp_path):
    with pytest.raises(vf.MissingDataError, match="load_synthetic_vertical"):
        vf.loan_load_two_party_data(str(tmp_path))
    with pytest.raises(ValueError):
        vf.loan_load_three_party_data(str(tmp_path / "absent"))


def _nus_fixture(root, n=15, dtype="Train", tail=""):
    rng = np.random.default_rng(2)
    lbl = root / "Groundtruth" / "TrainTestLabels"
    lbl.mkdir(parents=True, exist_ok=True)
    person = rng.integers(0, 2, n)
    animal = np.where(rng.random(n) < 0.3, person, 1 - person)
    for name, v in (("person", person), ("animal", animal)):
        np.savetxt(lbl / f"Labels_{name}_{dtype}.txt", v, fmt="%d")
    feat = root / "Low_Level_Features"
    feat.mkdir(exist_ok=True)
    for name, k in (("CH", 4), ("EDH", 3), ("WT", 2)):
        rows = rng.random((n, k))
        with open(feat / f"{dtype}_Normalized_{name}.dat", "w") as f:
            for r in rows:
                f.write(" ".join(f"{v:.6f}" for v in r) + tail + "\n")
    # a file the loader skips
    (feat / f"{dtype}_Other.dat").write_text("1 2\n")
    tags = root / "NUS_WID_Tags"
    tags.mkdir(exist_ok=True)
    with open(tags / f"{dtype}_Tags1k.dat", "w") as f:
        for r in rng.integers(0, 2, (n, 6)):
            # the real files end each row with a tab: an empty last column
            f.write("\t".join(str(v) for v in r) + "\t\n")
    return root


@pytest.mark.parametrize("tail", ["", " "])
@pytest.mark.parametrize("labels, neg, n_samples", [
    (["person", "animal"], 0, -1), (["person"], -1, 5)])
def test_nus_wide_loader_is_pandas(tmp_path, tail, labels, neg, n_samples):
    root = _nus_fixture(tmp_path, tail=tail)
    kw = dict(neg_label=neg, n_samples=n_samples, dtype="Train")
    got = vf.nus_wide_load_two_party_data(str(root), labels, **kw)
    want = jvf.nus_wide_load_two_party_data(str(root), labels, **kw)
    _equal_arrays(list(got), list(want))
    assert got[0].shape[1] == 9 and got[1].shape[1] == 6


def test_nus_wide_nan_columns_drop_as_pandas_drops_them(tmp_path):
    """A short feature row pads with NaN and drops its column; a tag row
    with an empty middle field drops that column too."""
    root = _nus_fixture(tmp_path, n=6)
    ch = root / "Low_Level_Features" / "Train_Normalized_CH.dat"
    lines = ch.read_text().splitlines()
    lines[2] = " ".join(lines[2].split()[:3])
    ch.write_text("\n".join(lines) + "\n")
    tags = root / "NUS_WID_Tags" / "Train_Tags1k.dat"
    lines = tags.read_text().splitlines()
    fields = lines[4].split("\t")
    fields[1] = ""
    lines[4] = "\t".join(fields)
    tags.write_text("\n".join(lines) + "\n")
    got = vf.nus_wide_load_two_party_data(str(root), ["person", "animal"])
    want = jvf.nus_wide_load_two_party_data(str(root), ["person", "animal"])
    _equal_arrays(list(got), list(want))
    assert got[0].shape[1] == 8 and got[1].shape[1] == 5


def test_nus_wide_missing_raises(tmp_path):
    with pytest.raises(vf.MissingDataError, match="NUS-WIDE"):
        vf.nus_wide_load_two_party_data(str(tmp_path), ["person"])


@pytest.mark.parametrize("party_num", [2, 3, 4])
def test_synthetic_vertical_is_the_reference(party_num):
    _equal_arrays(vf.load_synthetic_vertical(party_num=party_num, n=50,
                                             seed=3),
                  jvf.load_synthetic_vertical(party_num=party_num, n=50,
                                              seed=3))


# -- the mains -----------------------------------------------------------------

TINY = ["--client_num_in_total", "4", "--client_num_per_round", "2",
        "--comm_round", "2", "--epochs", "1", "--batch_size", "8",
        "--frequency_of_the_test", "1", "--ci", "1", "--platform", "cpu"]


def test_main_vfl():
    from fedml_tpu_torch.experiments import main_vfl
    api, history = main_vfl.main(
        ["--dataset", "synthetic", "--party_num", "2", "--lr", "0.1",
         "--epochs", "2"] + TINY)
    assert len(history) >= 1
    assert api.device.type == "cpu" and api.n_parties == 2


def test_main_splitnn():
    api, _ = main_splitnn.main(
        ["--dataset", "synthetic_images", "--cut", "conv", "--lr", "0.1",
         "--n_train", "64", "--n_test", "32", "--image_size", "16"] + TINY)
    assert api is not None
    assert api.device.type == "cpu" and api.round_idx == 2


@pytest.mark.parametrize("dataset", ["lending_club", "nus_wide"])
def test_main_vfl_is_the_reference_main(tmp_path, dataset):
    """The same argv through both mains, the port from the reference's
    party weights: every epoch's record within 1e-5."""
    from fedml_tpu.experiments import main_vfl as jmain
    from fedml_tpu_torch.experiments import main_vfl
    if dataset == "lending_club":
        _loan_fixture(tmp_path / "loan_processed.csv", n=60, widths=1)
    elif dataset == "nus_wide":
        _nus_fixture(tmp_path, n=30)
        _nus_fixture(tmp_path, n=12, dtype="Test")
    argv = ["--dataset", dataset, "--data_dir", str(tmp_path), "--epochs",
            "2", "--batch_size", "16", "--lr", "0.05", "--party_num", "3",
            "--client_num_in_total", "3"]

    inits = []
    jorig, orig = JaxVerticalFLAPI.__init__, VerticalFLAPI.__init__

    def jinit(self, *a, **kw):
        jorig(self, *a, **kw)
        inits.append(self.params)

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        self.params = [_params(p) for p in inits[0]]

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxVerticalFLAPI, "__init__", jinit)
    mp.setattr(VerticalFLAPI, "__init__", init)
    try:
        if dataset == "lending_club":
            # the reference's data has NaN fields: train on the rows and
            # columns without, through both loaders alike
            for mod in (jvf, vf):
                for fn in ("loan_load_two_party_data",
                           "loan_load_three_party_data"):
                    mp.setattr(mod, fn, _without_nan(getattr(mod, fn)))
        _, want = jmain.main(argv + ["--platform", "cpu"])
        api, got = main_vfl.main(argv + ["--platform", "cpu"])
    finally:
        mp.undo()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k, v in w.items():
            assert np.isfinite(g[k])
            np.testing.assert_allclose(g[k], v, atol=TOL)


def _without_nan(load):
    def wrapped(data_dir):
        train, test = load(data_dir)
        return ([np.nan_to_num(a) for a in train],
                [np.nan_to_num(a) for a in test])
    return wrapped


@pytest.mark.parametrize("main, argv", [
    ("main_splitnn", ["--mesh", "2"]),
    ("main_vfl", ["--mesh", "2"]),
    ("main_vfl", ["--trace", "1"]),
])
def test_mains_refuse_unported_flags(main, argv, tmp_path, monkeypatch):
    """``--mesh`` waits for ROADMAP A15. ``--trace`` parses and, as in
    the reference's VFL main (which opens no observability scope), writes
    no trace."""
    import importlib
    module = importlib.import_module(f"fedml_tpu_torch.experiments.{main}")
    if "--mesh" in argv:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            module.main(argv + ["--platform", "cpu"])
        return
    monkeypatch.chdir(tmp_path)
    module.main(argv + ["--platform", "cpu", "--dataset",
                        "synthetic_vertical", "--epochs", "1"])
    assert not os.path.exists(tmp_path / "trace.json")
