"""The port's file-backed loaders and ``prepare`` CLI against the JAX
package's, on the same files.

- ``load_leaf_mnist`` on ``tests/fixtures/leaf_mnist``, the TFF h5
  loaders on ``tests/fixtures/fed_emnist`` and on a ``fed_cifar100``
  fixture, the image-folder loaders (materialised and manifest) on
  ``prepare`` fixtures, and ``uci``'s parsers and splits: every 8-tuple
  (and stream) array-equal to the reference's, dtypes included.
- ``load_dataset`` on each new name equal to the reference's; only the
  three segmentation names refuse.
- ``prepare``: ``layout`` the reference's text with the port's loader
  modules named; ``verify`` exit 0 on a good directory and 1, with the
  layout, on a missing one; ``fixture`` files holding the reference's
  data for the same dataset and client count (json and pickle files
  byte-equal, h5 files with equal groups and datasets, PNG files with
  equal pixels).
- The data modules import with h5py and PIL blocked (the card machine
  has neither).
- The reference's own cases retargeted at the port: ``test_data.py``'s
  ``TestLeafJson`` and ``TestTffH5`` (``slow`` there and here),
  ``test_data_extra.py``'s ``TestStreamingUCI``, ``TestImageFolder`` and
  ``TestVerticalFinance``,
  and ``test_prepare.py``."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import io
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from reference_scenarios import retarget

from fedml_tpu.data import imagefolder as jimagefolder
from fedml_tpu.data import leaf as jleaf
from fedml_tpu.data import prepare as jprepare
from fedml_tpu.data import registry as jregistry
from fedml_tpu.data import tff_h5 as jtff
from fedml_tpu.data import uci as juci
from fedml_tpu_torch.data import (imagefolder, leaf, prepare, registry,
                                  tff_h5, uci, vertical_finance)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXDIR = os.path.join(HERE, "fixtures")

# -- the reference's own cases, through the port ------------------------------
_data = retarget("test_data.py")
_extra = retarget("test_data_extra.py")
_prep = retarget("test_prepare.py")
TestLeafJson = pytest.mark.slow(_data.TestLeafJson)
TestTffH5 = pytest.mark.slow(_data.TestTffH5)
TestStreamingUCI = _extra.TestStreamingUCI
TestImageFolder = _extra.TestImageFolder
TestVerticalFinance = _extra.TestVerticalFinance
test_layout_docs_cover_all_datasets = _prep.test_layout_docs_cover_all_datasets
test_fixture_roundtrips_through_real_loader = \
    _prep.test_fixture_roundtrips_through_real_loader
test_committed_fixtures_load = _prep.test_committed_fixtures_load
test_verify_missing_dir_prints_layout = \
    _prep.test_verify_missing_dir_prints_layout
test_fixture_matches_layout_promise = _prep.test_fixture_matches_layout_promise


def test_the_retargeted_scenarios_run_the_port():
    assert _prep.main.__module__ == "fedml_tpu_torch.data.prepare"
    assert _extra.uci is uci and _extra.imagefolder is imagefolder
    assert _extra.vertical_finance is vertical_finance
    assert _data.load_dataset is registry.load_dataset


# -- helpers ------------------------------------------------------------------

def _equal(got, want):
    """Array-equal trees: dicts, lists (manifest paths), arrays with their
    dtypes, scalars and None."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    else:
        assert got == want


def _fixture(module, dataset, path, clients=None):
    argv = ["fixture", dataset, "--data_dir", str(path)]
    if clients:
        argv += ["--clients", str(clients)]
    assert module.main(argv) == 0
    return str(path)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """``prepare fixture`` outputs of both packages for the image and h5
    sets (written once; the landmarks one also as gld160k)."""
    out = {}
    for ds in ("fed_cifar100", "imagenet", "landmarks", "susy"):
        root = tmp_path_factory.mktemp(ds)
        out[ds] = (_fixture(prepare, ds, root / "port"),
                   _fixture(jprepare, ds, root / "ref"))
    land = out["landmarks"][0]
    shutil.copy(os.path.join(land, "gld23k_user_dict.csv"),
                os.path.join(land, "gld160k_user_dict.csv"))
    return out


# -- the loaders ---------------------------------------------------------------

@pytest.mark.parametrize("client_num", [None, 1])
def test_leaf_mnist_is_the_reference(client_num):
    d = os.path.join(FIXDIR, "leaf_mnist")
    _equal(leaf.load_leaf_mnist(d, client_num=client_num),
           jleaf.load_leaf_mnist(d, client_num=client_num))


@pytest.mark.parametrize("client_num", [None, 1])
def test_fed_emnist_is_the_reference(client_num):
    pytest.importorskip("h5py")
    d = os.path.join(FIXDIR, "fed_emnist")
    _equal(tff_h5.load_fed_emnist(d, client_num),
           jtff.load_fed_emnist(d, client_num))


@pytest.mark.parametrize("crop", [24, 0])
def test_fed_cifar100_is_the_reference(fixtures, crop):
    pytest.importorskip("h5py")
    d = fixtures["fed_cifar100"][0]
    got = tff_h5.load_fed_cifar100(d, crop=crop)
    _equal(got, jtff.load_fed_cifar100(d, crop=crop))
    assert got[5][0]["x"].shape[1:] == ((24, 24, 3) if crop else (32, 32, 3))


def test_fed_cifar100_map_keeps_the_per_client_rescale_test():
    """``x.max() > 1.5`` decides per client whether to divide by 255, as
    the reference's map does; the crop is centred."""
    rng = np.random.default_rng(0)
    for x in (rng.integers(0, 256, (3, 32, 32, 3)).astype(np.float32),
              rng.random((3, 32, 32, 3), np.float32),
              np.full((2, 32, 32, 3), 1.5, np.float32)):
        got = tff_h5.fed_cifar100_map(x)
        assert got.shape == (len(x), 24, 24, 3) and got.dtype == np.float32
        scaled = x / 255.0 if x.max() > 1.5 else x
        want = (scaled[:, 4:28, 4:28] - tff_h5.CIFAR100_MEAN) \
            / tff_h5.CIFAR100_STD
        np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("kw", [
    {"client_num": 2, "partition": "homo", "image_size": 8},
    {"client_num": 3, "partition": "hetero", "partition_alpha": 0.5,
     "image_size": 6, "seed": 2},
    {"client_num": 2, "partition": "homo", "image_size": 8,
     "materialize": False}])
def test_imagenet_is_the_reference(fixtures, kw):
    pytest.importorskip("PIL")
    d = fixtures["imagenet"][0]
    got = imagefolder.load_imagenet_federated(d, **kw)
    _equal(got, jimagefolder.load_imagenet_federated(d, **kw))
    if not kw.get("materialize", True):
        _equal(imagefolder.materialize_shard(got[5][0], 8),
               jimagefolder.materialize_shard(got[5][0], 8))


@pytest.mark.parametrize("kw", [{"image_size": 8}, {"client_num": 2,
                                                     "image_size": 5},
                                {"image_size": 8, "materialize": False}])
def test_landmarks_is_the_reference(fixtures, kw):
    pytest.importorskip("PIL")
    d = fixtures["landmarks"][0]
    _equal(imagefolder.load_landmarks_federated(d, **kw),
           jimagefolder.load_landmarks_federated(d, **kw))


def test_landmarks_central_test_csv_is_the_reference(fixtures, tmp_path):
    pytest.importorskip("PIL")
    d = str(tmp_path / "gld")
    shutil.copytree(fixtures["landmarks"][0], d)
    with open(os.path.join(d, "gld23k_user_dict.csv")) as f:
        rows = f.read().splitlines()
    with open(os.path.join(d, "gld23k_test.csv"), "w") as f:
        f.write("\n".join(rows[:1] + rows[1:4] + ["u999,im00000,99"]) + "\n")
    _equal(imagefolder.load_landmarks_federated(d, image_size=8),
           jimagefolder.load_landmarks_federated(d, image_size=8))


def test_uci_parsers_and_splits_are_the_reference(fixtures, tmp_path):
    path = os.path.join(fixtures["susy"][0], "SUSY.csv")
    for beta in (0.0, 0.5):
        _equal(uci.load_streaming_uci("susy", path, 4, 96, beta=beta, seed=3),
               juci.load_streaming_uci("susy", path, 4, 96, beta=beta,
                                       seed=3))
    room = tmp_path / "datatraining.txt"
    rng = np.random.default_rng(0)
    lines = ['"id","date","Temperature","Humidity","Light","CO2",'
             '"HumidityRatio","Occupancy"']
    for i in range(40):
        v = rng.random(5)
        lines.append(f'"{i}","2015-02-04 17:51:00",{v[0]:.4f},{v[1]:.4f},'
                     f'{v[2]:.2f},{v[3]:.2f},{v[4]:.6f},{i % 2}')
    room.write_text("\n".join(lines) + "\n")
    _equal(uci.load_streaming_uci("room", str(room), 3, 30, beta=0.4),
           juci.load_streaming_uci("room", str(room), 3, 30, beta=0.4))
    for kw in ({}, {"drift": 1.5, "seed": 4, "client_num": 3, "T": 20}):
        got = uci.load_synthetic_stream(**kw)
        _equal(got, juci.load_synthetic_stream(**kw))
        _equal(uci.as_sample_list(got), juci.as_sample_list(got))


# -- the registry -----------------------------------------------------------

def _args(**kw):
    base = dict(client_num_in_total=None, partition_method="hetero",
                partition_alpha=0.5, data_dir=None, seed=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("name,kw", [
    ("mnist", {}), ("femnist", {}), ("fed_emnist", {"client_num_in_total": 1}),
    ("fed_cifar100", {}), ("imagenet", {"client_num_in_total": 2,
                                        "image_size": 8}),
    ("ILSVRC2012", {"client_num_in_total": 2, "image_size": 8,
                    "partition_method": "homo"}),
    ("gld23k", {"image_size": 8}), ("gld160k", {"image_size": 8})])
def test_load_dataset_is_the_reference(fixtures, name, kw):
    pytest.importorskip("h5py")
    pytest.importorskip("PIL")
    dirs = {"mnist": os.path.join(FIXDIR, "leaf_mnist"),
            "femnist": os.path.join(FIXDIR, "fed_emnist"),
            "fed_emnist": os.path.join(FIXDIR, "fed_emnist"),
            "fed_cifar100": fixtures["fed_cifar100"][0],
            "imagenet": fixtures["imagenet"][0],
            "ILSVRC2012": fixtures["imagenet"][0],
            "gld23k": fixtures["landmarks"][0],
            "gld160k": fixtures["landmarks"][0]}
    args = _args(data_dir=dirs[name], **kw)
    _equal(registry.load_dataset(args, name),
           jregistry.load_dataset(args, name))


@pytest.mark.parametrize("name", ["synthetic_segmentation", "pascal_voc",
                                  "coco_seg"])
def test_only_segmentation_is_refused(name):
    # ROADMAP A14c ported the segmentation sets: the registry refuses no
    # name, and each loads (or misses its files) as the reference's does
    assert not hasattr(registry, "_UNPORTED")
    args = _args(client_num_in_total=2, n_train=8, n_test=4, image_size=8)
    if name == "synthetic_segmentation":
        _equal(registry.load_dataset(args, name),
               jregistry.load_dataset(args, name))
        return
    for reg in (registry, jregistry):
        with pytest.raises(FileNotFoundError):
            reg.load_dataset(args, name)


# -- prepare --------------------------------------------------------------------

def test_prepare_tables_are_the_reference():
    assert prepare.ALIASES == jprepare.ALIASES
    assert sorted(prepare.DATASETS) == sorted(jprepare.DATASETS)
    for ds, text in jprepare.LAYOUTS.items():
        assert prepare.LAYOUTS[ds] == text.replace("fedml_tpu.data.",
                                                   "fedml_tpu_torch.data.")
        assert "fedml_tpu_torch.data." in prepare.LAYOUTS[ds]


@pytest.mark.parametrize("ds", sorted(jprepare.DATASETS) + ["mnist",
                                                            "gld160k"])
def test_prepare_layout_prints_the_reference_text(ds, capsys):
    assert prepare.main(["layout", ds]) == 0
    got = capsys.readouterr().out
    assert jprepare.main(["layout", ds]) == 0
    want = capsys.readouterr().out
    assert got == want.replace("fedml_tpu.data.", "fedml_tpu_torch.data.")


def _h5_tree(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(
            name, obj[()] if isinstance(obj, h5py.Dataset) else "group"))
    return out


def _png_pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _same_files(got_dir, want_dir):
    """The two fixture trees hold the same files with the same data."""
    walk = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)
                            for r, _, fs in os.walk(d) for f in fs)
    names = walk(want_dir)
    assert walk(got_dir) == names and names
    for name in names:
        a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".h5"):
            ta, tb = _h5_tree(a), _h5_tree(b)
            assert sorted(ta) == sorted(tb)
            for k in tb:
                _equal(ta[k], tb[k])
        elif name.endswith((".png", ".jpg")):
            np.testing.assert_array_equal(_png_pixels(a), _png_pixels(b))
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


@pytest.mark.parametrize("ds,clients", [
    ("leaf_mnist", 4), ("cifar10", None), ("cifar100", None),
    ("cinic10", None), ("leaf_shakespeare", None), ("susy", 5),
    ("fed_emnist", None), ("fed_cifar100", 2), ("fed_shakespeare", None),
    ("stackoverflow_lr", None), ("imagenet", 1), ("landmarks", 2)])
def test_prepare_fixture_holds_the_reference_data(ds, clients, tmp_path,
                                                  capsys):
    if ds.startswith(("fed_", "stackoverflow")):
        pytest.importorskip("h5py")
    if ds in ("imagenet", "landmarks"):
        pytest.importorskip("PIL")
    got = _fixture(prepare, ds, tmp_path / "port", clients)
    want = _fixture(jprepare, ds, tmp_path / "ref", clients)
    out = capsys.readouterr().out
    assert out.count(": OK") == 2
    _same_files(got, want)


def test_prepare_verify_exit_codes(fixtures, tmp_path, capsys):
    d = fixtures["fed_cifar100"][0]
    assert prepare.main(["verify", "fed_cifar100", "--data_dir", d]) == 0
    assert "fed_cifar100: OK -- 3 clients" in capsys.readouterr().out
    assert prepare.main(["verify", "mnist", "--data_dir",
                         os.path.join(FIXDIR, "leaf_mnist")]) == 0
    assert "leaf_mnist: OK" in capsys.readouterr().out
    assert prepare.main(["verify", "imagenet", "--data_dir",
                         str(tmp_path / "none")]) == 1
    err = capsys.readouterr().err
    assert "INVALID: FileNotFoundError" in err
    assert prepare.LAYOUTS["imagenet"] in err
    with pytest.raises(SystemExit):
        prepare.main(["verify", "susy"])  # --data_dir is required


def test_prepare_runs_as_a_module(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.data.prepare", "fixture",
         "susy", "--data_dir", str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "susy: OK -- 4 client streams, 64 samples" in out.stdout


def test_data_modules_import_without_h5py_and_pil():
    """With ``h5py`` and ``PIL`` unimportable the data modules still
    import, and the fixtures that need neither still write and load."""
    code = io.StringIO()
    code.write("import sys\n")
    code.write("for name in ('h5py', 'PIL', 'PIL.Image'):\n")
    code.write("    sys.modules[name] = None\n")
    code.write("import fedml_tpu_torch.data.tff_h5, "
               "fedml_tpu_torch.data.imagefolder, "
               "fedml_tpu_torch.data.prepare as p, "
               "fedml_tpu_torch.data.registry\n")
    code.write("import tempfile\n")
    code.write("d = tempfile.mkdtemp()\n")
    code.write("assert p.main(['fixture', 'cifar10', '--data_dir', d]) == 0\n")
    code.write("try:\n    import h5py\nexcept ImportError:\n    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code.getvalue()], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
