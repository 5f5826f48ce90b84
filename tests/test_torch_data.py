"""The port's data legs byte-equal with the JAX package's:
``load_synthetic_federated`` (natural, homo and LDA splits),
``load_synthetic_sequences``, ``load_dataset`` for every ported name (the
CIFAR family from a tiny fixture written under ``tmp_path`` in the
format the loaders read), the partitions, ``normalized_black``,
``pack_cohort`` (numpy backend) and the registry's refusals."""

import os
import pickle
import types

import numpy as np
import pytest

from fedml_tpu.core import partition as jpartition
from fedml_tpu.data import cifar as jcifar
from fedml_tpu.data import registry as jregistry
from fedml_tpu.data import synthetic as jsynthetic
from fedml_tpu.parallel import packing as jpacking
from fedml_tpu_torch.core import partition
from fedml_tpu_torch.data import cifar, registry, synthetic
from fedml_tpu_torch.parallel import packing


def _assert_eight_tuple_equal(got, want):
    assert len(got) == len(want) == 8
    assert got[0] == want[0] and got[1] == want[1] and got[7] == want[7]
    for i in (2, 3):
        for k in ("x", "y"):
            assert got[i][k].dtype == want[i][k].dtype
            np.testing.assert_array_equal(got[i][k], want[i][k])
    assert got[4] == want[4]
    for i in (5, 6):
        assert sorted(got[i]) == sorted(want[i])
        for c in want[i]:
            for k in ("x", "y"):
                assert got[i][c][k].dtype == want[i][c][k].dtype
                np.testing.assert_array_equal(got[i][c][k], want[i][c][k])


@pytest.mark.parametrize("kw", [
    {}, {"partition": "homo", "seed": 3},
    {"partition": "hetero", "partition_alpha": 0.3, "seed": 1},
    {"client_num": 7, "n_train": 300, "n_test": 61, "alpha": 0.5,
     "beta": 1.0, "feature_dim": 12, "class_num": 5}])
def test_synthetic_federated_is_byte_equal(kw):
    _assert_eight_tuple_equal(synthetic.load_synthetic_federated(**kw),
                              jsynthetic.load_synthetic_federated(**kw))


@pytest.mark.parametrize("kw", [{}, {"client_num": 3, "n_train": 50,
                                     "n_test": 7, "seq_len": 9,
                                     "vocab_size": 17, "seed": 4}])
def test_synthetic_sequences_are_byte_equal(kw):
    _assert_eight_tuple_equal(synthetic.load_synthetic_sequences(**kw),
                              jsynthetic.load_synthetic_sequences(**kw))


def _write_cifar_fixture(root, n_batch=20, n_test=12):
    rng = np.random.default_rng(0)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = n_test if name == "test_batch" else n_batch
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             b"labels": [int(v) for v in rng.integers(0, 10, n)]}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)
    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base)
    for name, n in (("train", 5 * n_batch), ("test", n_test)):
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             b"fine_labels": [int(v) for v in rng.integers(0, 100, n)]}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)
    np.savez(os.path.join(root, "cinic10.npz"),
             x_train=rng.integers(0, 256, (100, 32, 32, 3)).astype(np.uint8),
             y_train=rng.integers(0, 10, 100),
             x_test=rng.integers(0, 256, (12, 32, 32, 3)).astype(np.uint8),
             y_test=rng.integers(0, 10, 12))


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cifar"))
    _write_cifar_fixture(root)
    return root


def _args(**kw):
    base = dict(client_num_in_total=4, partition_method="hetero",
                partition_alpha=0.5, data_dir=None, seed=0, n_train=None,
                n_test=None, image_size=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "cinic10"])
@pytest.mark.parametrize("method", ["homo", "hetero", "hetero-fix"])
def test_cifar_family_is_byte_equal(cifar_dir, name, method):
    if name == "cifar100" and method == "hetero":
        # LDA over 100 classes needs more samples than the fixture holds:
        # both sides refuse the infeasible partition alike
        with pytest.raises(ValueError, match="infeasible"):
            jregistry.load_dataset(_args(data_dir=cifar_dir,
                                         client_num_in_total=11,
                                         partition_method=method), name)
        with pytest.raises(ValueError, match="infeasible"):
            registry.load_dataset(_args(data_dir=cifar_dir,
                                        client_num_in_total=11,
                                        partition_method=method), name)
        return
    args = _args(data_dir=cifar_dir, partition_method=method)
    _assert_eight_tuple_equal(registry.load_dataset(args, name),
                              jregistry.load_dataset(args, name))


def test_cifar_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="synthetic_images"):
        cifar.load_cifar_federated("cifar10", str(tmp_path))


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "cinic10"])
def test_normalized_black_is_equal(name):
    assert cifar.normalized_black(name) == jcifar.normalized_black(name)


@pytest.mark.parametrize("name,kw", [
    ("synthetic", {}), ("synthetic", {"partition_method": "homo",
                                      "n_train": 120, "n_test": 30}),
    ("synthetic_images", {"image_size": 8, "n_train": 200, "n_test": 20}),
    ("synthetic_sequences", {"n_train": 80, "n_test": 16,
                             "image_size": 8})])
def test_load_dataset_is_byte_equal(name, kw):
    args = _args(**kw)
    _assert_eight_tuple_equal(registry.load_dataset(args, name),
                              jregistry.load_dataset(args, name))


@pytest.mark.parametrize("name,item", [
    ("synthetic_segmentation", "A14"), ("pascal_voc", "A14"),
    ("mnist", "A14"), ("femnist", "A14"), ("fed_cifar100", "A14"),
    ("fed_emnist", "A14"), ("coco_seg", "A14"),
    ("ILSVRC2012", "A14"), ("gld160k", "A14"),
    ("imagenet", "A14"), ("gld23k", "A14")])
def test_registry_refuses_unported_names(name, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        registry.load_dataset(_args(), name)


def test_registry_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown dataset"):
        registry.load_dataset(_args(), "no_such_set")


@pytest.mark.parametrize("seed", [0, 5])
def test_hetero_fix_partition_is_equal(seed):
    labels = np.random.default_rng(seed).integers(0, 10, 300)
    got = partition.hetero_fix_partition(labels, 6, seed)
    want = jpartition.hetero_fix_partition(labels, 6, seed)
    assert sorted(got) == sorted(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("bs,epochs", [(4, 1), (3, 2), (-1, 1)])
def test_pack_cohort_is_byte_equal(monkeypatch, bs, epochs):
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    rng = np.random.default_rng(0)
    datasets = [{"x": rng.normal(size=(n, 3)).astype(np.float32),
                 "y": rng.integers(0, 5, n)} for n in (7, 1, 0, 12)]
    got_rng, want_rng = np.random.default_rng(3), np.random.default_rng(3)
    got = packing.pack_cohort(datasets, bs, epochs, rng=got_rng,
                              return_indices=True)
    want = jpacking.pack_cohort(datasets, bs, epochs, rng=want_rng,
                                return_indices=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got_rng.integers(0, 2 ** 32) == want_rng.integers(0, 2 ** 32)
