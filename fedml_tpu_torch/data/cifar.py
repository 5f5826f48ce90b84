"""CIFAR-10 / CIFAR-100 / CINIC-10 from local files with LDA partitioning
(counterpart of ``fedml_tpu/data/cifar.py``; byte-equal for the same
files and seed).

CIFAR is read from the standard python pickle batches
(``cifar-10-batches-py``, ``cifar-100-python``), CINIC-10 from
``<data_dir>/cinic10.npz``; nothing is downloaded. Images are normalised
per channel with the dataset's statistics; the train set is split
``homo``, ``hetero`` (Dirichlet alpha) or ``hetero-fix``, the test set
IID. Augmentation runs on the device (``data/augment.py``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from fedml_tpu_torch.core.partition import (
    hetero_fix_partition, homo_partition,
    non_iid_partition_with_dirichlet_distribution)

_STATS = {
    "cifar10": ([0.4914, 0.4822, 0.4465], [0.2470, 0.2435, 0.2616], 10),
    "cifar100": ([0.5071, 0.4865, 0.4409], [0.2673, 0.2564, 0.2762], 100),
    "cinic10": ([0.4789, 0.4723, 0.4305], [0.2421, 0.2383, 0.2587], 10),
}


def normalized_black(dataset_name):
    """Per-channel value of a black pixel after this dataset's
    normalisation, ``(0 - mean) / std``: the fill of the on-device crop's
    padding, since the shards are stored normalised."""
    mean, std, _ = _STATS[dataset_name]
    return [-m / s for m, s in zip(mean, std)]


def _to_nhwc(flat):
    return flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(
        np.float32)


def _unpickle(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _load_cifar10_raw(data_dir):
    base = os.path.join(data_dir, "cifar-10-batches-py")
    xs, ys = [], []
    for i in range(1, 6):
        d = _unpickle(os.path.join(base, f"data_batch_{i}"))
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    d = _unpickle(os.path.join(base, "test_batch"))
    return (_to_nhwc(np.concatenate(xs)), np.asarray(ys, np.int64),
            _to_nhwc(d[b"data"]), np.asarray(d[b"labels"], np.int64))


def _load_cifar100_raw(data_dir):
    base = os.path.join(data_dir, "cifar-100-python")
    tr = _unpickle(os.path.join(base, "train"))
    te = _unpickle(os.path.join(base, "test"))
    return (_to_nhwc(tr[b"data"]), np.asarray(tr[b"fine_labels"], np.int64),
            _to_nhwc(te[b"data"]), np.asarray(te[b"fine_labels"], np.int64))


def _load_npz_raw(data_dir, name):
    path = os.path.join(data_dir, f"{name}.npz")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{name} archive not found under {data_dir} (expected {path} "
            "with x_train/y_train/x_test/y_test)")
    z = np.load(path)
    return (z["x_train"].astype(np.float32), z["y_train"].astype(np.int64),
            z["x_test"].astype(np.float32), z["y_test"].astype(np.int64))


def load_cifar_federated(dataset_name, data_dir, client_num=10,
                         partition="hetero", partition_alpha=0.5, seed=0):
    """The 8-tuple dataset contract of one of ``cifar10``, ``cifar100``
    or ``cinic10`` read from ``data_dir``."""
    mean, std, class_num = _STATS[dataset_name]
    try:
        if dataset_name == "cifar10":
            x_train, y_train, x_test, y_test = _load_cifar10_raw(data_dir)
        elif dataset_name == "cifar100":
            x_train, y_train, x_test, y_test = _load_cifar100_raw(data_dir)
        else:
            x_train, y_train, x_test, y_test = _load_npz_raw(data_dir,
                                                             dataset_name)
    except (FileNotFoundError, TypeError) as e:
        raise FileNotFoundError(
            f"{dataset_name} raw data unavailable under {data_dir}: {e}. "
            "Use dataset='synthetic_images' without local files.") from e
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    x_train = ((x_train / 255.0 if x_train.max() > 1.5 else x_train)
               - mean) / std
    x_test = ((x_test / 255.0 if x_test.max() > 1.5 else x_test)
              - mean) / std
    if partition == "homo":
        parts = homo_partition(len(y_train), client_num, seed)
    elif partition == "hetero-fix":
        parts = hetero_fix_partition(y_train, client_num, seed)
    else:
        parts = non_iid_partition_with_dirichlet_distribution(
            y_train, client_num, class_num, partition_alpha, seed=seed)
    test_parts = homo_partition(len(y_test), client_num, seed + 1)
    train_local = {i: {"x": x_train[idx], "y": y_train[idx]}
                   for i, idx in parts.items()}
    test_local = {i: {"x": x_test[idx], "y": y_test[idx]}
                  for i, idx in test_parts.items()}
    train_num = {i: len(v["y"]) for i, v in train_local.items()}
    return [len(y_train), len(y_test),
            {"x": x_train, "y": y_train}, {"x": x_test, "y": y_test},
            train_num, train_local, test_local, class_num]


__all__ = ["load_cifar_federated", "normalized_black"]
