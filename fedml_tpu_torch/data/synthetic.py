"""Synthetic image-shaped federated dataset (counterpart of
``fedml_tpu/data/synthetic.py`` ``load_synthetic_images``; byte-equal for
the same seed). Host numpy: the data is uploaded to the device once by
the FedAvg API."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.core.partition import (
    homo_partition, non_iid_partition_with_dirichlet_distribution)


def _eight_tuple(train_parts, test_parts, x_train, y_train, x_test, y_test,
                 class_num):
    train_local = {i: {"x": x_train[idx], "y": y_train[idx]}
                   for i, idx in train_parts.items()}
    test_local = {i: {"x": x_test[idx], "y": y_test[idx]}
                  for i, idx in test_parts.items()}
    train_num_dict = {i: len(v["y"]) for i, v in train_local.items()}
    return [len(y_train), len(y_test),
            {"x": x_train, "y": y_train}, {"x": x_test, "y": y_test},
            train_num_dict, train_local, test_local, class_num]


def load_synthetic_images(client_num=10, n_train=2000, n_test=400,
                          image_size=32, channels=3, class_num=10,
                          partition_alpha=0.5, partition="hetero", seed=0):
    """CIFAR-shaped (NHWC) class-dependent coloured blobs in the 8-tuple
    dataset contract; ``partition="hetero"`` is the LDA split."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    y = rng.integers(0, class_num, n).astype(np.int64)
    base = rng.normal(0, 1, (class_num, image_size, image_size, channels))
    x = (base[y] * 0.5
         + rng.normal(0, 1, (n, image_size, image_size, channels))
         ).astype(np.float32)
    x_train, y_train = x[:n_train], y[:n_train]
    x_test, y_test = x[n_train:], y[n_train:]
    if partition == "homo":
        train_parts = homo_partition(n_train, client_num, seed)
    else:
        train_parts = non_iid_partition_with_dirichlet_distribution(
            y_train, client_num, class_num, partition_alpha, seed=seed)
    test_parts = homo_partition(n_test, client_num, seed + 1)
    return _eight_tuple(train_parts, test_parts, x_train, y_train,
                        x_test, y_test, class_num)


__all__ = ["load_synthetic_images"]
