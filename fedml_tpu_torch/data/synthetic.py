"""Synthetic federated datasets (counterpart of
``fedml_tpu/data/synthetic.py``; byte-equal for the same seed): the LEAF
synthetic(alpha, beta) logistic-regression task, CIFAR-shaped images and
next-token sequences. Host numpy: the FedAvg API uploads the data."""

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


def load_synthetic_federated(client_num=10, n_train=2000, n_test=400,
                             feature_dim=60, class_num=10, alpha=0.0,
                             beta=0.0, partition_alpha=0.5,
                             partition="natural", seed=0):
    """LEAF synthetic(alpha, beta): client k draws softmax weights ``W_k ~
    N(u_k, 1), u_k ~ N(0, alpha)`` and feature means ``v_k ~ N(B_k, 1),
    B_k ~ N(0, beta)``. ``partition="natural"`` keeps each client's
    generation as its shard; ``"homo"`` and ``"hetero"`` (LDA)
    re-partition the pooled data."""
    rng = np.random.default_rng(seed)
    per_client_train = np.full(client_num, n_train // client_num)
    per_client_train[:n_train % client_num] += 1
    per_client_test = np.full(client_num, n_test // client_num)
    per_client_test[:n_test % client_num] += 1
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    slices_tr, slices_te = [], []
    off_tr = off_te = 0
    for k in range(client_num):
        u_k = rng.normal(0, max(alpha, 1e-12))
        B_k = rng.normal(0, max(beta, 1e-12))
        W_k = rng.normal(u_k, 1.0, (feature_dim, class_num))
        b_k = rng.normal(u_k, 1.0, (class_num,))
        mean_k = rng.normal(B_k, 1.0, (feature_dim,))
        n_k = per_client_train[k] + per_client_test[k]
        x_k = rng.normal(mean_k, 1.0, (n_k, feature_dim)).astype(np.float32)
        logits = x_k @ W_k + b_k
        y_k = np.argmax(logits + rng.gumbel(size=logits.shape),
                        axis=1).astype(np.int64)
        nt = per_client_train[k]
        xs_tr.append(x_k[:nt])
        ys_tr.append(y_k[:nt])
        xs_te.append(x_k[nt:])
        ys_te.append(y_k[nt:])
        slices_tr.append(np.arange(off_tr, off_tr + nt))
        slices_te.append(np.arange(off_te, off_te + (n_k - nt)))
        off_tr += nt
        off_te += n_k - nt
    x_train, y_train = np.concatenate(xs_tr), np.concatenate(ys_tr)
    x_test, y_test = np.concatenate(xs_te), np.concatenate(ys_te)
    if partition == "natural":
        train_parts = dict(enumerate(slices_tr))
        test_parts = dict(enumerate(slices_te))
    elif partition == "homo":
        train_parts = homo_partition(n_train, client_num, seed)
        test_parts = homo_partition(n_test, client_num, seed + 1)
    else:
        train_parts = non_iid_partition_with_dirichlet_distribution(
            y_train, client_num, class_num, partition_alpha, seed=seed)
        test_parts = homo_partition(n_test, client_num, seed + 1)
    return _eight_tuple(train_parts, test_parts, x_train, y_train,
                        x_test, y_test, class_num)


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


def load_synthetic_sequences(client_num=10, n_train=1000, n_test=200,
                             seq_len=20, vocab_size=90, partition="homo",
                             seed=0):
    """Next-token synthetic text: inputs ``[n, seq_len]`` int32 ids in
    ``[1, vocab)``, labels ``(x * 7 + 3) % vocab`` (a learnable cipher);
    IID shards."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    x = rng.integers(1, vocab_size, (n, seq_len)).astype(np.int32)
    y = ((x * 7 + 3) % vocab_size).astype(np.int64)
    x_train, y_train = x[:n_train], y[:n_train]
    x_test, y_test = x[n_train:], y[n_train:]
    train_parts = homo_partition(n_train, client_num, seed)
    test_parts = homo_partition(n_test, client_num, seed + 1)
    return _eight_tuple(train_parts, test_parts, x_train, y_train,
                        x_test, y_test, vocab_size)


__all__ = ["load_synthetic_federated", "load_synthetic_images",
           "load_synthetic_sequences"]
