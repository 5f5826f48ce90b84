"""LEAF JSON loaders (counterpart of ``fedml_tpu/data/leaf.py``; the
same arrays for the same files).

A LEAF split is a directory of ``*.json`` files, each holding
``{"users": [...], "num_samples": [...], "user_data": {user: {"x": [...],
"y": [...]}}}``; clients are keyed by user. :func:`load_leaf_mnist`
reads ``<data_dir>/{train,test}`` into the 8-tuple; the MNIST + LR
recipe trains on it.
"""

from __future__ import annotations

import json
import os

import numpy as np


def read_leaf_dir(data_dir):
    """Parse every ``*.json`` under ``data_dir`` (in sorted file order)
    and merge their users: ``(users, {user: {"x", "y"}})``."""
    users, data = [], {}
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(
            f"LEAF data dir not found: {data_dir}. Use a synthetic "
            "dataset when the raw files are absent.")
    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".json"))
    if not files:
        raise FileNotFoundError(f"no .json files in {data_dir}")
    for f in files:
        with open(os.path.join(data_dir, f)) as fh:
            blob = json.load(fh)
        users.extend(blob["users"])
        data.update(blob["user_data"])
    return users, data


def clients_to_eight_tuple(clients):
    """The registry's 8-tuple from per-client ``(x_train, y_train, x_test,
    y_test)`` arrays, clients indexed in the given order; ``class_num`` is
    one more than the largest label seen."""
    train_local, test_local, train_num = {}, {}, {}
    for i, (xt, yt, xe, ye) in enumerate(clients):
        train_local[i] = {"x": xt, "y": yt}
        test_local[i] = {"x": xe, "y": ye}
        train_num[i] = len(yt)
    x_train = np.concatenate([c[0] for c in clients])
    y_train = np.concatenate([c[1] for c in clients])
    x_test = np.concatenate([c[2] for c in clients])
    y_test = np.concatenate([c[3] for c in clients])
    class_num = int(max(y_train.max(), y_test.max() if len(y_test) else 0)) + 1
    return [len(y_train), len(y_test),
            {"x": x_train, "y": y_train}, {"x": x_test, "y": y_test},
            train_num, train_local, test_local, class_num]


def load_leaf_mnist(data_dir, client_num=None, seed=0, x_dtype=np.float32,
                    y_dtype=np.int64):
    """The 8-tuple of LEAF MNIST json under ``data_dir/{train,test}``.
    ``client_num`` keeps the first N users (None: all of them, as the
    reference's ``client_num = len(users)``); a user without test data
    gets an empty test shard. ``seed`` is accepted for the registry's
    signature and unused: the split is the files'."""
    train_users, train_data = read_leaf_dir(os.path.join(data_dir, "train"))
    test_users, test_data = read_leaf_dir(os.path.join(data_dir, "test"))
    users = train_users if client_num is None else train_users[:client_num]

    clients = []
    for u in users:
        xt = np.asarray(train_data[u]["x"], x_dtype)
        yt = np.asarray(train_data[u]["y"], y_dtype)
        if u in test_data:
            xe = np.asarray(test_data[u]["x"], x_dtype)
            ye = np.asarray(test_data[u]["y"], y_dtype)
        else:
            xe, ye = xt[:0], yt[:0]
        clients.append((xt, yt, xe, ye))
    return clients_to_eight_tuple(clients)


__all__ = ["read_leaf_dir", "clients_to_eight_tuple", "load_leaf_mnist"]
