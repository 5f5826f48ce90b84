"""Backdoor poisoning of a federated dataset (counterpart of
``fedml_tpu/data/poison.py``; byte-equal on the same inputs): a trigger
pattern stamped onto a fraction of an adversary's samples whose labels
flip to the attack target, and an all-triggered test set for the attack
success rate. Host numpy."""

from __future__ import annotations

import numpy as np


def stamp_trigger(x, pattern="corner", intensity=3.0):
    """The trigger on image batch ``x [N, H, W, C]`` (a copy)."""
    x = np.array(x, copy=True)
    if pattern == "corner":
        x[:, -4:, -4:, :] = intensity
    elif pattern == "cross":
        h, w = x.shape[1] // 2, x.shape[2] // 2
        x[:, h - 1:h + 2, :, :] = intensity
        x[:, :, w - 1:w + 2, :] = intensity
    else:
        raise ValueError(f"unknown trigger pattern: {pattern}")
    return x


def poison_client_data(data, poison_frac, target_label, pattern="corner",
                       seed=0):
    """A fraction of one client's shard triggered and relabelled."""
    rng = np.random.default_rng(seed)
    n = len(data["y"])
    k = int(n * poison_frac)
    if k == 0:
        return data
    idx = rng.choice(n, k, replace=False)
    x = np.array(data["x"], copy=True)
    y = np.array(data["y"], copy=True)
    x[idx] = stamp_trigger(x[idx], pattern)
    y[idx] = target_label
    return {"x": x, "y": y}


def make_backdoor_testset(test_data, target_label, pattern="corner"):
    """The test set without the target class, every sample triggered and
    labelled with the target."""
    keep = np.asarray(test_data["y"]) != target_label
    x = stamp_trigger(np.asarray(test_data["x"])[keep], pattern)
    y = np.full(int(keep.sum()), target_label,
                dtype=np.asarray(test_data["y"]).dtype)
    return {"x": x, "y": y}


def poison_federated_dataset(dataset, adversary_clients, poison_frac,
                             target_label, pattern="corner", seed=0):
    """The 8-tuple dataset with the adversaries' shards poisoned (a copy;
    client ``c`` draws from ``seed + c``): ``(dataset, poisoned_test)``."""
    ds = list(dataset)
    train_local = dict(ds[5])
    for c in adversary_clients:
        train_local[c] = poison_client_data(
            train_local[c], poison_frac, target_label, pattern, seed + c)
    ds[5] = train_local
    poisoned_test = make_backdoor_testset(ds[3], target_label, pattern)
    return ds, poisoned_test


__all__ = ["stamp_trigger", "poison_client_data", "make_backdoor_testset",
           "poison_federated_dataset"]
