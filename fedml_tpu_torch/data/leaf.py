"""LEAF JSON reader (counterpart of ``fedml_tpu/data/leaf.py``'s
``read_leaf_dir``; the LEAF MNIST loader waits for ROADMAP A14).

A LEAF split is a directory of ``*.json`` files, each holding
``{"users": [...], "num_samples": [...], "user_data": {user: {"x": [...],
"y": [...]}}}``; clients are keyed by user.
"""

from __future__ import annotations

import json
import os


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


__all__ = ["read_leaf_dir"]
