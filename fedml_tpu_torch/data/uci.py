"""Streaming UCI datasets, SUSY and Room Occupancy, for decentralized
online learning (counterpart of ``fedml_tpu/data/uci.py``; the same
streams for the same file and seed).

A time-ordered stream is split across clients in two regimes: a
``beta`` fraction assigned adversarially (the k-means cluster of a
sample picks its client, so each client sees a skewed slice of feature
space) and the rest stochastically (sequential fill to each client's
quota). Each client gets arrays; :func:`as_sample_list` gives the
reference's list of per-sample dicts.
"""

from __future__ import annotations

import os

import numpy as np


def _read_susy(path, limit=None):
    """SUSY.csv: the label in column 0, 18 float features after it."""
    rows = np.loadtxt(path, delimiter=",", max_rows=limit)
    return rows[:, 1:].astype(np.float32), rows[:, 0].astype(np.float32)


def _read_room_occupancy(path, limit=None):
    """datatraining.txt: a header line, then id, date, 5 features and
    Occupancy."""
    xs, ys = [], []
    with open(path) as f:
        next(f)
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                break
            parts = line.strip().replace('"', "").split(",")
            xs.append([float(v) for v in parts[2:-1]])
            ys.append(float(parts[-1]))
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def _kmeans_assign(x, k, seed=0, iters=20):
    """Lloyd's k-means on the host: the cluster id of each row."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=k, replace=False)]
    assign = np.zeros(len(x), np.int64)
    for _ in range(iters):
        d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        new_assign = d2.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            pts = x[assign == c]
            if len(pts):
                centers[c] = pts.mean(0)
    return assign


def load_streaming_uci(data_name, data_path, client_num,
                       sample_num_in_total, beta=0.0, seed=0):
    """Per-client streams ``{client: {"x": [T_i, d], "y": [T_i]}}`` from
    a UCI file (SUSY when ``data_name`` says so, else Room Occupancy),
    the first ``sample_num_in_total`` rows split by :func:`split_stream`
    in stream order."""
    if not os.path.exists(data_path):
        raise FileNotFoundError(
            f"{data_name} raw file not found at {data_path}; see `python -m "
            "fedml_tpu_torch.data.prepare layout susy` or use "
            "load_synthetic_stream()")
    reader = _read_susy if "susy" in data_name.lower() else _read_room_occupancy
    x, y = reader(data_path, limit=sample_num_in_total)
    x, y = x[:sample_num_in_total], y[:sample_num_in_total]
    return split_stream(x, y, client_num, beta=beta, seed=seed)


def split_stream(x, y, client_num, beta=0.0, seed=0):
    """The two-regime split over in-memory arrays: the first ``beta``
    fraction by k-means cluster, the rest filling each client to
    ``len(y) // client_num`` in order."""
    total = len(y)
    quota = total // client_num
    parts = {c: [] for c in range(client_num)}

    n_adv = int(beta * total)
    if n_adv > 0:
        assign = _kmeans_assign(x[:n_adv], client_num, seed=seed)
        for i in range(n_adv):
            parts[int(assign[i])].append(i)
    client = 0
    for i in range(n_adv, total):
        while client < client_num and len(parts[client]) >= quota:
            client += 1
        if client == client_num:
            break
        parts[client].append(i)

    return {c: {"x": x[idx] if idx else x[:0], "y": y[idx] if idx else y[:0]}
            for c, idx in ((c, parts[c]) for c in range(client_num))}


def load_synthetic_stream(client_num=8, T=200, d=18, drift=0.0, seed=0):
    """A linearly separable SUSY-shaped stream; ``drift`` rotates the
    decision boundary over time."""
    rng = np.random.default_rng(seed)
    n = client_num * T
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    if drift:
        t = np.linspace(0, drift, n)
        w_t = w[None, :] + t[:, None] * rng.normal(size=d)
        logits = (x * w_t).sum(1)
    else:
        logits = x @ w
    y = (logits > 0).astype(np.float32)
    return split_stream(x, y, client_num, beta=0.0, seed=seed)


def as_sample_list(stream_dict):
    """``{client: [{"x": .., "y": ..}, ...]}``, the reference's shape."""
    return {c: [{"x": d["x"][t], "y": d["y"][t]} for t in range(len(d["y"]))]
            for c, d in stream_dict.items()}


__all__ = ["load_streaming_uci", "split_stream", "load_synthetic_stream",
           "as_sample_list"]
