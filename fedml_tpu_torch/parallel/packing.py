"""Host-side cohort packing (counterpart of
``fedml_tpu/parallel/packing.py``, numpy backend; byte-equal outputs).

Ragged client shards become device-resident padded stacks once
(:func:`stack_clients`); each round then needs only an index schedule
(:func:`pack_schedule`) re-laid into LPT-balanced lanes
(:func:`pack_lanes`). The reference's C++ backend is not ported yet
(ROADMAP A2).
"""

from __future__ import annotations

import math

import numpy as np


def _per_epoch_steps(n, batch_size, drop_last=False):
    per_epoch = n // batch_size if drop_last else math.ceil(n / batch_size)
    return max(1, per_epoch)


def _steps_for(n, batch_size, epochs, drop_last=False):
    return _per_epoch_steps(n, batch_size, drop_last) * epochs


def _numpy_only(native):
    if native is True:
        raise NotImplementedError(
            "the native packing backend waits for ROADMAP A2")


def stack_clients(client_datasets, n_max=None):
    """Pad-and-stack client shards: ``{"x": [C, n_max, ...], "y": [C,
    n_max, ...], "n": [C]}``; padding rows are zeros and never addressed
    by a valid schedule slot."""
    C = len(client_datasets)
    if n_max is None:
        n_max = max(1, max(len(d["y"]) for d in client_datasets))
    x0 = np.asarray(client_datasets[0]["x"])
    y0 = np.asarray(client_datasets[0]["y"])
    xs = np.zeros((C, n_max) + x0.shape[1:], x0.dtype)
    ys = np.zeros((C, n_max) + y0.shape[1:], y0.dtype)
    n = np.zeros((C,), np.float32)
    for c, d in enumerate(client_datasets):
        k = len(d["y"])
        n[c] = k
        xs[c, :k] = np.asarray(d["x"])
        ys[c, :k] = np.asarray(d["y"])
    return {"x": xs, "y": ys, "n": n}


def pack_schedule(ns, batch_size, epochs, rng=None, drop_last=False,
                  step_bucket=8, native="auto"):
    """Per-client epoch schedule as indices: ``{"idx": [C, S, B] int32,
    "mask": [C, S, B] float32, "n": [C] float32}``. Draws exactly one
    seed from ``rng`` and shuffles from a generator seeded with it."""
    _numpy_only(native)
    rng = rng or np.random.default_rng(0)
    ns = [int(v) for v in ns]
    C = len(ns)
    if batch_size in (-1, 0):
        batch_size = max(1, max(ns))
    true_max = max(_steps_for(n, batch_size, epochs, drop_last) for n in ns)
    S = int(math.ceil(true_max / step_bucket) * step_bucket)
    B = batch_size
    seed = int(rng.integers(0, 2 ** 63 - 1))
    rng = np.random.default_rng(seed)
    idx = np.zeros((C, S, B), np.int32)
    mask = np.zeros((C, S, B), np.float32)
    for c, n_c in enumerate(ns):
        if n_c == 0:
            continue
        s = 0
        for _ in range(epochs):
            order = rng.permutation(n_c)
            for b in range(_per_epoch_steps(n_c, B, drop_last)):
                sel = order[b * B:(b + 1) * B]
                if len(sel) == 0:
                    sel = order[:min(n_c, B)]
                idx[c, s, :len(sel)] = sel
                mask[c, s, :len(sel)] = 1.0
                s += 1
    return {"idx": idx, "mask": mask, "n": np.asarray(ns, np.float32)}


def pack_lanes(sched, n_lanes, step_bucket=8, native="auto"):
    """Re-lay a ``pack_schedule`` output into ``n_lanes`` packed lanes:
    clients assigned longest-first onto the lightest lane, each lane's
    clients back to back. Returns lane-major numpy arrays ``idx/mask [K,
    T, B]``, ``slot``, ``local_step``, ``flush``, ``flush_n``,
    ``flush_steps`` ``[K, T]`` and ``trip`` (the max lane load, the
    steps a round executes)."""
    _numpy_only(native)
    idx, mask = np.asarray(sched["idx"]), np.asarray(sched["mask"])
    ns = np.asarray(sched["n"], np.float32)
    C, S, B = idx.shape
    steps_pc = (mask.sum(axis=2) > 0).sum(axis=1).astype(np.int64)
    order = np.argsort(-steps_pc, kind="stable")
    K = max(1, min(int(n_lanes), C))
    loads = np.zeros(K, np.int64)
    lanes = [[] for _ in range(K)]
    for c in order:
        k = int(np.argmin(loads))
        lanes[k].append(int(c))
        loads[k] += int(steps_pc[c])
    L = int(loads.max())
    L = int(math.ceil(max(L, 1) / step_bucket) * step_bucket)
    out_idx = np.zeros((K, L, B), np.int32)
    out_mask = np.zeros((K, L, B), np.float32)
    slot = np.zeros((K, L), np.int32)
    local_step = np.zeros((K, L), np.int32)
    flush = np.zeros((K, L), np.float32)
    flush_n = np.zeros((K, L), np.float32)
    flush_steps = np.zeros((K, L), np.float32)
    for k, members in enumerate(lanes):
        pos = 0
        for c in members:
            s_c = int(steps_pc[c])
            if s_c == 0:
                continue
            sl = slice(pos, pos + s_c)
            out_idx[k, sl] = idx[c, :s_c]
            out_mask[k, sl] = mask[c, :s_c]
            slot[k, sl] = c
            local_step[k, sl] = np.arange(s_c)
            flush[k, pos + s_c - 1] = 1.0
            flush_n[k, pos + s_c - 1] = ns[c]
            flush_steps[k, pos + s_c - 1] = s_c
            pos += s_c
    return {"idx": out_idx, "mask": out_mask, "slot": slot,
            "local_step": local_step, "flush": flush, "flush_n": flush_n,
            "flush_steps": flush_steps, "trip": int(loads.max())}


def pack_eval(data, batch_size):
    """Pack a flat eval set into ``[S, B]`` masked batches."""
    x, y = np.asarray(data["x"]), np.asarray(data["y"])
    n = len(y)
    if batch_size in (-1, 0):
        batch_size = max(1, n)
    S = max(1, math.ceil(n / batch_size))
    xs = np.zeros((S, batch_size) + x.shape[1:], x.dtype)
    ys = np.zeros((S, batch_size) + y.shape[1:], y.dtype)
    mask = np.zeros((S, batch_size), np.float32)
    for s in range(math.ceil(n / batch_size)):
        idx = np.arange(s * batch_size, min((s + 1) * batch_size, n))
        xs[s, :len(idx)] = x[idx]
        ys[s, :len(idx)] = y[idx]
        mask[s, :len(idx)] = 1.0
    return {"x": xs, "y": ys, "mask": mask}


__all__ = ["stack_clients", "pack_schedule", "pack_lanes", "pack_eval"]
