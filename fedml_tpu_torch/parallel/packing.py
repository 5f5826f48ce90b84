"""Host-side cohort packing (counterpart of
``fedml_tpu/parallel/packing.py``; byte-equal outputs on either backend).

The host-packed path gathers a round's cohort into dense ``[C, S, B]``
batches (:func:`pack_cohort`). Ragged client shards become
device-resident padded stacks once (:func:`stack_clients`); each round then needs only an index schedule
(:func:`pack_schedule`) re-laid into LPT-balanced lanes
(:func:`pack_lanes`). The bucketed streaming path instead pads each
chunk's schedule to a bucket edge (:func:`parse_bucket_edges`,
:func:`bucket_edge_for`, ``pack_schedule(s_max=)``) and stages the
chunk's batches from the raw shards (:func:`gather_batches`).

Schedules come from one of two backends (:func:`packing_backend`): the
C++ shim (``fedml_tpu_torch/native``) or numpy. They shuffle from
different PRNG families, so the choice is explicit and recorded.
"""

from __future__ import annotations

import math
import os

import numpy as np


def packing_backend(native="auto") -> str:
    """Which schedule generator runs: ``"native"`` (the C++ shim) or
    ``"python"`` (numpy). ``native=True``/``False`` decide; otherwise
    ``FEDML_TPU_PACKING`` (``native`` or ``python``); otherwise native
    iff the shim builds and loads here. The native backend asked for by
    name raises when the shim is unavailable: it never falls back."""
    if native is True:
        return "native"
    if native is False:
        return "python"
    env = os.environ.get("FEDML_TPU_PACKING", "auto").lower()
    if env in ("native", "python"):
        return env
    from fedml_tpu_torch.native import native_available
    return "native" if native_available() else "python"


def _per_epoch_steps(n, batch_size, drop_last=False):
    per_epoch = n // batch_size if drop_last else math.ceil(n / batch_size)
    return max(1, per_epoch)


def _steps_for(n, batch_size, epochs, drop_last=False):
    return _per_epoch_steps(n, batch_size, drop_last) * epochs


def pack_cohort(client_datasets, batch_size, epochs, rng=None,
                drop_last=False, step_bucket=8, return_indices=False,
                native="auto"):
    """A cohort's shards as dense arrays for one round: ``x [C, S, B,
    ...]``, ``y [C, S, B, ...]``, ``mask [C, S, B]`` (float32 0/1) and
    ``n [C]``; with ``return_indices`` also ``idx [C, S, B]`` int32.
    ``S`` is the cohort's most steps rounded up to ``step_bucket``. Draws
    exactly one seed from ``rng`` and shuffles each epoch from a
    generator seeded with it (or hands it to the native shim); a tiny
    client reuses its epoch's data."""
    rng = rng or np.random.default_rng(0)
    C = len(client_datasets)
    if batch_size in (-1, 0):
        batch_size = max(1, max(len(d["y"]) for d in client_datasets))
    steps = [_steps_for(len(d["y"]), batch_size, epochs, drop_last)
             for d in client_datasets]
    S = int(math.ceil(max(steps) / step_bucket) * step_bucket)
    seed = int(rng.integers(0, 2 ** 63 - 1))
    if packing_backend(native) == "native" and not drop_last:
        from fedml_tpu_torch.native import native_pack_cohort
        out = native_pack_cohort(client_datasets, batch_size, epochs, S,
                                 seed)
        if not return_indices:
            out.pop("idx")
        return out
    rng = np.random.default_rng(seed)
    x0 = np.asarray(client_datasets[0]["x"])
    y0 = np.asarray(client_datasets[0]["y"])
    xs = np.zeros((C, S, batch_size) + x0.shape[1:], x0.dtype)
    ys = np.zeros((C, S, batch_size) + y0.shape[1:], y0.dtype)
    mask = np.zeros((C, S, batch_size), np.float32)
    slot_idx = np.zeros((C, S, batch_size), np.int32)
    n = np.zeros((C,), np.float32)
    for c, d in enumerate(client_datasets):
        x, y = np.asarray(d["x"]), np.asarray(d["y"])
        n_c = len(y)
        n[c] = n_c
        s = 0
        for _ in range(epochs):
            order = rng.permutation(n_c)
            for b in range(_per_epoch_steps(n_c, batch_size, drop_last)):
                idx = order[b * batch_size:(b + 1) * batch_size]
                if len(idx) == 0:
                    idx = order[:min(n_c, batch_size)]
                k = len(idx)
                xs[c, s, :k] = x[idx]
                ys[c, s, :k] = y[idx]
                mask[c, s, :k] = 1.0
                slot_idx[c, s, :k] = idx
                s += 1
    out = {"x": xs, "y": ys, "mask": mask, "n": n}
    if return_indices:
        out["idx"] = slot_idx
    return out


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
                  step_bucket=8, native="auto", s_max=None):
    """Per-client epoch schedule as indices: ``{"idx": [C, S, B] int32,
    "mask": [C, S, B] float32, "n": [C] float32}``. Draws exactly one
    seed from ``rng`` and shuffles from a generator seeded with it.
    ``s_max`` forces the step axis to a caller-chosen length (a bucket
    edge); it must cover the cohort's true maximum."""
    rng = rng or np.random.default_rng(0)
    ns = [int(v) for v in ns]
    C = len(ns)
    if batch_size in (-1, 0):
        batch_size = max(1, max(ns))
    true_max = max(_steps_for(n, batch_size, epochs, drop_last) for n in ns)
    S = int(math.ceil(true_max / step_bucket) * step_bucket)
    if s_max is not None:
        if int(s_max) < true_max:
            raise ValueError(f"s_max={s_max} below the cohort's true max "
                             f"step count {true_max}")
        S = int(s_max)
    B = batch_size
    seed = int(rng.integers(0, 2 ** 63 - 1))
    if packing_backend(native) == "native" and not drop_last:
        from fedml_tpu_torch.native import native_pack_schedule
        return native_pack_schedule(ns, B, epochs, S, seed)
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
    steps a round executes). The native backend does the relayout in
    the C++ shim, byte-equal to the loop here."""
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
    if packing_backend(native) == "native":
        from fedml_tpu_torch.native import native_pack_lanes_fill
        members = np.asarray([c for ms in lanes for c in ms], np.int64)
        offsets = np.zeros(K + 1, np.int64)
        np.cumsum([len(ms) for ms in lanes], out=offsets[1:])
        out = native_pack_lanes_fill(idx, mask, ns, steps_pc, members,
                                     offsets, K, L)
        out["trip"] = int(loads.max())
        return out
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


def parse_bucket_edges(spec, s_max):
    """A ``--bucket_edges`` spec as sorted step-count edges: ``None`` /
    ``"geometric"`` / ``"geo"`` / ``"auto"`` for ``[8, 16, 32, ...]``
    covering ``s_max``, or an explicit comma list, extended by doubling
    until it covers ``s_max``."""
    s_max = max(1, int(s_max))
    if spec is None or str(spec).strip().lower() in ("geometric", "geo",
                                                     "auto", ""):
        edges = [8]
        while edges[-1] < s_max:
            edges.append(edges[-1] * 2)
        return edges
    edges = sorted({int(v) for v in str(spec).split(",") if str(v).strip()})
    if not edges or any(e <= 0 for e in edges):
        raise ValueError(f"invalid bucket edge spec {spec!r}")
    while edges[-1] < s_max:
        edges.append(edges[-1] * 2)
    return edges


def bucket_edge_for(steps, edges):
    """The smallest edge covering ``steps`` (vector or scalar); a count
    exactly on an edge lands in that edge's bucket. Raises when a count
    exceeds the top edge."""
    steps = np.asarray(steps, np.int64)
    edge_arr = np.asarray(sorted(int(e) for e in edges), np.int64)
    if steps.size and int(steps.max()) > edge_arr[-1]:
        raise ValueError(
            f"client with {int(steps.max())} steps exceeds the top bucket "
            f"edge {edge_arr[-1]} (size edges from the population max)")
    return edge_arr[np.searchsorted(edge_arr, steps, side="left")]


def gather_batches(datasets, sched, members):
    """A schedule's batches from raw client shards:
    ``xb[c, s, b] = datasets[members[c]]["x"][sched["idx"][c, s, b]]``
    (masked slots gather row 0 of their client)."""
    idx = np.asarray(sched["idx"])
    C, S, B = idx.shape
    x0 = np.asarray(datasets[members[0]]["x"])
    y0 = np.asarray(datasets[members[0]]["y"])
    xb = np.zeros((C, S, B) + x0.shape[1:], x0.dtype)
    yb = np.zeros((C, S, B) + y0.shape[1:], y0.dtype)
    for c, m in enumerate(members):
        d = datasets[m]
        x, y = np.asarray(d["x"]), np.asarray(d["y"])
        if len(y) == 0:
            continue
        xb[c] = x[idx[c]]
        yb[c] = y[idx[c]]
    return xb, yb


def zero_pad_leading(tree, pad):
    """Every leaf's leading (client) axis padded with ``pad`` zero rows
    (numpy arrays or tensors, in a dict or tuple tree): the inert clients,
    ``n`` = 0 and fully masked schedules, that fill a ragged chunk or a
    cohort that does not divide the mesh."""
    if not pad:
        return tree
    if isinstance(tree, dict):
        return {k: zero_pad_leading(v, pad) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(zero_pad_leading(v, pad) for v in tree)
    if hasattr(tree, "new_zeros"):  # a torch tensor
        import torch

        return torch.cat([tree, tree.new_zeros((pad,) + tuple(tree.shape[1:]))])
    a = np.asarray(tree)
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


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


__all__ = ["packing_backend", "pack_cohort", "stack_clients", "pack_schedule", "pack_lanes", "pack_eval",
           "parse_bucket_edges", "bucket_edge_for", "gather_batches",
           "zero_pad_leading"]
