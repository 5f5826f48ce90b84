"""Checkpoint and resume of the round loop (counterpart of
``fedml_tpu/utils/checkpoint.py``), through ``torch.save``.

A checkpoint holds the whole round-loop state: the global model, the
server optimizer state, the round index, the run's seed and the host's
batch-shuffle generator (its ``bit_generator.state``, as JSON), so a
killed run continues bit-exactly. The resolved packing backend rides
along too: the native and numpy backends shuffle from different PRNG
families, and a resume on a machine that resolves the other one warns. The reference's Saver extras come
along: the best metric across checkpoints (``best_pred.txt``) and the
config snapshot (``parameters.json``).

Each round is one file, ``round_<idx>.pt``, written to a temporary name
and renamed into place, and read back with ``torch.load(weights_only=
True)``: tensors and plain containers only, so a tampered directory
cannot run code at restore time. The format is the port's own; the JAX
package's orbax checkpoints cannot read it, nor it theirs.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Optional

import numpy as np
import torch

_NO_TEMPLATE = object()  # sentinel: "caller supplied no template"
_FILE = re.compile(r"^round_(\d+)\.pt$")


def _to_cpu(tree):
    """Tensors copied to the CPU; containers and scalars as they are."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _structure(tree):
    """The tree's containers and keys, leaves marked by kind."""
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_structure(v) for v in tree])
    return "leaf" if isinstance(tree, torch.Tensor) else repr(type(tree))


class Checkpointer:
    """Round checkpoints in one directory, with the reference's retention
    and best-metric tracking."""

    def __init__(self, directory, max_to_keep=3,
                 best_mode: Optional[str] = None):
        """Args:
          directory: checkpoint root (created if absent).
          max_to_keep: checkpoints retained.
          best_mode: None keeps the most recent ``max_to_keep``;
            ``"max"``/``"min"`` keeps the best by the ``metric`` passed to
            :meth:`save` (checkpoints saved without one are kept).
        """
        if best_mode not in (None, "max", "min"):
            raise ValueError(f"best_mode {best_mode!r}: None, 'max' or 'min'")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.best_mode = best_mode
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, round_idx):
        return os.path.join(self.directory, f"round_{int(round_idx)}.pt")

    def _rounds(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _FILE.match(f)))

    def _load(self, round_idx, device="cpu"):
        return torch.load(self._path(round_idx), map_location=device,
                          weights_only=True)

    def save(self, round_idx: int, global_state, server_state=(),
             rng=None, metric: Optional[float] = None,
             data_rng=None) -> bool:
        """Checkpoint one round; returns True if the checkpoint was kept.

        ``rng`` is the run's seed (an int or a tensor; the port derives
        every round's draws from it and the round index), ``data_rng`` the
        host's ``np.random.Generator`` of batch shuffles, whose
        bit-generator state rides along so resume restores the data stream
        with no cohort replay; the resolved packing backend is saved
        beside it."""
        from fedml_tpu_torch.parallel.packing import packing_backend
        payload = {
            "global_state": _to_cpu(global_state),
            "server_state": _to_cpu(server_state),
            "rng": None if rng is None else torch.as_tensor(rng).cpu(),
            "round_idx": int(round_idx),
            "metric": None if metric is None else float(metric),
            "data_rng_state": json.dumps(
                data_rng.bit_generator.state if data_rng is not None
                else None, sort_keys=True),
            "packing_backend": packing_backend(),
        }
        path = self._path(round_idx)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        if metric is not None:
            self._update_best(round_idx, metric)
        self._prune()
        return os.path.exists(path)

    def _metrics(self):
        return {r: self._load(r)["metric"] for r in self._rounds()}

    def _prune(self):
        rounds = self._rounds()
        if self.best_mode is None:
            drop = rounds[:max(0, len(rounds) - self.max_to_keep)]
        else:
            scored = [(m, r) for r, m in self._metrics().items()
                      if m is not None]
            scored.sort(reverse=self.best_mode == "max")
            drop = [r for _, r in scored[self.max_to_keep:]]
        for r in drop:
            os.remove(self._path(r))

    def restore(self, round_idx: Optional[int] = None,
                server_state_template=_NO_TEMPLATE,
                device="cpu") -> Optional[dict]:
        """Restore a round (the latest if None): ``{"global_state",
        "server_state", "rng", "round_idx", "data_rng",
        "packing_backend"}`` with the states' tensors on ``device``, or
        None when the directory holds no checkpoint (a fresh start).
        ``server_state_template``, when given, must have the saved server
        state's structure (containers, keys, leaf kinds). A checkpoint
        written under another packing backend than this machine resolves
        logs a warning: the batch shuffles differ after the resume."""
        if round_idx is None:
            round_idx = self.latest_round()
            if round_idx is None:
                return None
        payload = self._load(round_idx, device)
        server_state = payload["server_state"]
        if (server_state_template is not _NO_TEMPLATE
                and _structure(server_state_template)
                != _structure(server_state)):
            raise ValueError("server_state_template structure does not "
                             "match the checkpointed server state")
        rng_state = json.loads(payload["data_rng_state"])
        data_rng = None
        if rng_state is not None:
            data_rng = np.random.default_rng()
            data_rng.bit_generator.state = rng_state
        from fedml_tpu_torch.parallel.packing import packing_backend
        saved_backend = payload.get("packing_backend")
        if saved_backend is not None and saved_backend != packing_backend():
            logging.warning(
                "checkpoint was written with packing_backend=%s but this "
                "machine resolves %s: batch shuffles will differ after "
                "resume (set FEDML_TPU_PACKING=%s to match)",
                saved_backend, packing_backend(), saved_backend)
        return {"global_state": payload["global_state"],
                "server_state": server_state,
                "rng": payload["rng"],
                "round_idx": int(payload["round_idx"]),
                "data_rng": data_rng,
                "packing_backend": saved_backend}

    def latest_round(self) -> Optional[int]:
        rounds = self._rounds()
        return rounds[-1] if rounds else None

    def best_round(self) -> Optional[int]:
        """The kept round with the best metric; the latest without
        ``best_mode``."""
        if self.best_mode is None:
            return self.latest_round()
        scored = [(m, r) for r, m in self._metrics().items()
                  if m is not None]
        if not scored:
            return None
        pick = max if self.best_mode == "max" else min
        return pick(scored)[1]

    def save_config(self, args) -> None:
        """Config snapshot (the Saver's ``parameters.txt``) as JSON, with
        the same codec as the metrics sink's ``config.json``."""
        from fedml_tpu_torch.utils.metrics import _jsonable
        d = vars(args) if hasattr(args, "__dict__") else dict(args)
        with open(os.path.join(self.directory, "parameters.json"), "w") as f:
            json.dump(_jsonable(d), f, indent=2, sort_keys=True)

    def _update_best(self, round_idx, metric):
        """``best_pred.txt``: the best metric across checkpoints."""
        path = os.path.join(self.directory, "best_pred.txt")
        best = None
        if os.path.exists(path):
            with open(path) as f:
                best = json.loads(f.read())
        better = ((metric < best["metric"] if self.best_mode == "min"
                   else metric > best["metric"]) if best is not None
                  else True)
        if better:
            with open(path, "w") as f:
                f.write(json.dumps({"metric": float(metric),
                                    "round": int(round_idx)},
                                   sort_keys=True))


__all__ = ["Checkpointer"]
