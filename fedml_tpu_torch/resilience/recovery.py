"""Round-granular server recovery: kill -9 at round k, resume at round k
(counterpart of ``fedml_tpu/resilience/recovery.py``, over the port's
``utils/checkpoint.py``).

- :class:`RoundRecovery` snapshots *every* completed round (or every
  ``save_every``) and restores the latest on construction of a restarted
  server, counting ``resumes`` for the metrics record.
- The determinism contract: with no faults firing, a server killed after
  round k and restarted on the same directory produces a bitwise-identical
  round-(k+1..n) trajectory, because every input to round k+1 -- params,
  server aux, the run's seed, the host data-RNG bit-generator state and
  the round counter -- is restored exactly, and cohort selection is a
  pure function of the round index (``attempt`` folds in for
  abandoned-round re-runs).

The distributed server FSM (``integration.ResilientFedAvgServer``) holds
numpy weight trees: they are saved as CPU tensors that alias the arrays
(``torch.load(weights_only=True)`` reads tensors, never pickled numpy)
and restored as numpy arrays, bit for bit.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.utils.checkpoint import Checkpointer


def _tensors(tree):
    """numpy leaves -> CPU tensors (zero-copy where the layout allows)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def _arrays(tree):
    """The inverse of :func:`_tensors`: tensor leaves -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_arrays(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


class RoundRecovery:
    """Per-round snapshot/restore for a federated server.

    Args:
      directory: checkpoint root (the port's layout, shared with the
        ``--checkpoint_dir`` flag).
      save_every: snapshot cadence in rounds (1 = every round, the
        resilience default -- a control-plane server's state is a few MB
        of weights, and losing rounds to a crash costs more than the
        write).
      max_to_keep: checkpoints retained.
      warmup_fn: called after a successful restore (the reference's
        warm-restart hook); its report lands in ``last_warmup``.
    """

    def __init__(self, directory: str, save_every: int = 1,
                 max_to_keep: int = 3, warmup_fn=None):
        self._ckpt = Checkpointer(directory, max_to_keep=max_to_keep)
        self.save_every = max(1, int(save_every))
        self.resumes = 0
        self.saves = 0
        self.warmup_fn = warmup_fn
        self.last_warmup = None

    def maybe_save(self, round_idx: int, global_state, server_state=(),
                   rng=None, data_rng=None, last: bool = False) -> bool:
        """Snapshot round ``round_idx`` when on cadence (or ``last``)."""
        if round_idx % self.save_every and not last:
            return False
        self._ckpt.save(round_idx, _tensors(global_state),
                        server_state=_tensors(server_state), rng=rng,
                        data_rng=data_rng)
        self.saves += 1
        return True

    def restore_latest(self, server_state_template=None) -> Optional[dict]:
        """Latest snapshot as ``{"global_state","server_state","rng",
        "data_rng","round_idx"}`` (numpy leaves), or None on a fresh
        directory. Counts a resume only when something was restored."""
        kw = ({} if server_state_template is None
              else {"server_state_template": _tensors(server_state_template)})
        saved = self._ckpt.restore(**kw)
        if saved is None:
            return None
        saved["global_state"] = _arrays(saved["global_state"])
        saved["server_state"] = _arrays(saved["server_state"])
        self.resumes += 1
        logging.info("resilience: resuming from round %d snapshot",
                     saved["round_idx"])
        if self.warmup_fn is not None:
            self.warm_restart()
        return saved

    def warm_restart(self):
        """Run the configured warmup hook now (also called after a
        successful :meth:`restore_latest` when ``warmup_fn`` is set).
        Returns its report, or None without a hook."""
        if self.warmup_fn is None:
            return None
        self.last_warmup = self.warmup_fn()
        return self.last_warmup

    def latest_round(self) -> Optional[int]:
        return self._ckpt.latest_round()

    def close(self):
        """Nothing to release: saves are synchronous file writes."""


__all__ = ["RoundRecovery"]
