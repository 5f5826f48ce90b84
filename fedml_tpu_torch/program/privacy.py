"""The DP and robust-aggregation legs of a ``RoundProgram`` (counterpart
of ``fedml_tpu/program/privacy.py``; the host legs are bitwise the
reference's on the same inputs).

- :class:`DPPolicy`: client-side differential privacy on the update
  delta, an L2 clip to ``clip_norm`` then Gaussian noise at
  ``noise_multiplier * clip_norm``, drawn from a numpy generator derived
  per ``(rank, round, attempt)``; :meth:`DPPolicy.epsilon` is the
  Gaussian mechanism's accounting.
- :class:`RobustPolicy`: server-side poisoning defenses as variants of
  the canonical sorted-key fp64 fold: ``norm_clip``,
  ``coordinate_median`` and ``trimmed_mean``.

Both legs are host numpy; :meth:`DPPolicy.device_privatize` is the torch
twin (``core/robust.py``). The robust folds take plain dict payloads or
``CompressedUpdate`` reports, reconstructed densely.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: domain-separation salt of the DP noise stream (the reference's value:
#: the draw for (rank, round, attempt) never collides with the codec's
#: encode stream over the same key tuple)
DP_SEED_SALT = 0xD1FF

#: RobustPolicy.mode vocabulary
ROBUST_MODES = ("norm_clip", "coordinate_median", "trimmed_mean")


@dataclass(frozen=True)
class DPPolicy:
    """Client-side (local) DP knobs: ``clip_norm`` (the L2 bound C, the
    mechanism's sensitivity), ``noise_multiplier`` (sigma / C; 0 is
    clip-only, with infinite epsilon) and ``delta`` (the (epsilon,
    delta) failure probability of :meth:`epsilon`)."""

    clip_norm: float = 1.0
    noise_multiplier: float = 0.0
    delta: float = 1e-5

    def __post_init__(self):
        if not self.clip_norm > 0:
            raise ValueError(f"clip_norm must be > 0, got {self.clip_norm}")
        if self.noise_multiplier < 0:
            raise ValueError("noise_multiplier must be >= 0, got "
                             f"{self.noise_multiplier}")
        if not 0 < self.delta < 1:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")

    @property
    def sigma(self) -> float:
        """Noise stddev in update units (``noise_multiplier * clip_norm``)."""
        return float(self.noise_multiplier) * float(self.clip_norm)

    def noise_rng(self, rank, round_idx, attempt=0):
        """The noise stream of one ``(rank, round, attempt)``."""
        return np.random.default_rng(
            (DP_SEED_SALT, int(rank), int(round_idx), int(attempt)))

    def clip(self, delta) -> dict:
        """L2-clip a numpy delta dict to ``clip_norm`` (the norm over
        every leaf in sorted-key order, in fp64): ``delta / max(1,
        ||delta|| / C)``."""
        sq = 0.0
        for k in sorted(delta):
            x = np.asarray(delta[k], np.float64)
            sq += float(np.sum(x * x))
        scale = 1.0 / max(1.0, math.sqrt(sq) / float(self.clip_norm))
        return {k: np.asarray(delta[k], np.float32) * np.float32(scale)
                for k in sorted(delta)}

    def noise(self, delta, rank, round_idx, attempt=0) -> dict:
        """Seeded Gaussian noise at :attr:`sigma` on every leaf, drawn in
        sorted-key order."""
        rng = self.noise_rng(rank, round_idx, attempt)
        out = {}
        for k in sorted(delta):
            x = np.asarray(delta[k], np.float32)
            out[k] = x + np.float32(self.sigma) * rng.standard_normal(
                x.shape, dtype=np.float32)
        return out

    def privatize(self, delta, rank, round_idx, attempt=0) -> dict:
        """Clip, then noise: the noise is calibrated to the clipped
        sensitivity."""
        clipped = self.clip(delta)
        if self.noise_multiplier == 0:
            return clipped
        return self.noise(clipped, rank, round_idx, attempt)

    def privatize_params(self, base, params, rank, round_idx, attempt=0):
        """Client-report form: ``base + privatize(params - base)``."""
        base = {k: np.asarray(v, np.float32) for k, v in base.items()}
        delta = {k: np.asarray(params[k], np.float32) - base[k]
                 for k in sorted(base)}
        priv = self.privatize(delta, rank, round_idx, attempt)
        return {k: base[k] + priv[k] for k in sorted(base)}

    def epsilon(self, rounds=1) -> float:
        """Gaussian-mechanism epsilon at ``delta`` after ``rounds``
        releases: ``sqrt(2 ln(1.25 / delta)) / noise_multiplier`` a
        release, composed linearly; infinite without noise."""
        if self.noise_multiplier <= 0:
            return math.inf
        per_round = (math.sqrt(2.0 * math.log(1.25 / float(self.delta)))
                     / float(self.noise_multiplier))
        return float(rounds) * per_round

    def record(self, rounds_completed) -> dict:
        """The ``dp/*`` fragment of a round record."""
        eps = self.epsilon(rounds_completed)
        return {"dp/clip_norm": float(self.clip_norm),
                "dp/noise_multiplier": float(self.noise_multiplier),
                "dp/delta": float(self.delta),
                "dp/rounds": int(rounds_completed),
                "dp/epsilon": eps if math.isfinite(eps) else -1.0}

    def device_privatize(self, local_state, global_state, rng):
        """The torch twin: clip the local-minus-global delta on the
        device, then add Gaussian noise from the integer seed ``rng``
        (derive it per client and round)."""
        from fedml_tpu_torch.core.robust import (add_gaussian_noise,
                                                 norm_diff_clipping)
        clipped = norm_diff_clipping(local_state, global_state,
                                     self.clip_norm)
        if self.noise_multiplier == 0:
            return clipped
        return add_gaussian_noise(clipped, self.sigma, rng)


def _dense_payload(payload):
    """A report payload as a dense fp64 dict; a ``CompressedUpdate``
    reconstructs ``base + decode(enc)`` (order statistics are not linear,
    so the robust folds densify each report)."""
    from fedml_tpu_torch.compression.wire import CompressedUpdate
    if isinstance(payload, CompressedUpdate):
        dec = payload.compressor().decode(payload.enc)
        return {k: np.asarray(payload.base[k], np.float64)
                + np.asarray(dec[k], np.float64)
                for k in sorted(payload.base)}
    return {k: np.asarray(payload[k], np.float64) for k in sorted(payload)}


@dataclass(frozen=True)
class RobustPolicy:
    """Server-side robust fold: ``norm_clip`` (each report's delta from
    the round base clipped to ``clip_bound``, then the weighted fold),
    ``coordinate_median`` or ``trimmed_mean`` (``floor(trim_ratio * m)``
    values dropped at each end, ``trim_ratio`` in ``[0, 0.5)``)."""

    mode: str = "norm_clip"
    clip_bound: float = 10.0
    trim_ratio: float = 0.1

    def __post_init__(self):
        if self.mode not in ROBUST_MODES:
            raise ValueError(f"robust mode must be one of {ROBUST_MODES}, "
                             f"got {self.mode!r}")
        if not self.clip_bound > 0:
            raise ValueError(f"clip_bound must be > 0, got {self.clip_bound}")
        if not 0 <= self.trim_ratio < 0.5:
            raise ValueError("trim_ratio must be in [0, 0.5), got "
                             f"{self.trim_ratio}")

    def fold_reports(self, reports, base=None) -> tuple:
        """Robust drop-in for ``aggregate_reports`` over ``{rank: (n,
        payload)}``: ``(params_f32, total_n)``, the total always the
        reporters' sample sum; every traversal sorted (ranks, then
        keys)."""
        from fedml_tpu_torch.program.aggregation import fold_entries_fp64
        if not reports:
            raise ValueError("robust fold over an empty reporting subset "
                             "(abandon the round instead)")
        total = float(sum(float(reports[r][0]) for r in sorted(reports)))
        if self.mode == "norm_clip":
            if base is None:
                raise ValueError("norm_clip folds need the round base "
                                 "params (the model the cohort trained on)")
            base64 = {k: np.asarray(base[k], np.float64)
                      for k in sorted(base)}
            entries = []
            for r in sorted(reports):
                n, payload = reports[r]
                clipped = self._clip_to_base(_dense_payload(payload), base64)
                entries.append((r, float(n), clipped, float(n)))
            params, fold_total = fold_entries_fp64(entries)
            if fold_total != total:
                raise AssertionError("fold total differs from the "
                                     "reporters' sum")
            return params, total
        stacked = self._stacked(reports)
        if self.mode == "coordinate_median":
            return ({k: np.median(v, axis=0).astype(np.float32)
                     for k, v in stacked.items()}, total)
        m = len(reports)
        t = int(math.floor(float(self.trim_ratio) * m))
        if 2 * t >= m:  # keep at least one value
            t = (m - 1) // 2
        params = {}
        for k, v in stacked.items():
            v = np.sort(v, axis=0)
            kept = v[t:m - t] if t else v
            params[k] = np.mean(kept, axis=0).astype(np.float32)
        return params, total

    def fold_entries(self, entries) -> tuple:
        """Robust drop-in for ``fold_entries_fp64`` (the buffered
        aggregator's flush); order-statistic modes only, as ``norm_clip``
        needs a round base."""
        if self.mode == "norm_clip":
            raise ValueError("norm_clip is a sync-leg fold (the buffered "
                             "async aggregator has no round base to clip "
                             "against); use coordinate_median or "
                             "trimmed_mean on the async leg")
        entries = sorted(entries, key=lambda e: e[0])
        if not entries:
            raise ValueError("robust fold over an empty entry set")
        reports = {key: (weight, payload)
                   for key, weight, payload, _scale in entries}
        return self.fold_reports(reports)

    def _clip_to_base(self, dense64, base64):
        """``base + delta / max(1, ||delta|| / bound)`` in fp64."""
        delta = {k: dense64[k] - base64[k] for k in sorted(base64)}
        sq = 0.0
        for k in sorted(delta):
            sq += float(np.sum(delta[k] * delta[k]))
        scale = 1.0 / max(1.0, math.sqrt(sq) / float(self.clip_bound))
        return {k: (base64[k] + delta[k] * scale).astype(np.float32)
                for k in sorted(base64)}

    def _stacked(self, reports):
        """``{key: [m, ...] fp64}`` over sorted ranks."""
        ranks = sorted(reports)
        dense = [_dense_payload(reports[r][1]) for r in ranks]
        return {k: np.stack([d[k] for d in dense]) for k in dense[0]}


__all__ = ["DPPolicy", "RobustPolicy", "ROBUST_MODES", "DP_SEED_SALT"]
