"""``RoundProgram``: one federated round as pure data (counterpart of
``fedml_tpu/program/round.py``; ``manifest()`` byte-equal for the same
arguments).

A program bundles the cohort leg (:class:`CohortPolicy`), the
aggregation leg (:class:`AggregationPolicy`) and the codec leg
(:class:`CodecSpec`), plus an opaque ``client_update``. The privacy legs
(``dp``: :class:`DPPolicy`, ``robust``: :class:`RobustPolicy`) are None
when off. The simulation lowers the program to the round runners of
``parallel/engine.py`` (:meth:`RoundProgram.compile_sim`,
:meth:`RoundProgram.compile_bucketed`); a host-side consumer reads it
through :meth:`RoundProgram.host_view`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

from fedml_tpu_torch.program.aggregation import (AggregationPolicy,
                                                 BufferedAggregator,
                                                 aggregate_reports,
                                                 fold_entries_fp64,
                                                 staleness_weight)
from fedml_tpu_torch.program.codec import CodecSpec
from fedml_tpu_torch.program.cohort import (CohortPolicy, client_sampling,
                                            sample_ranks)
from fedml_tpu_torch.program.privacy import DPPolicy, RobustPolicy


@dataclass(frozen=True)
class RoundProgram:
    """One round definition: frozen, comparable, serialisable minus the
    opaque ``client_update``. Evolve it with :meth:`replace`."""

    cohort: CohortPolicy = field(default_factory=CohortPolicy)
    aggregation: AggregationPolicy = field(
        default_factory=AggregationPolicy.sync)
    codec: CodecSpec = field(default_factory=CodecSpec)
    dp: Optional[DPPolicy] = None
    robust: Optional[RobustPolicy] = None
    client_update: Any = field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "codec", CodecSpec.coerce(self.codec))

    @classmethod
    def from_args(cls, args, codec=None,
                  client_update=None) -> "RoundProgram":
        """The program the argument surface describes: resilience knobs
        -> cohort leg, ``--async_agg`` family -> aggregation leg,
        ``--compressor`` (or ``codec``) -> codec leg."""
        cohort = CohortPolicy(
            deadline_s=float(getattr(args, "deadline", 0.0) or 0.0),
            overselect=float(getattr(args, "overselect", 0.0) or 0.0),
            quorum=float(getattr(args, "quorum", 0.5) or 0.5))
        agg = (AggregationPolicy.from_args(args)
               or AggregationPolicy.sync())
        spec = (codec if codec is not None
                else getattr(args, "compressor", None))
        return cls(cohort=cohort, aggregation=agg,
                   codec=CodecSpec.coerce(spec),
                   client_update=client_update)

    @property
    def is_async(self) -> bool:
        return self.aggregation.is_async

    def manifest(self) -> dict:
        """The legs as plain dicts (write with ``sort_keys=True``); the
        privacy legs are null when off."""
        return {
            "cohort": dataclasses.asdict(self.cohort),
            "aggregation": dataclasses.asdict(self.aggregation),
            "codec": {"spec": self.codec.spec,
                      "enabled": self.codec.enabled},
            "dp": (dataclasses.asdict(self.dp)
                   if self.dp is not None else None),
            "robust": (dataclasses.asdict(self.robust)
                       if self.robust is not None else None),
        }

    @classmethod
    def from_manifest(cls, data: dict) -> "RoundProgram":
        """Inverse of :meth:`manifest`; unknown keys are rejected by the
        leg constructors."""
        dp, robust = data.get("dp"), data.get("robust")
        return cls(
            cohort=CohortPolicy(**data.get("cohort", {})),
            aggregation=AggregationPolicy(**data.get("aggregation", {})),
            codec=CodecSpec(spec=data.get("codec", {}).get("spec",
                                                           "none")),
            dp=DPPolicy(**dp) if dp else None,
            robust=RobustPolicy(**robust) if robust else None)

    def replace(self, **changes) -> "RoundProgram":
        return dataclasses.replace(self, **changes)

    def host_view(self) -> "HostProgram":
        """The host-side facade over this program."""
        return HostProgram(self)

    def compile_sim(self, spec, cfg, payload_fn=None, server_fn=None,
                    mesh=None, compressed=None, compressor=None):
        """This program lowered to the host-packed round function
        (:func:`fedml_tpu_torch.program.sim.compile_sim`)."""
        from fedml_tpu_torch.program.sim import compile_sim
        return compile_sim(self, spec, cfg, payload_fn=payload_fn,
                           server_fn=server_fn, mesh=mesh,
                           compressed=compressed, compressor=compressor)

    def compile_bucketed(self, spec, cfg, payload_fn=None, server_fn=None,
                         compressor=None, **kwargs):
        """This program lowered to the bucketed streaming runner
        (:func:`fedml_tpu_torch.program.sim.compile_bucketed`)."""
        from fedml_tpu_torch.program.sim import compile_bucketed
        return compile_bucketed(self, spec, cfg, payload_fn=payload_fn,
                                server_fn=server_fn,
                                compressor=compressor, **kwargs)


class HostProgram:
    """Host view of one :class:`RoundProgram`: cohort draws, counts, the
    folds, the codec and the privacy legs, each a delegation into a
    leg."""

    def __init__(self, program: RoundProgram):
        self.program = program

    @property
    def cohort(self) -> CohortPolicy:
        return self.program.cohort

    def sample_cohort(self, round_idx, total, per_round, attempt=0):
        """Seeded client-index cohort (the simulation's draw)."""
        return client_sampling(round_idx, total, per_round, attempt)

    def sample_ranks(self, round_idx, attempt, ranks, k):
        """Seeded transport-rank cohort (a distributed server's draw)."""
        return sample_ranks(round_idx, attempt, ranks, k)

    def select_count(self, target, available=None) -> int:
        return self.program.cohort.select_count(target, available)

    def quorum_count(self, target) -> int:
        return self.program.cohort.quorum_count(target)

    @property
    def aggregation(self) -> AggregationPolicy:
        return self.program.aggregation

    def fold_reports(self, reports, base=None) -> tuple:
        """Sync partial aggregation over the reporting subset; with the
        robust leg armed, the leg's fold (``norm_clip`` needs ``base``,
        the round's broadcast params)."""
        if self.program.robust is not None:
            return self.program.robust.fold_reports(reports, base=base)
        return aggregate_reports(reports)

    def fold_entries(self, entries) -> tuple:
        return fold_entries_fp64(entries)

    def staleness_weight(self, staleness) -> float:
        return staleness_weight(staleness,
                                self.program.aggregation.staleness_decay)

    def make_aggregator(self, policy=None) -> BufferedAggregator:
        """The program's buffered aggregator, its flush fold the robust
        leg's when armed."""
        robust = self.program.robust
        return BufferedAggregator(
            policy or self.program.aggregation,
            fold_fn=robust.fold_entries if robust is not None else None)

    @property
    def codec(self) -> CodecSpec:
        return self.program.codec

    def host_codec(self):
        """The numpy wire twin of the program's spec (None when the codec
        leg is disabled)."""
        return self.program.codec.host()

    @property
    def dp(self) -> Optional[DPPolicy]:
        return self.program.dp

    @property
    def robust(self) -> Optional[RobustPolicy]:
        return self.program.robust

    def privatize_update(self, base, params, rank, round_idx, attempt=0):
        """Client-side DP: ``base + noise(clip(params - base))`` under the
        per-(rank, round, attempt) stream; the identity when the DP leg
        is off."""
        if self.program.dp is None:
            return params
        return self.program.dp.privatize_params(base, params, rank,
                                                round_idx, attempt)


__all__ = ["RoundProgram", "HostProgram"]
