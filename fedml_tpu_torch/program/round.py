"""``RoundProgram``: one federated round as pure data (counterpart of
``fedml_tpu/program/round.py``; ``manifest()`` byte-equal for the same
arguments).

A program bundles the cohort leg (:class:`CohortPolicy`), the
aggregation leg (:class:`AggregationPolicy`) and the codec leg
(:class:`CodecSpec`), plus an opaque ``client_update``. The simulation
lowers it to the round runners of ``parallel/engine.py``
(:meth:`RoundProgram.compile_sim`, :meth:`RoundProgram.compile_bucketed`);
a host-side consumer reads it through :meth:`RoundProgram.host_view`.
The privacy legs (``dp``, ``robust``) wait for ROADMAP A11: setting one
raises.
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

_PRIVACY = "ROADMAP A11 (program/privacy.py DPPolicy and RobustPolicy)"


@dataclass(frozen=True)
class RoundProgram:
    """One round definition: frozen, comparable, serialisable minus the
    opaque ``client_update``. Evolve it with :meth:`replace`."""

    cohort: CohortPolicy = field(default_factory=CohortPolicy)
    aggregation: AggregationPolicy = field(
        default_factory=AggregationPolicy.sync)
    codec: CodecSpec = field(default_factory=CodecSpec)
    dp: Optional[Any] = None
    robust: Optional[Any] = None
    client_update: Any = field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "codec", CodecSpec.coerce(self.codec))
        for leg in ("dp", "robust"):
            if getattr(self, leg) is not None:
                raise NotImplementedError(
                    f"the {leg} leg waits for {_PRIVACY}")

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
            "dp": None,
            "robust": None,
        }

    @classmethod
    def from_manifest(cls, data: dict) -> "RoundProgram":
        """Inverse of :meth:`manifest`; unknown keys are rejected by the
        leg constructors."""
        for leg in ("dp", "robust"):
            if data.get(leg):
                raise NotImplementedError(
                    f"the {leg} leg waits for {_PRIVACY}")
        return cls(
            cohort=CohortPolicy(**data.get("cohort", {})),
            aggregation=AggregationPolicy(**data.get("aggregation", {})),
            codec=CodecSpec(spec=data.get("codec", {}).get("spec",
                                                           "none")))

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
    """Host view of one :class:`RoundProgram`: cohort draws, counts and
    the canonical folds, each a delegation into a leg (the reference's
    codec and privacy accessors wait for ROADMAP A11 and A12)."""

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
        """Sync partial aggregation over the reporting subset."""
        return aggregate_reports(reports)

    def fold_entries(self, entries) -> tuple:
        return fold_entries_fp64(entries)

    def staleness_weight(self, staleness) -> float:
        return staleness_weight(staleness,
                                self.program.aggregation.staleness_decay)

    def make_aggregator(self, policy=None) -> BufferedAggregator:
        return BufferedAggregator(policy or self.program.aggregation)


__all__ = ["RoundProgram", "HostProgram"]
