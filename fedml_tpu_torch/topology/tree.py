"""TreeSpec: the declarative shape of a multi-process federation tree
(counterpart of ``fedml_tpu/topology/tree.py``; the same JSON document).

One JSON document describes the whole tree -- fan-out per edge tier,
leaves per bottom edge, the transports, the upstream wire codec, the
shared :class:`~fedml_tpu_torch.program.round.RoundProgram` manifest, the
diurnal trace, and the steering bounds -- so the orchestrator, every edge
process and the bench all read the SAME spec instead of re-deriving
the shape from flag soup. Serialization is ``sort_keys`` JSON: specs
diff cleanly and hash stably.

Leaf identity is arithmetic, not enumerated: the tree partitions the
flat leaf population ``1..N`` with the nested
:func:`~fedml_tpu_torch.net.fanin.round_robin_groups` rule (the same slices
the simulation path's group axis trains), and a nested round-robin
slice is an arithmetic progression -- so a bottom edge's whole leaf
set is two integers, ``(gid_base, gid_stride)``
(:meth:`TreeSpec.leaf_slice`), which is exactly what a sharded soak
swarm needs to key its oracle by GLOBAL id while dialing LOCAL ranks.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class TreeSpec:
    """The federation tree, declaratively.

    Attributes:
      fanout: edge fan-out per tier, root-first -- ``(2,)`` is a
        two-tier tree with 2 edges under the coordinator; ``(2, 2)``
        adds edges-of-edges (4 bottom edges in 2 groups of 2).
      leaves_per_edge: swarm leaves under each bottom edge.
      total_updates: coordinator updates before the tree tears down.
      transport: ``"eventloop"`` (the scalable default) or ``"tcp"``,
        for every star in the tree.
      compressor: upstream wire codec spec (``"qsgd"``/``"topk:0.01"``)
        on the coordinator-facing edge hop; None/"none" = plain.
      program: RoundProgram manifest dict shared by every tier's
        status.json (None = the default program's manifest).
      trace: DiurnalTrace JSON path the leaf swarms replay (None =
        uniform ``jitter_s``).
      jitter_s / seed: the pre-trace reply model + the tree-wide seed.
      buffer_k / flush_deadline_s / staleness_decay: coordinator
        aggregation knobs (buffer_k None = one slot per tier-1 edge).
      edge_deadline_s / edge_quorum: every edge's round policy
        (deadline 0 = wait for all alive leaves; the soak wants a real
        deadline so phase-dark leaves cannot wedge an edge; quorum 0
        completes any deadline round with >= 1 report, degraded).
      steering: arm one PaceController per tier (coordinator + every
        edge); per-tier bounds are ``tier_bounds`` INTERSECTED with
        ``bounds`` (PaceBounds.intersect -- an edge can never steer
        outside the coordinator's envelope).
      bounds / tier_bounds: ``{knob: [lo, hi]}`` PaceBounds overrides
        for the coordinator / the edge tiers.
      host / coord_port: where the coordinator listens (port None =
        orchestrator picks a free one).
    """

    fanout: tuple = (2,)
    leaves_per_edge: int = 4
    total_updates: int = 3
    transport: str = "eventloop"
    compressor: Optional[str] = None
    program: Optional[dict] = None
    trace: Optional[str] = None
    jitter_s: float = 0.0
    seed: int = 0
    buffer_k: Optional[int] = None
    flush_deadline_s: float = 30.0
    staleness_decay: float = 0.0
    edge_deadline_s: float = 0.0
    edge_quorum: float = 0.0
    steering: bool = False
    bounds: dict = field(default_factory=dict)
    tier_bounds: dict = field(default_factory=dict)
    host: str = "localhost"
    coord_port: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "fanout",
                           tuple(int(f) for f in self.fanout))
        if not self.fanout or any(f < 1 for f in self.fanout):
            raise ValueError(f"fanout {self.fanout!r}: need >=1 edge "
                             "per tier")
        if int(self.leaves_per_edge) < 1:
            raise ValueError("leaves_per_edge must be >= 1")

    # -- shape arithmetic ---------------------------------------------------
    @property
    def tiers(self) -> int:
        """Edge tiers (coordinator and leaves not counted)."""
        return len(self.fanout)

    @property
    def n_bottom_edges(self) -> int:
        n = 1
        for f in self.fanout:
            n *= f
        return n

    @property
    def n_leaves(self) -> int:
        return self.n_bottom_edges * int(self.leaves_per_edge)

    def edge_paths(self):
        """Every edge address as a path tuple, tier by tier:
        ``(e1,)`` tier-1 edges, ``(e1, e2)`` their children, ... --
        0-based indices into each tier's fan-out."""
        for depth in range(1, self.tiers + 1):
            for path in itertools.product(
                    *(range(f) for f in self.fanout[:depth])):
                yield path

    def leaf_slice(self, path) -> tuple:
        """``(gid_base, gid_stride)`` of the BOTTOM edge at ``path``:
        the arithmetic progression nested ``round_robin_groups`` hands
        it over the flat population ``1..n_leaves`` (``ids[e::F]`` of
        an arithmetic slice is an arithmetic slice; induction over
        tiers). Its leaves are ``gid_base + i * gid_stride`` for
        ``i in range(leaves_per_edge)``."""
        path = tuple(int(e) for e in path)
        if len(path) != self.tiers:
            raise ValueError(f"path {path!r}: bottom edges live at "
                             f"depth {self.tiers}")
        base, stride = 1, 1
        for e, f in zip(path, self.fanout):
            if not 0 <= e < f:
                raise ValueError(f"path {path!r} outside fanout "
                                 f"{self.fanout!r}")
            base += e * stride
            stride *= f
        return base, stride

    # -- the one program ----------------------------------------------------
    def round_program(self):
        """The ONE :class:`~fedml_tpu_torch.program.round.RoundProgram`
        every tier of this tree executes: ``program`` manifest when
        given, else derived from the spec knobs (cohort leg = the edge
        round policy, aggregation leg = the coordinator's buffer knobs,
        codec leg = the upstream wire). Every tier's status.json
        carries this manifest; per-tier steering then evolves the
        steered knobs (cohort.deadline_s/overselect at the edges,
        aggregation buffer/flush at the root) while the core --
        quorum, retries, decay, codec -- stays invariant
        (:func:`manifest_core`)."""
        from fedml_tpu_torch.program.aggregation import AggregationPolicy
        from fedml_tpu_torch.program.cohort import CohortPolicy
        from fedml_tpu_torch.program.round import RoundProgram
        if self.program is not None:
            return RoundProgram.from_manifest(self.program)
        return RoundProgram(
            cohort=CohortPolicy(deadline_s=float(self.edge_deadline_s),
                                quorum=float(self.edge_quorum)),
            aggregation=AggregationPolicy(
                buffer_k=(int(self.buffer_k) if self.buffer_k is not None
                          else self.fanout[0]),
                staleness_decay=float(self.staleness_decay),
                flush_deadline_s=float(self.flush_deadline_s)),
            codec=self.compressor or "none")

    def pace_bounds(self, tier: int = 0):
        """The PaceBounds a tier's controller is constructed with:
        tier 0 (the coordinator) gets ``bounds``; every edge tier gets
        ``tier_bounds`` INTERSECTED with the coordinator's
        (:meth:`~fedml_tpu_torch.resilience.steering.PaceBounds.intersect`)
        -- the per-tier clamp that keeps a tier inside the root's
        steering envelope."""
        from fedml_tpu_torch.resilience.steering import PaceBounds

        def build(over):
            kw = {k: tuple(v) for k, v in (over or {}).items()}
            return PaceBounds(**kw)

        outer = build(self.bounds)
        if tier == 0:
            return outer
        return build(self.tier_bounds).intersect(outer)

    # -- serialization ------------------------------------------------------
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["fanout"] = list(self.fanout)
        return json.dumps(d, sort_keys=True, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TreeSpec":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"TreeSpec: unknown keys {sorted(unknown)}")
        return cls(**data)

    def to_file(self, path) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return str(path)

    @classmethod
    def from_file(cls, path) -> "TreeSpec":
        with open(path) as f:
            return cls.from_json(f.read())


#: RoundProgram manifest knobs per-tier pace steering may legitimately
#: evolve mid-run; everything else must match across every tier of one
#: tree (the tree soak compares manifest_core of every status.json).
_STEERED_KNOBS = {"cohort": ("deadline_s", "overselect"),
                  "aggregation": ("buffer_k", "flush_deadline_s")}


def manifest_core(manifest: dict) -> dict:
    """A RoundProgram manifest with the steered knobs normalized out:
    the per-tier INVARIANT identity of the program (codec, quorum,
    retries, staleness law). Two tiers of one tree must agree on the
    core even while their controllers steer the knobs apart."""
    core = json.loads(json.dumps(manifest, sort_keys=True))
    for leg, knobs in _STEERED_KNOBS.items():
        for k in knobs:
            core.get(leg, {}).pop(k, None)
    return core


__all__ = ["TreeSpec", "manifest_core"]

