"""The edge process: one fan-in tier member as a real OS process
(counterpart of ``fedml_tpu/topology/edge.py``).

``python -m fedml_tpu_torch.topology.edge --spec tree.json --tier T ...``
runs ONE :class:`~fedml_tpu_torch.net.fanin.EdgeAggregator` for its slot in
the tree: a leaf-star server downstream (its children are swarm leaves
or deeper edge processes), a dialing client upstream (the coordinator
or its parent edge), both over the spec's transport. The aggregator
drives the tree's ONE shared
:class:`~fedml_tpu_torch.program.round.RoundProgram`
via ``host_view()`` -- the same fold every other tier executes -- and,
when the spec arms steering, its own per-tier
:class:`~fedml_tpu_torch.resilience.steering.PaceController` whose bounds
are the spec's tier bounds intersected with the coordinator's
(:meth:`TreeSpec.pace_bounds`).

Per-tier observability: the process arms its own
``observability.enable(perfmon=True, status_path=...)`` scope, so its
``status.json`` (program manifest + tier id + rounds/hour, sorted
keys) and its registry histograms are THIS tier's, not a mashup --
which is precisely what makes per-tier steering read per-tier
evidence. On exit it appends a per-tier reports/sec row to the ledger
(``--ledger``) and prints a one-line JSON summary to stdout for the
orchestrator to collect.

Lifecycle: construct the uplink first (dials with retry until the
parent listens), then the downlink (its constructor waits for every
child HELLO), then serve until the upstream STOP wave or parent loss
tears the subtree down (``EdgeAggregator.run`` cascades the stop to
the children).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from fedml_tpu_torch.net.fanin import EdgeAggregator
from fedml_tpu_torch.observability import enable
from fedml_tpu_torch.observability.perfmon import append_ledger
from fedml_tpu_torch.resilience.steering import PaceController
from fedml_tpu_torch.topology.tree import TreeSpec


def _make_comm(transport, host, port, rank, world, timeout):
    # inline per-transport construction, as in fanin.run_fanin_fedavg
    if transport == "eventloop":
        from fedml_tpu_torch.net.eventloop import EventLoopCommManager
        return EventLoopCommManager(host, port, rank, world,
                                    timeout=timeout)
    from fedml_tpu_torch.core.comm.tcp import TcpCommManager
    return TcpCommManager(host, port, rank, world, timeout=timeout)


def run_edge_process(spec: TreeSpec, tier: int, edge_rank: int,
                     upstream_host: str, upstream_port: int,
                     upstream_world: int, listen_port: int, world: int,
                     status_path=None, ledger_path=None,
                     timeout: float = 120.0) -> dict:
    """Run one edge slot to completion; returns its summary dict."""
    program = spec.round_program()
    round_policy = program.cohort
    pace = None
    if spec.steering:
        # per-tier controller: starts from the program's knobs, bounded
        # by the tier envelope (intersected with the coordinator's)
        pace = PaceController(
            bounds=spec.pace_bounds(tier), seed=spec.seed,
            deadline_s=round_policy.deadline_s or 1.0,
            overselect=round_policy.overselect)
    up = _make_comm(spec.transport, upstream_host, upstream_port,
                    edge_rank, upstream_world, timeout)
    down = _make_comm(spec.transport, spec.host, listen_port, 0, world,
                      timeout)
    # only the coordinator-facing hop ships the compressed wire: inner
    # hops move pre-aggregated folds between co-located processes
    compressor = spec.compressor if tier == 1 else None
    edge = EdgeAggregator(edge_rank, up, upstream_world, down, world,
                          round_policy=round_policy,
                          compressor=compressor, pace_controller=pace,
                          tier=tier, program=program)
    t0 = time.monotonic()
    with enable(perfmon=True, status_path=status_path):
        edge._report_health()  # tier identity visible before round 1
        edge.run()
        wall = time.monotonic() - t0
        summary = edge.status_fields()
    summary["wall_s"] = round(wall, 3)
    if ledger_path:
        append_ledger({
            "bench": "tree-edge",
            "metric": (f"tree-edge reports/sec (tier {tier}, "
                       f"{spec.transport}, "
                       f"{spec.compressor or 'plain'} upstream)"),
            "value": round(edge.leaf_reports / max(wall, 1e-9), 2),
            "unit": "reports/sec",
            "tier": tier, "edge_rank": edge_rank,
            "reports": edge.leaf_reports,
            "rounds_forwarded": edge.rounds_forwarded,
            "wall_s": round(wall, 3)}, ledger_path)
    return summary


def _main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--spec", required=True,
                   help="TreeSpec JSON file (topology.tree)")
    p.add_argument("--tier", type=int, required=True,
                   help="this edge's tier (1 = under the coordinator)")
    p.add_argument("--edge-rank", type=int, required=True,
                   help="upstream dial rank (1..fanout of the parent)")
    p.add_argument("--upstream-host", default=None)
    p.add_argument("--upstream-port", type=int, required=True)
    p.add_argument("--upstream-world", type=int, required=True)
    p.add_argument("--listen-port", type=int, required=True)
    p.add_argument("--world", type=int, required=True,
                   help="downlink world size (children + 1)")
    p.add_argument("--status", default=None,
                   help="this tier member's status.json path")
    p.add_argument("--ledger", default=None,
                   help="JSONL perf ledger for the per-tier "
                        "reports/sec row")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--log-level", default="WARNING")
    args = p.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(),
                                      logging.WARNING))
    spec = TreeSpec.from_file(args.spec)
    summary = run_edge_process(
        spec, args.tier, args.edge_rank,
        args.upstream_host or spec.host, args.upstream_port,
        args.upstream_world, args.listen_port, args.world,
        status_path=args.status, ledger_path=args.ledger,
        timeout=args.timeout)
    sys.stdout.write(json.dumps(summary, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(_main())


__all__ = ["run_edge_process"]
