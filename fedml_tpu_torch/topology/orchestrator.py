"""Tree orchestrator: spawn, supervise, and tear down the process tree
(counterpart of ``fedml_tpu/topology/orchestrator.py``). Every child is
a process of this package: ``python -m fedml_tpu_torch.topology.edge``
and ``python -m fedml_tpu_torch.net.soak --swarm``.

:func:`run_tree` turns a :class:`~fedml_tpu_torch.topology.tree.TreeSpec`
into a running federation: one edge process per edge slot
(:mod:`fedml_tpu_torch.topology.edge`), one sharded soak swarm per bottom
edge (:mod:`fedml_tpu_torch.net.soak` ``--gid_base/--gid_stride``: LOCAL
ranks on the wire, GLOBAL ids in the oracle), and the REAL
coordinator -- an
:class:`~fedml_tpu_torch.resilience.async_agg.AsyncBufferedFedAvgServer`
over the spec's transport -- in THIS process, the same way
``net/soak.py`` runs its parent half.

Supervision: while the coordinator runs, a dead edge process (crash or
kill) is respawned with its exact original argv; the fresh process
re-dials its parent, whose transport accepts the late HELLO as a
rejoin (PEER_JOIN) and the coordinator resumes it mid-round -- no
orchestrator-side protocol beyond "start the same process again", by
design: the rejoin path IS the recovery protocol. The dead edge's
swarm shards died with their sockets, so the subtree's swarms respawn
with it.

Teardown is the stop wave, not signals: the coordinator finishing its
updates sends ``__stop__`` to the tier-1 edges, each edge's shutdown
forwards it down its own star, the swarms close on it, and every
process exits by itself; the orchestrator then reaps with a timeout
and force-kills only what overstayed (reported in the result -- a
clean run kills nothing and leaves no zombies).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from fedml_tpu_torch.observability import enable
from fedml_tpu_torch.observability.perfmon import append_ledger
from fedml_tpu_torch.topology.tree import TreeSpec


def _free_port(host):
    s = socket.socket()
    s.bind((host, 0))
    p = s.getsockname()[1]
    s.close()
    return p


class _Child:
    """One supervised subprocess: its argv (for respawn) + handle."""

    def __init__(self, name, cmd, parse_stdout=True):
        self.name = name
        self.cmd = cmd
        self.parse_stdout = parse_stdout
        self.proc = None
        self.respawns = 0
        self.summaries = []

    def spawn(self):
        self.proc = subprocess.Popen(
            self.cmd, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        return self.proc

    def collect(self, timeout=30.0):
        """Reap; parse the last JSON stdout line as the summary."""
        if self.proc is None:
            return None
        try:
            out, _ = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        for line in (out or "").strip().splitlines():
            try:
                self.summaries.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return self.summaries[-1] if self.summaries else None


def plan_tree(spec: TreeSpec, spec_path, status_dir, ledger_path=None):
    """The spawn plan: ``(coord_port, edges, swarms)`` with one
    :class:`_Child` per edge slot and per bottom-edge swarm shard.
    Ports are allocated here, once -- a respawned child reuses its
    port so its parent's rejoin admits the same topology slot."""
    host = spec.host
    coord_port = spec.coord_port or _free_port(host)
    ports = {path: _free_port(host) for path in spec.edge_paths()}
    edges, swarms = [], []
    for path in spec.edge_paths():
        tier = len(path)
        up_port = coord_port if tier == 1 else ports[path[:-1]]
        up_world = spec.fanout[tier - 1] + 1
        world = (spec.fanout[tier] + 1 if tier < spec.tiers
                 else spec.leaves_per_edge + 1)
        name = f"tier{tier}-edge{'.'.join(str(e) for e in path)}"
        cmd = [sys.executable, "-m", "fedml_tpu_torch.topology.edge",
               "--spec", str(spec_path), "--tier", str(tier),
               "--edge-rank", str(path[-1] + 1),
               "--upstream-port", str(up_port),
               "--upstream-world", str(up_world),
               "--listen-port", str(ports[path]),
               "--world", str(world),
               "--status", os.path.join(status_dir,
                                        f"{name}.status.json")]
        if ledger_path:
            cmd += ["--ledger", str(ledger_path)]
        edges.append(_Child(name, cmd))
        if tier == spec.tiers:  # bottom edge: its leaf swarm shard
            gid_base, gid_stride = spec.leaf_slice(path)
            scmd = [sys.executable, "-m", "fedml_tpu_torch.net.soak",
                    "--swarm", "--host", host,
                    "--port", str(ports[path]),
                    "--clients", str(spec.leaves_per_edge),
                    "--world", str(spec.leaves_per_edge + 1),
                    "--jitter_s", str(spec.jitter_s),
                    "--seed", str(spec.seed),
                    "--gid_base", str(gid_base),
                    "--gid_stride", str(gid_stride)]
            if spec.trace:
                scmd += ["--trace", str(spec.trace)]
            swarms.append(_Child(f"swarm-{name}", scmd))
    return coord_port, edges, swarms


def run_tree(spec: TreeSpec, workdir, init_params=None, supervise=True,
             join_timeout=600.0, metrics_logger=None,
             ledger_path=None, on_spawned=None, reap_timeout=60.0):
    """Run the spec's tree to completion. ``workdir`` receives the
    spec file and every tier's status.json; ``ledger_path`` (optional)
    collects the per-tier reports/sec rows plus the coordinator's.
    ``on_spawned(children)`` is a test hook called once every process
    is up (the edge-kill test reaches through it). Returns a result
    dict: the coordinator server, per-process summaries and statuses,
    and the supervision/teardown counters -- ``zombies`` MUST be 0 on
    a clean run. After the run, children get ``reap_timeout`` seconds
    to exit before the ones that overstay are killed (and counted)."""
    from fedml_tpu_torch.resilience.async_agg import (
        AsyncBufferedFedAvgServer)
    from fedml_tpu_torch.resilience.steering import PaceController
    from fedml_tpu_torch.topology.edge import _make_comm

    os.makedirs(workdir, exist_ok=True)
    spec_path = spec.to_file(os.path.join(workdir, "tree.json"))
    coord_port, edges, swarms = plan_tree(spec, spec_path, workdir,
                                          ledger_path=ledger_path)
    program = spec.round_program()
    policy = program.aggregation
    if init_params is None:
        init_params = {"w": np.zeros(8, np.float32),
                       "b": np.ones(4, np.float32)}
    pace = None
    if spec.steering:
        pace = PaceController(bounds=spec.pace_bounds(0), seed=spec.seed,
                              buffer_k=policy.buffer_k,
                              flush_deadline_s=policy.flush_deadline_s)
    children = edges + swarms
    # children dial with retry: spawn everything, then bring the
    # coordinator up under the burst (run_soak's discipline)
    for c in children:
        c.spawn()
    respawned = killed = 0
    world = spec.fanout[0] + 1
    t0 = time.monotonic()
    status_path = os.path.join(workdir, "tier0-coordinator.status.json")
    try:
        with enable(perfmon=True, status_path=status_path,
                    metrics_logger=metrics_logger):
            comm = _make_comm(spec.transport, spec.host, coord_port, 0,
                              world,
                              timeout=max(120.0, spec.n_leaves / 50.0))
            server = AsyncBufferedFedAvgServer(
                None, comm, world, init_params, spec.total_updates,
                policy, metrics_logger=metrics_logger,
                pace_controller=pace)
            # the coordinator executes the tree's ONE program: its
            # status.json must carry the same manifest as every tier's
            server.program = program
            server._host = program.host_view()
            server.agg = server._host.make_aggregator()
            server.register_message_receive_handlers()
            server.start()
            if on_spawned is not None:
                on_spawned({c.name: c for c in children})
            loop = threading.Thread(target=comm.handle_receive_message,
                                    daemon=True, name="tree-coordinator")
            loop.start()
            deadline = time.monotonic() + join_timeout
            while loop.is_alive() and time.monotonic() < deadline:
                loop.join(timeout=0.5)
                if not supervise or not loop.is_alive():
                    continue
                for c in children:
                    if c.proc.poll() is None:
                        continue
                    # a dead process while the run is live: respawn its
                    # exact argv -- the fresh HELLO is a transport
                    # rejoin, and the mid-round resume does the rest
                    c.collect(timeout=5.0)
                    logging.warning("tree: %s died (rc=%s) -- respawning",
                                    c.name, c.proc.returncode)
                    c.respawns += 1
                    respawned += 1
                    c.spawn()
            if loop.is_alive():
                comm.stop_receive_message()
                loop.join(timeout=15.0)
                raise TimeoutError(
                    f"tree coordinator hung past {join_timeout}s "
                    f"(update {server.agg.version}/{spec.total_updates},"
                    f" failed={server.failed})")
    finally:
        # the stop wave should have cascaded; reap, then force-kill
        # only what overstayed. A swarm whose edge CRASHED (nonzero
        # exit, not respawned) can never hear the wave -- its dial
        # retries would stall the whole reap budget, so orphans get a
        # short grace and a terminate instead
        edge_by_name = {c.name: c for c in edges}
        for s in swarms:
            e = edge_by_name.get(s.name[len("swarm-"):])
            if (s.proc is not None and s.proc.poll() is None
                    and e is not None and e.proc is not None
                    and e.proc.poll() not in (None, 0)):
                try:
                    s.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    s.proc.terminate()
                    killed += 1
        reap_by = time.monotonic() + reap_timeout
        for c in children:
            if c.proc is None:
                continue
            try:
                c.proc.wait(timeout=max(0.1, reap_by - time.monotonic()))
            except subprocess.TimeoutExpired:
                c.proc.kill()
                killed += 1
            c.collect(timeout=10.0)
    zombies = sum(1 for c in children if c.proc.poll() is None)
    wall = time.monotonic() - t0
    statuses = {}
    for f in sorted(os.listdir(workdir)):
        if f.endswith(".status.json"):
            with open(os.path.join(workdir, f)) as fh:
                statuses[f] = json.load(fh)
    total_reports = sum(s.get("reports", 0) for c in swarms
                       for s in c.summaries)
    if ledger_path:
        append_ledger({
            "bench": "tree-soak",
            "metric": (f"tree-soak leaf reports/sec ({spec.n_leaves} "
                       f"leaves, fanout {'x'.join(map(str, spec.fanout))}"
                       f", {spec.transport}, "
                       f"{spec.compressor or 'plain'} upstream, "
                       f"{'diurnal' if spec.trace else 'uniform'} "
                       f"arrivals, "
                       f"{'steered' if spec.steering else 'fixed'})"),
            "value": round(total_reports / max(wall, 1e-9), 2),
            "unit": "reports/sec",
            "leaves": spec.n_leaves, "updates": server.agg.version,
            "respawned": respawned, "killed": killed,
            "wall_s": round(wall, 3)}, ledger_path)
    return {"server": server, "history": server.history,
            "statuses": statuses,
            "edge_summaries": {c.name: c.summaries for c in edges},
            "swarm_summaries": {c.name: c.summaries for c in swarms},
            "respawned": respawned, "killed": killed,
            "zombies": zombies, "wall_s": round(wall, 3)}


__all__ = ["plan_tree", "run_tree"]
