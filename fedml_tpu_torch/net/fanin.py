"""Hierarchical fan-in: edge aggregators between the clients and the server
(counterpart of ``fedml_tpu/net/fanin.py``).

Bonawitz et al. (MLSys'19 S3) never hang N devices off one socket: devices
report to *edge aggregators*, and only the edges talk to the coordinator.
This module is that tier for the distributed control plane, composed with
the pieces the repo already has:

- each **edge** owns a leaf star (it is the rank-0 server of its own
  little world) and collects leaf reports with the ordinary
  :class:`~fedml_tpu_torch.resilience.policy.RoundController` --
  deadline/quorum/partial aggregation all apply per edge;
- a decided edge round folds its reports through the edge's
  :class:`~fedml_tpu_torch.program.round.RoundProgram` host view
  (:func:`~fedml_tpu_torch.program.aggregation.aggregate_reports`) and
  forwards ONE
  pre-aggregated report upstream (``params`` = the edge's weighted
  average, ``num_samples`` = its reporters' sample total) over the same
  ``res_sync``/``res_report`` schema -- weighted means compose exactly:
  the coordinator's weighted fold over edge aggregates equals the
  two-tier fold over all leaves, bit for bit;
- the **coordinator** is the unchanged
  :class:`~fedml_tpu_torch.resilience.async_agg.AsyncBufferedFedAvgServer`:
  its :class:`~fedml_tpu_torch.resilience.async_agg.BufferedAggregator`
  folds E
  edge reports per window instead of holding N client connections, and a
  straggling edge's late report is simply a staleness-discounted fold.

Leaf clients are the unchanged
:class:`~fedml_tpu_torch.resilience.integration.ResilientFedAvgClient`; the
group assignment rule (:func:`round_robin_groups`) is shared with the
simulation path's ``algorithms/hierarchical.py`` two-tier averaging, so
the distributed tree and the simulated group axis partition cohorts the
same way. Transports are selectable per tier (``--transport``): the
coordinator<->edge star and every edge's leaf star each run over tcp or
the event loop.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

import numpy as np

from fedml_tpu_torch.compression.wire import (WIRE_DELTA_KEY,
                                              WIRE_SPEC_KEY,
                                              CompressedUpdate, ef_step,
                                              encode_rng, host_compressor)
from fedml_tpu_torch.core.comm.base import (MSG_TYPE_PEER_JOIN,
                                            MSG_TYPE_PEER_LOST)
from fedml_tpu_torch.core.managers import ClientManager, ServerManager
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.observability.perfmon import get_perf_monitor
from fedml_tpu_torch.observability.tracing import get_tracer
from fedml_tpu_torch.program.cohort import CohortPolicy
from fedml_tpu_torch.program.round import RoundProgram
from fedml_tpu_torch.resilience.integration import (MSG_C2S_REPORT,
                                                    MSG_S2C_SYNC,
                                                    ResilientFedAvgClient,
                                                    quadratic_trainer)
from fedml_tpu_torch.resilience.policy import (RetryPolicy, RoundController,
                                               RoundPolicy, send_with_retry)


def round_robin_groups(ids, n_groups):
    """Round-robin group assignment: element ``i`` joins group
    ``i % n_groups``; empty groups are dropped. THE shared partition rule
    between this distributed fan-in tier and the simulation path's
    ``HierarchicalFedAvgAPI`` (``algorithms/hierarchical.py``) -- both
    tiers of both paradigms slice a cohort identically."""
    ids = list(ids)
    groups = [ids[g::n_groups] for g in range(n_groups)]
    return [g for g in groups if g]


class _EdgeUplink(ClientManager):
    """The edge's coordinator-facing half: receives SYNCs (open an edge
    round over the leaves), sends the edge's pre-aggregated REPORT."""

    def __init__(self, args, comm, rank, size, edge):
        super().__init__(args, comm, rank=rank, size=size)
        self.edge = edge

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_S2C_SYNC, self._on_sync)
        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,
                                              self._on_peer_lost)

    def _on_sync(self, msg):
        logging.debug("edge %d: coordinator sync (version %s)",
                      self.rank, msg.get("round"))
        self.edge.open_round(msg.get("params"), int(msg.get("round")),
                             int(msg.get("attempt")))

    def _on_peer_lost(self, msg):
        if int(msg.get_sender_id()) != 0:
            logging.info("edge %d: sibling edge %s lost (ignored)",
                         self.rank, msg.get_sender_id())
            return
        logging.warning("edge %d: coordinator lost -- stopping the "
                        "subtree", self.rank)
        self.edge.shutdown()


class _EdgeDownlink(ServerManager):
    """The edge's leaf-facing half: rank 0 of the leaf star; feeds leaf
    reports and deaths to the edge's round controller."""

    def __init__(self, args, comm, size, edge):
        super().__init__(args, comm, rank=0, size=size)
        self.edge = edge

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_C2S_REPORT,
                                              self._on_report)
        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,
                                              self._on_peer_lost)
        self.register_message_receive_handler(MSG_TYPE_PEER_JOIN,
                                              self._on_peer_join)

    def _on_report(self, msg):
        logging.debug("edge %d: leaf %s report (round %s)",
                      self.edge.edge_rank, msg.get_sender_id(),
                      msg.get("round"))
        self.edge.on_leaf_report(msg)

    def _on_peer_lost(self, msg):
        logging.warning("edge %d: leaf rank %s lost", self.edge.edge_rank,
                        msg.get_sender_id())
        self.edge.on_leaf_lost(int(msg.get_sender_id()))

    def _on_peer_join(self, msg):
        logging.debug("edge %d: leaf %s rejoined", self.edge.edge_rank,
                      msg.get_sender_id())
        self.edge.on_leaf_join(int(msg.get_sender_id()))


class EdgeAggregator:
    """One fan-in edge: a leaf-star server and a coordinator client
    sharing a round controller.

    Protocol per coordinator SYNC (server version ``v``): broadcast the
    model to every alive leaf, collect reports under the edge's
    ``RoundPolicy`` (deadline => partial aggregation over the reporting
    subset, exactly the synchronous server's semantics), and forward one
    pre-aggregated report tagged with ``v`` upstream. An edge round
    abandoned below quorum re-runs locally (attempt + 1, after the
    abandon-backoff steering decision) up to ``max_round_retries``;
    only an exhausted version forwards nothing -- the coordinator's
    flush deadline / staleness machinery absorbs that hole, and it can
    only absorb it if SOME tier-1 edge eventually reports (an async
    coordinator re-syncs on flushes; the local re-run is what keeps a
    fully-abandoned version from wedging the tree).
    """

    def __init__(self, edge_rank, uplink_comm, uplink_size, downlink_comm,
                 downlink_size, round_policy: Optional[RoundPolicy] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 compressor=None, pace_controller=None, tier=1,
                 program=None):
        self.edge_rank = int(edge_rank)
        self.tier = int(tier)
        # one RoundProgram per edge: the edge's round policy is its
        # cohort leg, and the decided-round fold runs through the
        # program's host view -- the same fold the coordinator and the
        # simulated rounds execute. A topology tree passes the ONE
        # shared program (TreeSpec.round_program) so every tier's
        # status.json carries the same manifest.
        if program is not None:
            # the manifest's codec leg names the TREE's upstream wire;
            # whether THIS edge's own uplink compresses stays the
            # explicit ``compressor`` arg (only the coordinator-facing
            # hop does -- the expensive one)
            self.program = (program if round_policy is None
                            else program.replace(cohort=round_policy))
        else:
            self.program = RoundProgram(
                cohort=round_policy or CohortPolicy(),
                codec=compressor or "none")
        self._host = self.program.host_view()
        self.round_policy = self.program.cohort
        self.retry_policy = retry_policy or RetryPolicy()
        # upstream wire compression: the edge ships its fold as an
        # EF-compressed DELTA against the params the coordinator synced
        # (which is exactly the base the coordinator retains for this
        # rank's born version -- async_agg._report_payload_locked)
        self._comp = host_compressor(compressor)
        self._ef_residual = None
        self.pace = pace_controller  # per-tier steering (None = fixed)
        self.alive = set(range(1, downlink_size))
        self.rounds_forwarded = 0
        self.rounds_abandoned = 0
        self.rounds_preempted = 0
        self.rounds_retried = 0
        self.leaves_rejoined = 0
        self.leaves_resumed = 0
        self.leaf_reports = 0
        # edge round bookkeeping (version/attempt/params of the open
        # round): open_round and the controller callbacks run on this
        # edge's two dispatcher threads plus the deadline timer; _lock
        # serializes their shared state (the controller itself is the
        # thread-safe piece)
        self._version = None
        self._attempt = 0
        self._params = None     # the open round's broadcast base
        self._open = False      # an armed attempt not yet decided
        self._round_t0 = None
        self._pending_round_dt = None
        self._last_selected = 0
        self._last_outcome = None
        self._lock = threading.Lock()  # guards alive + _version/_attempt
        self._controller = RoundController(
            self.round_policy, self._on_edge_complete,
            self._on_edge_abandoned)
        self.uplink = _EdgeUplink(None, uplink_comm, self.edge_rank,
                                  uplink_size, self)
        self.downlink = _EdgeDownlink(None, downlink_comm, downlink_size,
                                      self)

    # -- edge round machinery (dispatcher threads) -------------------------
    def open_round(self, params, version, attempt):
        with self._lock:
            alive = sorted(self.alive)
            # preemption: the coordinator's flush deadline can sync
            # version v+1 while this edge's round v is still collecting
            # (an async coordinator never waits for every edge). The
            # stale attempt is cancelled -- its late leaf reports land
            # in the controller's late counter -- and the new version
            # opens immediately; begin() would otherwise raise on the
            # still-open attempt and kill the dispatcher thread.
            preempt = self._open
            self._version, self._attempt = version, attempt
            self._params = params
            self._open = bool(alive)
            self._round_t0 = (time.time()
                              if get_perf_monitor() is not None else None)
            if preempt:
                self.rounds_preempted += 1
            if alive:
                self._last_selected = len(alive)
        if preempt:
            logging.warning("edge %d: version %s preempts a still-open "
                            "edge round -- cancelling it", self.edge_rank,
                            version)
            self._controller.cancel()
        if not alive:
            logging.warning("edge %d: no alive leaves -- nothing to "
                            "fan out", self.edge_rank)
            return
        self._controller.begin(version, attempt, alive, len(alive))
        tracer = get_tracer()
        syncs = []
        for r in alive:
            m = Message(MSG_S2C_SYNC, 0, r)
            m.add("params", params)
            m.add("round", version)
            m.add("attempt", attempt)
            tracer.inject(m)
            syncs.append(m)
        for m in syncs:  # sends outside any state lock, as everywhere
            try:
                send_with_retry(self.downlink.com_manager, m,
                                self.retry_policy)
            except (ConnectionError, OSError):
                pass  # leaf-lost dispatch already told the controller

    def on_leaf_report(self, msg):
        mon = get_perf_monitor()
        if mon is not None:
            with self._lock:
                t0 = (self._round_t0
                      if (int(msg.get("round")) == self._version
                          and int(msg.get("attempt")) == self._attempt)
                      else None)
            if t0 is not None:
                # feeds THIS tier's straggler tail -- the histogram this
                # edge's own PaceController windows over (per-process
                # registry = per-tier distributions)
                mon.observe_report_latency(time.time() - t0)
        self.leaf_reports += 1
        self._controller.report(
            msg.get("round"), msg.get("attempt"), msg.get_sender_id(),
            msg.get("num_samples"), self._leaf_payload(msg))

    def _leaf_payload(self, msg):
        """Plain leaf reports stay numpy param dicts; a compressed leaf
        report (``cdelta``) decodes against the open round's broadcast
        base at fold time -- acceptance (round/attempt match) guarantees
        the captured base IS the model this edge fanned out, the same
        invariant integration._report_payload documents."""
        enc = msg.get(WIRE_DELTA_KEY)
        if enc is None:
            return {k: np.asarray(v) for k, v in msg.get("params").items()}
        with self._lock:
            base = self._params
        return CompressedUpdate(enc=enc, spec=str(msg.get(WIRE_SPEC_KEY)),
                                base=base, base_key=0)

    def on_leaf_lost(self, rank):
        with self._lock:
            self.alive.discard(int(rank))
        self._controller.peer_lost(rank)

    def on_leaf_join(self, rank):
        """Rejoin at the edge tier: a shed leaf's fresh HELLO re-admits
        it to this edge's alive set AND resumes it into the edge round
        in flight (``RoundController.admit`` + a mid-round SYNC with the
        open round's base and context), so it contributes this round
        instead of idling to the next -- the same mid-round delta
        resume the coordinator tier runs (a rejoined leaf cannot stay
        stranded outside every cohort)."""
        rank = int(rank)
        sync = None
        with self._lock:
            if rank in self.alive:
                logging.info("edge %d: duplicate leaf-join for rank %s "
                             "(already alive)", self.edge_rank, rank)
                return
            self.alive.add(rank)
            self.leaves_rejoined += 1
            if (self._open and self._controller.admit(
                    self._version, self._attempt, rank)):
                self.leaves_resumed += 1
                sync = Message(MSG_S2C_SYNC, 0, rank)
                sync.add("params", self._params)
                sync.add("round", self._version)
                sync.add("attempt", self._attempt)
                get_tracer().inject(sync)
        if sync is not None:
            logging.warning("edge %d: leaf rank %s rejoined -- resumed "
                            "into the open edge round", self.edge_rank,
                            rank)
            try:  # delivered OUTSIDE the lock, as everywhere
                send_with_retry(self.downlink.com_manager, sync,
                                self.retry_policy)
            except (ConnectionError, OSError):
                pass  # leaf-lost dispatch already told the controller
        else:
            logging.warning("edge %d: leaf rank %s rejoined -- eligible "
                            "from the next edge round", self.edge_rank,
                            rank)
        self._report_health()

    def _on_edge_complete(self, reports, outcome):
        with self._lock:  # steering replaces _host on a pace decision
            host = self._host
        params, total = host.fold_reports(reports)
        with self._lock:
            version = self._version
            base = self._params
            ordinal = self.rounds_forwarded
            self.rounds_forwarded += 1
            self._open = False
            self._last_outcome = outcome
            if self._round_t0 is not None:
                self._pending_round_dt = time.time() - self._round_t0
        logging.info("edge %d: %s with %d leaf report(s) -> forwarding "
                     "n=%s upstream (version %s)", self.edge_rank, outcome,
                     len(reports), total, version)
        out = Message(MSG_C2S_REPORT, self.edge_rank, 0)
        if self._comp is None or base is None:
            out.add("params", params)
        else:
            # the compressed upstream wire: EF-encode the fold's delta
            # against the synced base, rng keyed (edge_rank, version,
            # ordinal) so two runs over the same schedule encode
            # bit-identically (ordinal = forwarded-report count; in a
            # fault-free run it equals the edge-round index)
            base32 = {k: np.asarray(v, np.float32)
                      for k, v in base.items()}
            delta = {k: np.asarray(params[k], np.float32) - base32[k]
                     for k in base32}
            enc, _decoded, self._ef_residual = ef_step(
                self._comp, delta, self._ef_residual,
                encode_rng((self.edge_rank, version, ordinal)))
            out.add(WIRE_DELTA_KEY, enc)
            out.add(WIRE_SPEC_KEY, self._comp.spec)
        out.add("num_samples", float(total))
        out.add("round", version)
        out.add("attempt", 0)
        get_tracer().inject(out)
        try:
            send_with_retry(self.uplink.com_manager, out, self.retry_policy)
        except (ConnectionError, OSError):
            logging.warning("edge %d: upstream report failed (coordinator "
                            "lost?)", self.edge_rank)
        self._steer(outcome, len(reports))
        self._report_health()

    def _on_edge_abandoned(self, reports):
        with self._lock:
            self.rounds_abandoned += 1
            self._open = False
            self._last_outcome = "abandoned"
            version, attempt = self._version, self._attempt
            params = self._params
        logging.warning("edge %d: round abandoned with %d report(s)",
                        self.edge_rank, len(reports))
        # abandon-backoff FIRST: the re-run attempt opens with a longer
        # deadline, not the one that just starved
        self._steer("abandoned", len(reports))
        with self._lock:
            # re-run locally (the sync server's abandoned-round
            # semantics, per tier): an async coordinator only re-syncs
            # on a flush, and a flush needs SOME tier-1 report -- if
            # every edge abandoned one version and forwarded nothing,
            # the whole tree would wedge. Bounded by the policy's
            # max_round_retries; a newer sync that arrived meanwhile
            # owns the round instead.
            retry = (not self._open and self._version == version
                     and self._attempt == attempt
                     and attempt < self.round_policy.max_round_retries)
            if retry:
                self.rounds_retried += 1
        if retry:
            self.open_round(params, version, attempt + 1)
        else:
            logging.warning("edge %d: forwarding nothing for version %s "
                            "(coordinator staleness/deadline machinery "
                            "absorbs it)", self.edge_rank, version)
        self._report_health()

    def _steer(self, outcome, n_reports):
        """One per-tier pace decision per decided edge round: this
        edge's controller reads its OWN process's histograms (the leaf
        star it serves), and its bounds were intersected with the
        coordinator's (``PaceBounds.intersect``) at construction -- a
        tier steers its leaf-facing deadline/overselect inside the
        root's envelope, never outside it (the two-level control
        problem, Bonawitz S3)."""
        if self.pace is None:
            return
        with self._lock:  # one decision point at a time, as the law asks
            dec = self.pace.decide(
                outcome=outcome, selected=self._last_selected,
                reporting=min(n_reports, self._last_selected),
                obs=self.pace.observe_registry())
            if (dec.deadline_s != self.round_policy.deadline_s
                    or dec.overselect != self.round_policy.overselect):
                self.round_policy = dataclasses.replace(
                    self.round_policy, deadline_s=dec.deadline_s,
                    overselect=dec.overselect)
                self.program = self.program.replace(
                    cohort=self.round_policy)
                self._host = self.program.host_view()
                self._controller.policy = self.round_policy
                logging.info("edge %d: pace steering -> deadline %.3fs, "
                             "overselect %.3f (%s)", self.edge_rank,
                             dec.deadline_s, dec.overselect, dec.reason)

    def status_fields(self) -> dict:
        """Per-tier status.json snapshot: which program this tier is
        executing, where its round cursor is, and its counters --
        written through the StatusWriter (sorted keys)."""
        with self._lock:
            fields = {
                "server": "edge",
                "tier": self.tier,
                "edge_rank": self.edge_rank,
                "round": self._version,
                "attempt": self._attempt,
                "last_outcome": self._last_outcome,
                "alive_leaves": sorted(self.alive),
                "rounds_forwarded": self.rounds_forwarded,
                "rounds_abandoned": self.rounds_abandoned,
                "rounds_preempted": self.rounds_preempted,
                "rounds_retried": self.rounds_retried,
                "leaf_reports": self.leaf_reports,
                "leaves_rejoined": self.leaves_rejoined,
                "leaves_resumed": self.leaves_resumed,
                "program": self.program.manifest(),
            }
            if self.pace is not None:
                fields["pace"] = self.pace.status_fields()
        return fields

    def _report_health(self):
        """Status.json + round-pace snapshot for THIS tier's perf
        monitor (each edge process arms its own via
        ``observability.enable``). No-op when the monitor is off."""
        mon = get_perf_monitor()
        if mon is None:
            return
        fields = self.status_fields()
        with self._lock:
            dt, self._pending_round_dt = self._pending_round_dt, None
        if dt is not None:
            mon.observe_round(dt)
        rph = mon.rounds_per_hour()
        if rph is not None:
            fields["rounds_per_hour"] = rph
        mon.status_update(force=True, **fields)

    def shutdown(self):
        self._controller.cancel()
        self.downlink.finish()
        self.uplink.finish()

    def run(self):
        """Serve both halves until the coordinator stops us: the downlink
        loop runs on a daemon thread, the uplink loop on the caller's;
        when the uplink ends (STOP or coordinator loss) the subtree is
        torn down."""
        self.downlink.register_message_receive_handlers()
        down = threading.Thread(
            target=self.downlink.com_manager.handle_receive_message,
            daemon=True, name=f"edge-{self.edge_rank}-down")
        down.start()
        try:
            self.uplink.run()
        finally:
            self.shutdown()
        down.join(timeout=10.0)


def run_fanin_fedavg(n_edges, leaves_per_edge, total_updates, async_policy,
                     init_params, round_policy=None, trainer=None,
                     fault_plan=None, transport="tcp", metrics_logger=None,
                     host="localhost", timeout=60.0, join_timeout=120.0,
                     compressor=None, sub_edges=None):
    """Drive a full two- or three-tier fan-in scenario in one process: a
    buffered-async coordinator over ``n_edges`` edge aggregators, each
    owning ``leaves_per_edge`` unchanged ``ResilientFedAvgClient``
    leaves -- or, with ``sub_edges=E2``, each owning ``E2`` second-tier
    edge aggregators (edges-of-edges) that own the leaves.

    Leaves get GLOBAL ids via :func:`round_robin_groups` over the flat
    leaf population, nested per tier (the same slices
    ``HierarchicalFedAvgAPI`` would train as its group axis), and the
    default trainer is the global-id-keyed quadratic oracle -- so tests
    can replicate the exact multi-tier fold host-side. ``compressor``
    arms the compressed upstream wire on the coordinator-facing edges
    (the tree's expensive hop); inner wires stay plain. Returns
    ``(coordinator_server, edges)``.
    """
    import socket

    from fedml_tpu_torch.core.comm.tcp import TcpCommManager
    from fedml_tpu_torch.net.eventloop import EventLoopCommManager
    from fedml_tpu_torch.resilience.async_agg import (
        AsyncBufferedFedAvgServer)

    def free_port():
        s = socket.socket()
        s.bind((host, 0))
        p = s.getsockname()[1]
        s.close()
        return p

    def make_comm(port, rank, world, metrics=None):
        # inline per-transport construction, as in run_tcp_fedavg
        if transport == "eventloop":
            return EventLoopCommManager(host, port, rank, world,
                                        timeout=timeout,
                                        metrics_logger=metrics)
        return TcpCommManager(host, port, rank, world, timeout=timeout,
                              metrics_logger=metrics)

    base_trainer = trainer or quadratic_trainer()
    fan_below = (sub_edges or 1) * leaves_per_edge
    n_leaves = n_edges * fan_below
    groups = round_robin_groups(range(1, n_leaves + 1), n_edges)
    coord_port = free_port()
    edge_ports = [free_port() for _ in range(n_edges)]
    edges, threads = [], []

    def run_leaf(port, world, local_rank, global_id):
        comm = make_comm(port, local_rank, world)
        if fault_plan is not None:
            comm = fault_plan.wrap(comm, global_id)

        def train(params, round_idx, _local):
            return base_trainer(params, round_idx, global_id)

        fsm = ResilientFedAvgClient(None, comm, local_rank, world, train)
        fsm.run()

    def start_leaves(port, gids):
        # leaves dial their edge's port with retry; start them first,
        # then bring the downlink server up (its ctor waits for HELLOs)
        for local_rank, gid in enumerate(gids, start=1):
            t = threading.Thread(target=run_leaf,
                                 args=(port, len(gids) + 1, local_rank,
                                       gid),
                                 daemon=True, name=f"leaf-{port}-{gid}")
            t.start()
            threads.append(t)

    def run_sub_edge(parent_port, local_rank, gids):
        # an edge-of-edges: leaf star below, a plain upstream report to
        # its parent edge (only the coordinator-facing hop compresses)
        port = free_port()
        start_leaves(port, gids)
        down = make_comm(port, 0, len(gids) + 1)
        up = make_comm(parent_port, local_rank, sub_edges + 1)
        edge = EdgeAggregator(local_rank, up, sub_edges + 1, down,
                              len(gids) + 1, round_policy=round_policy,
                              tier=2)
        edges.append(edge)
        edge.run()

    def run_edge(edge_idx):
        if sub_edges:
            subgroups = round_robin_groups(groups[edge_idx], sub_edges)
            for s, gids in enumerate(subgroups, start=1):
                t = threading.Thread(
                    target=run_sub_edge,
                    args=(edge_ports[edge_idx], s, gids), daemon=True,
                    name=f"subedge-{edge_idx}-{s}")
                t.start()
                threads.append(t)
            down_world = len(subgroups) + 1
        else:
            start_leaves(edge_ports[edge_idx], groups[edge_idx])
            down_world = leaves_per_edge + 1
        down = make_comm(edge_ports[edge_idx], 0, down_world)
        up = make_comm(coord_port, edge_idx + 1, n_edges + 1)
        edge = EdgeAggregator(edge_idx + 1, up, n_edges + 1, down,
                              down_world, round_policy=round_policy,
                              compressor=compressor, tier=1)
        edges.append(edge)
        edge.run()

    edge_threads = [threading.Thread(target=run_edge, args=(e,),
                                     daemon=True, name=f"edge-{e}")
                    for e in range(n_edges)]
    for t in edge_threads:
        t.start()
    comm = make_comm(coord_port, 0, n_edges + 1, metrics=metrics_logger)
    server = AsyncBufferedFedAvgServer(
        None, comm, n_edges + 1, init_params, total_updates, async_policy,
        metrics_logger=metrics_logger)
    server.register_message_receive_handlers()
    server.start()
    if server.agg.version < server.total_updates and server.failed is None:
        loop = threading.Thread(target=server.com_manager
                                .handle_receive_message, daemon=True,
                                name="fanin-coordinator-loop")
        loop.start()
        loop.join(timeout=join_timeout)
        if loop.is_alive():
            server.com_manager.stop_receive_message()
            loop.join(timeout=10.0)
            raise TimeoutError(
                f"fan-in coordinator hung past {join_timeout}s "
                f"(update {server.agg.version}, failed={server.failed})")
    else:
        server.com_manager.stop_receive_message()
    for t in edge_threads:
        t.join(timeout=15.0)
    for t in threads:
        t.join(timeout=10.0)
    return server, edges


__all__ = ["round_robin_groups", "EdgeAggregator", "run_fanin_fedavg"]
