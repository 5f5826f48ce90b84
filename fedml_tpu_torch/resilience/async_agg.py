"""FedBuff-style buffered asynchronous aggregation over the distributed
control plane (counterpart of the distributed half of
``fedml_tpu/resilience/async_agg.py``; trajectories equal to the
reference's, bit for bit).

The synchronous control plane (``policy.RoundController``) is a barrier:
a round holds the server until ``target`` reports (or the deadline)
arrive. FedBuff (Nguyen et al., AISTATS 2022) removes it: the server
folds client updates into a buffer *as they arrive*, staleness-weighted,
and applies a server update every K folds (or on a flush deadline).

- **Determinism over arrival order.** The aggregator's flush folds the
  buffered entries through the sorted-key float64 fold
  (:func:`~fedml_tpu_torch.program.aggregation.fold_entries_fp64`), not
  in arrival order, so two runs that buffer the same entries flush
  bitwise-identical results however the reports raced.
- **Staleness weighting** is polynomial: an update born at server
  version ``v0`` and folded at ``v`` carries weight multiplier
  ``(1 + (v - v0)) ** -staleness_decay``.
- **Flush-time re-sync**: a reporting client receives the next model
  when its contribution is *consumed* by a flush, not on report, so each
  client contributes at most one update per flush window.

The aggregation machinery is the program's aggregation leg
(:class:`~fedml_tpu_torch.program.aggregation.BufferedAggregator`,
re-exported here under its historical names); this module keeps the
distributed FSM (:class:`AsyncBufferedFedAvgServer`), which drives its
``RoundProgram``'s host view for every fold, and its driver
:func:`run_async_tcp_fedavg`. The simulation's flags live in
``experiments/common.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

import numpy as np

from fedml_tpu_torch.core.locks import audited_rlock
from fedml_tpu_torch.core.comm.base import (MSG_TYPE_PEER_JOIN,
                                            MSG_TYPE_PEER_LOST)
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.core.managers import ServerManager
from fedml_tpu_torch.compression.wire import (
    WIRE_DELTA_KEY, WIRE_SPEC_KEY, CompressedUpdate)
from fedml_tpu_torch.observability.perfmon import get_perf_monitor
from fedml_tpu_torch.observability.tracing import get_tracer
from fedml_tpu_torch.program.aggregation import (  # noqa: F401 (re-export)
    AggregationPolicy as AsyncAggPolicy, BufferedAggregator, FlushResult,
    staleness_weight)
from fedml_tpu_torch.program.round import RoundProgram
from fedml_tpu_torch.resilience.policy import RetryPolicy, send_with_retry

# the async server speaks the SAME message schema as the synchronous FSM
# (ResilientFedAvgClient is reused unchanged)
from fedml_tpu_torch.resilience.integration import (  # noqa: F401
    MSG_C2S_REPORT, MSG_S2C_SYNC, ResilientFedAvgClient,
    quadratic_trainer)


class AsyncBufferedFedAvgServer(ServerManager):
    """Rank-0 barrier-free FSM: buffered async aggregation over the same
    SYNC/REPORT schema as :class:`ResilientFedAvgServer` (clients run the
    unchanged :class:`ResilientFedAvgClient`).

    Protocol: every alive client gets the v0 model; each report is folded
    into the :class:`BufferedAggregator` with staleness = current version
    minus the version the client trained on; a flush (K clients buffered,
    or the flush deadline) produces server version v+1 and re-syncs
    exactly the flush's contributors with the new model. Fast clients
    cycle in windows of K; stragglers' late reports fold into a later
    window, staleness-discounted. The run ends after ``total_updates``
    flushes.

    Under the oracle settings (no deadline, decay 0, K >= clients) each
    flush collects every alive client exactly once and is bitwise
    ``aggregate_reports`` -- the trajectory equals the synchronous
    server's, which the A/B test pins.
    """

    def __init__(self, args, comm, size, init_params, total_updates,
                 async_policy: AsyncAggPolicy,
                 retry_policy: Optional[RetryPolicy] = None,
                 metrics_logger=None, timer_factory=threading.Timer,
                 pace_controller=None, dp=None, robust=None):
        super().__init__(args, comm, rank=0, size=size)
        self.params = {k: np.asarray(v) for k, v in init_params.items()}
        self.total_updates = int(total_updates)
        self.async_policy = async_policy
        self.retry_policy = retry_policy or RetryPolicy()
        self.metrics_logger = metrics_logger
        # the ONE RoundProgram this server executes: the caller's policy
        # is the program's aggregation leg, and the buffered aggregator
        # plus every fold go through its jax-free host view (the sim
        # engine lowers the same program via compile_sim -- the
        # conformance suite pins the two consumers equal)
        # dp rides the program for the manifest + epsilon accounting
        # (the mechanism is client-side); an armed robust leg swaps the
        # aggregator's flush fold (make_aggregator wires it through --
        # norm_clip is sync-only and rejected there).
        self.program = RoundProgram(aggregation=async_policy, dp=dp,
                                    robust=robust)
        self._host = self.program.host_view()
        self.agg = self._host.make_aggregator()
        self.alive = set(range(1, size))
        self.failed = None
        self.history = []     # params after each flush
        self.flush_log = []   # per-flush sorted contributor ranks
        self.counters = {"reports": 0, "late_reports": 0,
                         "clients_dropped": 0, "clients_rejoined": 0,
                         "retries": 0, "stale_base_reports": 0}
        # compressed-report base retention: version -> the params that
        # version issued. A compressed report born at version v decodes
        # against base v (its delta is relative to the model the client
        # trained on), so a base stays retained while any alive rank's
        # last sync is still <= that version (_rank_version records the
        # version each sync carried). Buffered CompressedUpdate entries
        # hold their OWN base reference -- pruning here can never
        # invalidate an already-accepted report, only force a
        # stale_base drop of a report nobody should still be sending.
        self._bases = {0: self.params}
        self._rank_version = {}
        # closed-loop pace steering (resilience/steering.py): when armed,
        # each flush re-decides buffer_k/flush_deadline from the live
        # arrival rate + windowed latency tail, within operator bounds.
        # None = today's fixed-knob path, bit for bit.
        self.pace = pace_controller
        self._pace_window_t = time.time()   # flush-window open (arrival
        self._pace_window_reports = 0       # rate feed; _advance_lock)
        self._timer_factory = timer_factory
        self._timer = None
        self._last_flush_reason = None
        self._window_t0 = None       # wall time the current flush window
        # opened (start / previous flush): the async analog of the sync
        # server's per-attempt t0, feeding fed_report_latency_seconds so
        # the straggler-tail evidence is transport- AND paradigm-agnostic
        self._prev_flush_t = None    # wall time of the previous flush
        self._pending_flush_dts = []  # flush-to-flush seconds, unconsumed
        # (a list, drained by _report_health: back-to-back flushes on
        # different handler threads must not overwrite each other's
        # sample -- the slow interval is exactly the one pace wants)
        # serializes version turnover/alive/params; all sends happen
        # OUTSIDE it (same discipline as ResilientFedAvgServer: a
        # blocking write to a wedged peer must never pin the lock the
        # fold/flush machinery needs -)
        self._advance_lock = audited_rlock()

    # -- FSM surface -------------------------------------------------------
    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_C2S_REPORT,
                                              self._on_report)
        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,
                                              self._on_peer_lost)
        self.register_message_receive_handler(MSG_TYPE_PEER_JOIN,
                                              self._on_peer_join)

    def start(self):
        with self._advance_lock:
            if get_perf_monitor() is not None:
                self._window_t0 = time.time()
            syncs = [self._make_sync_locked(r) for r in sorted(self.alive)]
            done = self.total_updates <= 0 or not self.alive
        if done:  # finish() = transport STOP wave, never under the lock
            self.finish()
            return
        self._send_syncs(syncs)

    def _make_sync_locked(self, rank):
        m = Message(MSG_S2C_SYNC, 0, rank)
        m.add("params", self.params)
        m.add("round", self.agg.version)
        m.add("attempt", 0)  # schema parity with the synchronous client
        self._rank_version[rank] = self.agg.version
        return m

    def _report_payload_locked(self, msg):
        """Plain reports stay numpy param dicts; a compressed report
        (``cdelta``) becomes a :class:`CompressedUpdate` against the
        base of the version the client trained on (``round`` in the
        report = the version its sync carried). The fold decodes-and-
        folds the delta sparsely (O(k) for topk) at flush time, and
        each distinct base version is densified exactly once per flush
        -- never per report. Returns None when the base was pruned (a
        report no live sync should still produce): the caller drops it
        into ``stale_base_reports``."""
        enc = msg.get(WIRE_DELTA_KEY)
        if enc is None:
            return {k: np.asarray(v) for k, v in msg.get("params").items()}
        born = int(msg.get("round"))
        base = self._bases.get(born)
        if base is None:
            return None
        return CompressedUpdate(enc=enc, spec=str(msg.get(WIRE_SPEC_KEY)),
                                base=base, base_key=born)

    def _prune_bases_locked(self):
        """Drop base versions no alive rank can still report against
        (every alive rank's last sync is newer). The current version is
        always retained -- a rejoin syncs it next."""
        floor = min((self._rank_version.get(r, 0) for r in self.alive),
                    default=self.agg.version)
        for v in [v for v in self._bases
                  if v < floor and v < self.agg.version]:
            del self._bases[v]

    def _send_syncs(self, syncs):
        for m in syncs:
            try:
                send_with_retry(self.com_manager, m, self.retry_policy,
                                counters=self.counters)
            except (ConnectionError, OSError):
                pass  # peer-lost dispatch already updated `alive`

    # -- handler threads ---------------------------------------------------
    def receive_message_batch(self, msg_type, msgs):
        """Batched dispatch from a chunk-draining transport (the event
        loop): a run of reports folds under ONE ``_advance_lock``
        acquisition via :meth:`BufferedAggregator.fold_many`, with the
        flush boundary landing on exactly the report it would land on
        one message at a time -- trajectories are bitwise-identical to
        the per-message path (A/B-pinned). Any other type -- and any
        run while the tracer is armed (per-message ``__trace__``
        contexts must parent each handler) -- takes the default
        per-message loop."""
        if str(msg_type) != MSG_C2S_REPORT or len(msgs) < 2 \
                or get_tracer().enabled:
            super().receive_message_batch(msg_type, msgs)
            return
        self._on_report_batch(msgs)

    def _on_report_batch(self, msgs):
        mon = get_perf_monitor()
        syncs, done = [], False
        with self._advance_lock:
            reports = []
            for msg in msgs:
                if self.failed is not None \
                        or self.agg.version >= self.total_updates:
                    self.counters["late_reports"] += 1
                    logging.info("async server: late report from rank %d "
                                 "(run already finished)",
                                 int(msg.get_sender_id()))
                    continue
                # payload/weight/sender converted ONCE per report --
                # only staleness depends on the flush segment
                payload = self._report_payload_locked(msg)
                if payload is None:
                    self.counters["stale_base_reports"] += 1
                    logging.warning(
                        "async server: compressed report from rank %d "
                        "against pruned base version %d -- dropped",
                        int(msg.get_sender_id()), int(msg.get("round")))
                    continue
                reports.append((
                    int(msg.get_sender_id()), float(msg.get("num_samples")),
                    payload, int(msg.get("round"))))
            i = 0
            while i < len(reports) and not done:
                # staleness (and the latency window origin) is constant
                # within a segment: both only move at a flush, which
                # ends the segment
                version = self.agg.version
                t0 = self._window_t0
                entries = [(r, w, p, max(0, version - born))
                           for r, w, p, born in reports[i:]]
                consumed, _depth = self.agg.fold_many(
                    entries, ready_target=len(self.alive))
                if mon is not None and t0 is not None:
                    # the per-report window-open -> report latency the
                    # unbatched handler observes
                    now = time.time()
                    for _ in range(consumed):
                        mon.observe_report_latency(now - t0)
                i += consumed
                self.counters["reports"] += consumed
                if self.pace is not None:
                    self._pace_window_reports += consumed
                if self.agg.ready(target=len(self.alive)):
                    done, more = self._flush_locked("buffer_k")
                    if not done:
                        # per-message parity: a NON-final flush's syncs
                        # are sent (below, outside the lock); the
                        # finishing flush's syncs are dropped exactly as
                        # _on_report drops them
                        syncs.extend(more)
                else:
                    self._arm_deadline_locked()
                if done and i < len(reports):
                    # run finished mid-batch: the rest are late reports
                    self.counters["late_reports"] += len(reports) - i
        if done:
            # syncs accumulated from earlier (non-final) flushes in this
            # batch still go out -- the per-message path sent them before
            # the finishing report was even folded
            self._send_syncs(syncs)
            self.finish()
            self._report_health()
            return
        self._send_syncs(syncs)
        self._report_health()

    def _on_report(self, msg):
        rank = int(msg.get_sender_id())
        mon = get_perf_monitor()
        if mon is not None:
            with self._advance_lock:  # _window_t0 mutates under the lock
                t0 = self._window_t0
            if t0 is not None:
                # window-open -> report latency: the barrier-free analog
                # of the sync server's straggler-tail distribution (a
                # stale report measures against the CURRENT window --
                # that is its true lateness under flush-time re-sync)
                mon.observe_report_latency(time.time() - t0)
        syncs, done = [], False
        with self._advance_lock:
            if self.failed is not None \
                    or self.agg.version >= self.total_updates:
                self.counters["late_reports"] += 1
                logging.info("async server: late report from rank %d "
                             "(run already finished)", rank)
                return
            born = int(msg.get("round"))
            staleness = max(0, self.agg.version - born)
            payload = self._report_payload_locked(msg)
            if payload is None:
                self.counters["stale_base_reports"] += 1
                logging.warning("async server: compressed report from "
                                "rank %d against pruned base version %d "
                                "-- dropped", rank, born)
                return
            depth = self.agg.fold(rank, float(msg.get("num_samples")),
                                  payload, staleness=staleness)
            self.counters["reports"] += 1
            if self.pace is not None:
                self._pace_window_reports += 1
            if self.agg.ready(target=len(self.alive)):
                done, syncs = self._flush_locked("buffer_k")
            else:
                self._arm_deadline_locked()
                logging.debug("async server: buffered report from rank %d "
                              "(depth %d, staleness %d)", rank, depth,
                              staleness)
        if done:
            self.finish()
            self._report_health()
            return
        self._send_syncs(syncs)
        self._report_health()

    def _on_peer_lost(self, msg):
        rank = int(msg.get_sender_id())
        syncs, done = [], False
        with self._advance_lock:
            if (self.failed is not None
                    or self.agg.version >= self.total_updates):
                # teardown race: clients dropping after the final flush
                # must not mark a completed run failed or flush past
                # total_updates
                logging.info("async server: peer-lost for rank %d after "
                             "run end (ignored)", rank)
                return
            if rank in self.alive:
                self.alive.discard(rank)
                self._rank_version.pop(rank, None)
                self._prune_bases_locked()
                self.counters["clients_dropped"] += 1
                logging.warning("async server: client rank %d lost "
                                "(%d alive)", rank, len(self.alive))
            else:
                logging.info("async server: duplicate peer-lost for rank "
                             "%d (already dropped)", rank)
            if not self.alive:
                self.failed = "every client is lost"
                done = True
            elif (self.agg.depth
                  and self.agg.ready(target=len(self.alive))):
                # the lost peer was the one the buffer was waiting on
                done, syncs = self._flush_locked("peer_lost")
        if done:
            self.finish()
            self._report_health()
            return
        self._send_syncs(syncs)
        self._report_health()

    def _on_peer_join(self, msg):
        """Rejoin protocol: a previously shed/lost rank dialed back in
        (fresh transport HELLO). Re-admit it to the alive set and hand
        it the CURRENT model so it contributes from the next flush
        window -- capacity that comes back must not stay dead for the
        run."""
        rank = int(msg.get_sender_id())
        sync = None
        with self._advance_lock:
            if (self.failed is not None
                    or self.agg.version >= self.total_updates):
                logging.info("async server: rank %d rejoined after run "
                             "end (ignored)", rank)
                return
            if rank in self.alive:
                logging.info("async server: duplicate peer-join for rank "
                             "%d (already alive)", rank)
                return
            self.alive.add(rank)
            self.counters["clients_rejoined"] += 1
            sync = self._make_sync_locked(rank)
            logging.warning("async server: rank %d rejoined (%d alive)",
                            rank, len(self.alive))
        self._send_syncs([sync])
        self._report_health()

    def _report_health(self):
        """Push a health snapshot to the perf monitor's status.json (and
        the update-pace histogram) -- called from handler threads AFTER
        ``_advance_lock`` is released (the status write is file I/O; the
        snapshot itself takes the lock only briefly). No-op when the
        monitor is off."""
        mon = get_perf_monitor()
        if mon is None:
            return
        with self._advance_lock:
            fields = {
                "server": "async-buffered",
                "round": self.agg.version,
                "total_updates": self.total_updates,
                "alive_ranks": sorted(self.alive),
                "buffer_depth": self.agg.depth,
                "last_flush_reason": self._last_flush_reason,
                "reports": self.counters["reports"],
                "clients_dropped": self.counters["clients_dropped"],
                "outcome": ("failed" if self.failed is not None else
                            "complete" if self.agg.version
                            >= self.total_updates else "running"),
            }
            if self.pace is not None:
                fields["pace"] = self.pace.status_fields()
            # the active round definition (steering replaces the
            # aggregation leg mid-run): status.json names the program,
            # not just its throughput
            fields["program"] = self.program.manifest()
            dts, self._pending_flush_dts = self._pending_flush_dts, []
        for dt in dts:
            mon.observe_round(dt)  # flush-to-flush pace: the barrier-free
            # "round" time, feeding the rolling rounds/hour gauge
        rph = mon.rounds_per_hour()
        if rph is not None:
            fields["rounds_per_hour"] = rph
        mon.status_update(force=fields["outcome"] != "running", **fields)

    # -- flush machinery (runs UNDER _advance_lock) ------------------------
    def _flush_locked(self, reason):
        self._cancel_timer_locked()
        self._last_flush_reason = reason
        if get_perf_monitor() is not None:
            now = time.time()
            if self._prev_flush_t is not None:
                self._pending_flush_dts.append(now - self._prev_flush_t)
            self._prev_flush_t = now
            self._window_t0 = now  # next window's report-latency origin
        res = self.agg.flush(reason)
        self.params = res.params
        self._bases[res.version] = res.params
        self._prune_bases_locked()
        self.history.append(dict(res.params))
        self.flush_log.append(tuple(sorted(res.contributors)))
        degraded = res.clients < min(self.async_policy.buffer_k,
                                     max(1, len(self.alive)))
        logging.info("async server: flush %d/%d (%s) over %d client(s), "
                     "max staleness %d%s", res.version, self.total_updates,
                     reason, res.clients, res.max_staleness,
                     " [degraded]" if degraded else "")
        if self.pace is not None:
            # closed-loop steering: one decision per flush, AFTER the
            # degraded call above (degraded is judged by the policy the
            # flush actually ran under). Arrival rate = reports folded
            # across the window just closed; the latency/staleness
            # windows come from the registry histograms.
            self._steer_locked(reason, res.clients)
        if self.metrics_logger is not None:
            rec = {"update": res.version, "async/flush_reason": reason,
                   "async/flush_clients": res.clients,
                   "async/flush_degraded": int(degraded)}
            if self.program.dp is not None:
                # epsilon accounting per server release (each flush is
                # one composition step of the Gaussian mechanism)
                rec.update(self.program.dp.record(res.version))
            rec.update(self.agg.record())
            if self.pace is not None:
                rec.update(self.pace.record())
            self.metrics_logger(rec)
        done = res.version >= self.total_updates
        syncs = []
        if not done:
            for r in sorted(set(res.contributors) & self.alive):
                syncs.append(self._make_sync_locked(r))
        return done, syncs

    def _steer_locked(self, flush_reason, flush_clients):
        """One pace decision (runs UNDER ``_advance_lock``; the registry
        reads take only the registry's own lock). The decided
        buffer_k/flush_deadline replace the frozen policy on both the
        server and the aggregator -- ``ready()`` and the deadline timer
        read the new values from the next fold on."""
        now = time.time()
        window_s = max(now - self._pace_window_t, 1e-6)
        rate = self._pace_window_reports / window_s
        self._pace_window_reports = 0
        self._pace_window_t = now
        dec = self.pace.decide(flush_reason=flush_reason,
                               flush_clients=flush_clients,
                               arrival_rate=rate,
                               obs=self.pace.observe_registry())
        if (dec.buffer_k != self.async_policy.buffer_k
                or dec.flush_deadline_s
                != self.async_policy.flush_deadline_s):
            self.async_policy = dataclasses.replace(
                self.async_policy, buffer_k=dec.buffer_k,
                flush_deadline_s=dec.flush_deadline_s)
            # the program IS the round definition: steering evolves it
            # (pure-data replace) so program/host-view readers stay
            # coherent with the live knobs
            self.program = self.program.replace(
                aggregation=self.async_policy)
            self._host = self.program.host_view()
            self.agg.policy = self.async_policy
            logging.info("async server: pace steering -> buffer_k %d, "
                         "flush deadline %.3fs (%s)", dec.buffer_k,
                         dec.flush_deadline_s, dec.reason)

    def _arm_deadline_locked(self):
        if (self.async_policy.flush_deadline_s <= 0
                or self._timer is not None):
            return
        # the timer carries its version generation: a flush cancels it,
        # but a callback already racing the lock must not flush the NEXT
        # window it wakes up inside (same pattern as RoundController)
        self._timer = self._timer_factory(
            self.async_policy.flush_deadline_s, self._on_flush_deadline,
            args=(self.agg.version,))
        self._timer.daemon = True
        self._timer.start()

    def _cancel_timer_locked(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _on_flush_deadline(self, version):
        syncs, done = [], False
        with self._advance_lock:
            self._timer = None
            if (self.failed is not None or version != self.agg.version
                    or self.agg.depth == 0):
                return  # stale generation / already flushed
            done, syncs = self._flush_locked("deadline")
        if done:
            self.finish()
            self._report_health()
            return
        self._send_syncs(syncs)
        self._report_health()

    def finish(self):
        with self._advance_lock:
            self._cancel_timer_locked()
        super().finish()


def run_async_tcp_fedavg(world_size, total_updates, async_policy,
                         init_params, fault_plan=None, retry_policy=None,
                         trainer=None, metrics_logger=None,
                         host="localhost", port=None, timeout=60.0,
                         join_timeout=90.0, transport="tcp",
                         pace_controller=None, late_clients=(),
                         decode_workers=1, compressor=None, dp=None,
                         robust=None):
    """Drive a multi-rank TCP buffered-async FedAvg scenario in one
    process (the async analog of ``integration.run_tcp_fedavg``; clients
    are the unchanged :class:`ResilientFedAvgClient`). ``transport``
    selects the byte layer ("tcp" | "eventloop") with identical FSMs;
    ``decode_workers`` is the event loop's parallel frame-decode stage.
    ``pace_controller`` arms closed-loop pace steering on the server;
    ``late_clients`` is a list of ``(rank, delay_s)`` re-dials -- a
    fresh unfaulted client that HELLOs back in after its original
    (usually killed/shed) incarnation, exercising the rejoin protocol.
    ``compressor`` (e.g. ``"qsgd"``/``"topk:0.01"``) arms wire
    compression on every client: reports ship compressed deltas and
    the server folds them sparsely against each report's base version
    (``None``/``"none"`` = today's plain reports, byte-identical).
    Returns the server (``.history``, ``.flush_log``, ``.counters``,
    ``.failed``)."""
    import socket

    from fedml_tpu_torch.core.comm.tcp import TcpCommManager
    from fedml_tpu_torch.net.eventloop import EventLoopCommManager

    if port is None:
        s = socket.socket()
        s.bind((host, 0))
        port = s.getsockname()[1]
        s.close()
    trainer = trainer or quadratic_trainer()
    evloop = transport == "eventloop"

    def run_client(rank, delay_s=0.0, faulted=True):
        if delay_s:
            time.sleep(delay_s)
        try:
            if evloop:
                comm = EventLoopCommManager(host, port, rank, world_size,
                                            timeout=timeout)
            else:
                comm = TcpCommManager(host, port, rank, world_size,
                                      timeout=timeout)
        except OSError:
            # a late re-dial can race the run's teardown: nothing to
            # rejoin anymore, which is a legitimate outcome
            logging.warning("rank %d: (re)dial failed -- server gone?",
                            rank)
            return
        if faulted and fault_plan is not None:
            comm = fault_plan.wrap(comm, rank)
        fsm = ResilientFedAvgClient(None, comm, rank, world_size, trainer,
                                    compressor=compressor, dp=dp)
        fsm.run()

    threads = [threading.Thread(target=run_client, args=(r,), daemon=True,
                                name=f"async-client-{r}")
               for r in range(1, world_size)]
    threads += [threading.Thread(target=run_client, args=(r, d, False),
                                 daemon=True, name=f"async-rejoin-{r}")
                for r, d in late_clients]
    for t in threads:
        t.start()
    if evloop:
        comm = EventLoopCommManager(host, port, 0, world_size,
                                    timeout=timeout,
                                    metrics_logger=metrics_logger,
                                    decode_workers=decode_workers)
    else:
        comm = TcpCommManager(host, port, 0, world_size, timeout=timeout,
                              metrics_logger=metrics_logger)
    server = AsyncBufferedFedAvgServer(
        None, comm, world_size, init_params, total_updates, async_policy,
        retry_policy=retry_policy, metrics_logger=metrics_logger,
        pace_controller=pace_controller, dp=dp, robust=robust)
    server.register_message_receive_handlers()
    server.start()
    if server.agg.version < server.total_updates and server.failed is None:
        loop = threading.Thread(target=server.com_manager
                                .handle_receive_message, daemon=True,
                                name="async-server-loop")
        loop.start()
        loop.join(timeout=join_timeout)
        if loop.is_alive():
            server.com_manager.stop_receive_message()
            loop.join(timeout=10.0)
            raise TimeoutError(
                f"async server hung past {join_timeout}s "
                f"(update {server.agg.version}, failed={server.failed})")
    else:
        server.com_manager.stop_receive_message()
    for t in threads:
        t.join(timeout=10.0)
    return server


__all__ = ["AsyncAggPolicy", "BufferedAggregator", "FlushResult",
           "staleness_weight", "AsyncBufferedFedAvgServer",
           "run_async_tcp_fedavg"]
