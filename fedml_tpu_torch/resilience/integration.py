"""Resilience wired into the simulation rounds and the distributed
control plane (counterpart of ``fedml_tpu/resilience/integration.py``;
cohorts, records and trajectories equal to the reference's, bit for bit).

1. **Simulation path** (``FedAvgAPI`` and everything built on it):
   :class:`SimResilience` implements over-selection and simulated
   deadline misses. The round functions weight the aggregate by
   per-client sample counts over the cohort they are given, so
   restricting the cohort to the reporting subset IS the renormalised
   partial aggregate: no aggregation math changes.
2. **Distributed control plane**: :class:`ResilientFedAvgServer` /
   :class:`ResilientFedAvgClient` FSMs run deadline-based partial
   aggregation with retryable sends over any ``BaseCommunicationManager``
   (local, tcp, mqtt), with optional per-round crash recovery.
   :func:`run_tcp_fedavg` drives a whole multi-rank scenario in one
   process. The server places nothing on a device: it folds numpy trees
   through its ``RoundProgram``'s host view, and a trainer that trains
   on the card is the caller's (``trainer(params, round_idx, rank) ->
   (params, n)`` over numpy trees).
3. **Flags**: :func:`add_resilience_args` contributes ``--deadline`` /
   ``--overselect`` / ``--quorum`` / ``--straggler_p`` to the
   FedAvg-family mains.
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
from fedml_tpu_torch.core.managers import ClientManager, ServerManager
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.compression.wire import (
    WIRE_DELTA_KEY, WIRE_SPEC_KEY, CompressedUpdate, ef_step, encode_rng,
    host_compressor)
from fedml_tpu_torch.observability.perfmon import get_perf_monitor
from fedml_tpu_torch.observability.tracing import get_tracer
from fedml_tpu_torch.program.cohort import CohortPolicy, client_sampling
from fedml_tpu_torch.program.cohort import (
    sample_ranks as _program_sample_ranks)
from fedml_tpu_torch.program.round import RoundProgram
from fedml_tpu_torch.resilience.policy import (
    ROUND_DEGRADED, RetryPolicy, RoundController, RoundPolicy,
    send_with_retry)

MSG_S2C_SYNC = "res_sync"        # server -> client: params, round, attempt
MSG_C2S_REPORT = "res_report"    # client -> server: params (plain) OR
# cdelta+compressor (compressed update delta), n, round, attempt

def add_resilience_args(parser):
    parser.add_argument(
        "--deadline", type=float, default=0.0,
        help="per-round report deadline in seconds for the distributed "
             "control plane (0 = wait for every report, the reference's "
             "block-on-slowest behavior). Simulation rounds have no wall "
             "clock; there --straggler_p models deadline misses")
    parser.add_argument(
        "--overselect", type=float, default=0.0,
        help="over-selection eps (Bonawitz MLSys'19 S3): select "
             "ceil((1+eps)*C) clients, aggregate the first C reports")
    parser.add_argument(
        "--quorum", type=float, default=0.5,
        help="minimum reporting fraction of the aggregation target for a "
             "deadline-bounded round to complete (degraded); below it the "
             "round is abandoned and re-run with a fresh cohort")
    parser.add_argument(
        "--straggler_p", type=float, default=0.0,
        help="simulation only: per-(round, client) probability of missing "
             "the report deadline, drawn from a seeded stream keyed on "
             "(seed, round, attempt, client) -- reproducible chaos for the "
             "simulated rounds")
    parser.add_argument(
        "--transport", type=str, default="tcp",
        choices=("tcp", "eventloop"),
        help="distributed control-plane transport: 'tcp' = the thread-"
             "per-client hub (core/comm/tcp.py, honest at tens of "
             "ranks), 'eventloop' = the single-threaded selector event "
             "loop (fedml_tpu_torch.net.eventloop: connection "
             "multiplexing, write-queue backpressure with slow-peer "
             "shedding -- the 10k-connection path). Same FSMs, same wire "
             "schema. On these mains the flag is configuration only "
             "(their rounds are simulated; no transport is opened) -- "
             "pass the value through to the distributed drivers' "
             "transport= parameter (run_tcp_fedavg / "
             "run_async_tcp_fedavg / run_fanin_fedavg) when driving a "
             "real multi-rank run")
    parser.add_argument(
        "--race_audit", type=int, default=0,
        help="arm the concurrency race sanitizer over the control "
             "plane's locks (analysis/runtime.py race_audit): lock-order "
             "cycles and state locks held across a blocking frame write "
             "go to the metrics sink")
    return parser


class SimResilience:
    """Over-selection + seeded deadline-miss simulation for the sim rounds.

    ``sample(round_idx, total, per_round)`` replaces the bare
    ``client_sampling`` call: it over-selects, removes simulated deadline
    misses, keeps the first C survivors ("first C reports win"), and
    re-runs below-quorum rounds with a fresh cohort (attempt folded into
    the sampling seed). Cumulative counters ride every round's metrics
    record so degraded rounds are visible in summary.json.
    """

    def __init__(self, policy: CohortPolicy, straggler_p: float = 0.0,
                 seed: int = 0, miss_fn=None):
        self.policy = policy
        self.straggler_p = float(straggler_p)
        self.seed = int(seed)
        self._miss_fn = miss_fn
        self.rounds_degraded = 0
        self.rounds_abandoned = 0
        self.clients_dropped = 0

    @classmethod
    def from_args(cls, args) -> Optional["SimResilience"]:
        over = float(getattr(args, "overselect", 0.0) or 0.0)
        sp = float(getattr(args, "straggler_p", 0.0) or 0.0)
        if over <= 0 and sp <= 0:
            return None
        policy = CohortPolicy(overselect=over,
                              quorum=float(getattr(args, "quorum", 0.5)))
        return cls(policy, straggler_p=sp,
                   seed=int(getattr(args, "seed", 0)))

    def sample(self, round_idx, client_num_in_total, client_num_per_round):
        """Returns ``(reporting_client_ids, round_record_dict)``."""
        with get_tracer().span("cohort-select", round=int(round_idx)) as sp:
            reporting, record = self._sample(
                round_idx, client_num_in_total, client_num_per_round)
            sp.set(selected=record["res/selected"],
                   reporting=record["res/reporting"],
                   attempts=record["res/attempts"])
            return reporting, record

    def misses_deadline(self, round_idx, attempt, client_id) -> bool:
        if self._miss_fn is not None:
            return bool(self._miss_fn(round_idx, attempt, client_id))
        if self.straggler_p <= 0:
            return False
        # keyed (not sequential) stream: order-independent, reproducible
        rng = np.random.default_rng(
            (self.seed, int(round_idx), int(attempt), int(client_id)))
        return bool(rng.random() < self.straggler_p)

    def _sample(self, round_idx, client_num_in_total, client_num_per_round):
        target = min(client_num_per_round, client_num_in_total)
        for attempt in range(self.policy.max_round_retries + 1):
            selected = client_sampling(
                round_idx, client_num_in_total,
                self.policy.select_count(target, client_num_in_total),
                attempt=attempt)
            # seeded permutation before the "first C win" trim: when
            # select_count reaches the total, client_sampling's
            # all-clients early-return is an ORDERED range, and trimming
            # that untouched would hand the lowest ids every round (a
            # silently biased cohort). The permutation models report
            # arrival order; the final subset is sorted so the packed
            # cohort (and thus the aggregate) has one canonical order.
            perm = np.random.default_rng(
                (self.seed, int(round_idx), int(attempt))).permutation(
                    len(selected))
            selected = [selected[i] for i in perm]
            reporting = [c for c in selected
                         if not self.misses_deadline(round_idx, attempt, c)]
            dropped = len(selected) - len(reporting)
            if len(reporting) >= self.policy.quorum_count(target):
                reporting = sorted(reporting[:target])
                self.clients_dropped += dropped
                degraded = len(reporting) < target
                self.rounds_degraded += int(degraded)
                return reporting, {
                    "res/selected": len(selected),
                    "res/reporting": len(reporting),
                    "res/degraded": int(degraded),
                    "res/attempts": attempt + 1,
                    "res/rounds_degraded": self.rounds_degraded,
                    "res/rounds_abandoned": self.rounds_abandoned,
                    "res/clients_dropped": self.clients_dropped,
                }
            # below quorum: abandon, re-run with a fresh cohort
            self.rounds_abandoned += 1
            self.clients_dropped += dropped
            logging.warning(
                "round %d attempt %d: %d/%d reports is below quorum %d -- "
                "abandoning and re-sampling", round_idx, attempt,
                len(reporting), len(selected),
                self.policy.quorum_count(target))
        raise RuntimeError(
            f"round {round_idx}: abandoned "
            f"{self.policy.max_round_retries + 1} consecutive attempts "
            "(straggler rate incompatible with the quorum; lower --quorum "
            "or --straggler_p)")


class ResilientFedAvgClient(ClientManager):
    """Client FSM: on sync, run local training and report.

    ``local_train_fn(params, round_idx, rank) -> (params, num_samples)``
    over numpy pytrees. A lost server ends the loop cleanly (there is
    nobody left to report to; the default fail-fast would raise out of a
    worker thread instead).

    ``compressor`` (spec string, e.g. ``"qsgd"``/``"topk:0.01"``) arms
    wire compression: the report ships the compressed update DELTA
    (``cdelta`` + ``compressor`` keys) instead of full params. Biased
    compressors (topk/signsgd) carry an error-feedback residual -- a
    plain per-client host accumulator owned by this FSM object (the
    process IS the stable rank, so the accumulator survives shed/rejoin
    cycles of OTHER ranks and re-keyed cohort slots can never
    cross-contaminate it; the process IS the rank);
    unbiased qsgd runs feedback-free (``wire.ef_step``'s rule -- see
    compression/wire.py for the measured instability feedback causes
    there). ``None``/``"none"`` keeps today's plain-``params`` report,
    byte-for-byte.
    """

    def __init__(self, args, comm, rank, size, local_train_fn,
                 retry_policy: Optional[RetryPolicy] = None,
                 compressor=None, dp=None):
        super().__init__(args, comm, rank=rank, size=size)
        self.local_train_fn = local_train_fn
        self.retry_policy = retry_policy
        self.compressor = host_compressor(compressor)
        # client-side DP leg (program/privacy.py DPPolicy or None): the
        # trained params are privatized (clip -> seeded noise on the
        # delta) BEFORE anything touches the report -- the raw update
        # never crosses the trust boundary
        self.dp = dp
        self._ef_residual = None  # zero accumulator until first report
        self.counters = {"retries": 0}

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_S2C_SYNC, self._on_sync)
        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,
                                              self._on_server_lost)

    def _on_sync(self, msg):
        # spans parent under the server's round span: the SYNC message
        # carries its context (__trace__), and the manager dispatch loop
        # made it this thread's current parent before calling us
        tracer = get_tracer()
        rnd = int(msg.get("round"))
        with tracer.span("local-train", rank=self.rank, round=rnd):
            params, n = self.local_train_fn(msg.get("params"), rnd,
                                            self.rank)
        with tracer.span("report", rank=self.rank, round=rnd):
            out = Message(MSG_C2S_REPORT, self.rank, 0)
            attempt = int(msg.get("attempt"))
            if self.dp is not None:
                # DP before codec, always: the mechanism's clip->noise
                # runs on the raw delta, then the (lossy, NON-private)
                # uplink encode sees only the privatized update --
                # fedcheck FL153 pins this order statically
                params = self.dp.privatize_params(
                    msg.get("params"), params, self.rank, rnd, attempt)
            if self.compressor is None:
                out.add("params", params)
            else:
                enc = self._compress_update(msg.get("params"), params,
                                            rnd, attempt)
                out.add(WIRE_DELTA_KEY, enc)
                out.add(WIRE_SPEC_KEY, self.compressor.spec)
            out.add("num_samples", float(n))
            out.add("round", rnd)
            out.add("attempt", attempt)
            tracer.inject(out)  # stitch the server's report handling here
            try:
                if self.retry_policy is not None:
                    send_with_retry(self.com_manager, out,
                                    self.retry_policy,
                                    counters=self.counters)
                else:
                    self.send_message(out)
            except (ConnectionError, OSError):
                # server gone mid-report; the peer-lost path ends the loop
                logging.warning("rank %d: report send failed (server "
                                "lost?)", self.rank)

    def _compress_update(self, base, params, rnd, attempt):
        """EF-compress ``params - base`` for the uplink. The residual is
        this object's own host accumulator (this process IS the stable
        rank -- no device traffic in the report hot path); the encode
        rng is keyed (rank, round, attempt) so two runs over the same
        schedule encode bit-identically."""
        base = {k: np.asarray(v, np.float32) for k, v in base.items()}
        delta = {k: np.asarray(params[k], np.float32) - base[k]
                 for k in base}
        enc, _decoded, self._ef_residual = ef_step(
            self.compressor, delta, self._ef_residual,
            encode_rng((self.rank, rnd, attempt)))
        return enc

    def _on_server_lost(self, msg):
        # sender is the LOST rank: only rank 0 dying concerns a client.
        # On the local transport a killed sibling's PEER_LOST fans out to
        # every mailbox -- that must not collapse the healthy federation.
        if int(msg.get_sender_id()) != 0:
            logging.info("rank %d: sibling rank %s lost (ignored)",
                         self.rank, msg.get_sender_id())
            return
        logging.warning("rank %d: server lost -- stopping", self.rank)
        self.finish()


class ResilientFedAvgServer(ServerManager):
    """Rank-0 FSM: over-selection, report deadline, partial aggregation,
    abandoned-round re-runs, and per-round crash recovery.

    Args:
      init_params: initial global weights (numpy pytree).
      rounds: total federated rounds.
      round_policy / retry_policy: see ``resilience.policy``.
      client_ns: optional ``{rank: num_samples}`` override for weighting
        (otherwise reports carry their own ``num_samples``).
      cohort_target: aggregation target C (default: all clients).
      cohort_override: ``fn(round_idx, attempt) -> [ranks]`` forcing the
        cohort (the A/B harness replays a faulted run's reporting subsets).
      recovery: ``RoundRecovery`` for per-round snapshots + resume.
      metrics_logger: per-round records (``res/*`` counters; wire bytes
        attach via the transport's ``count_wire`` feed when wired).
    """

    def __init__(self, args, comm, size, init_params, rounds,
                 round_policy: RoundPolicy,
                 retry_policy: Optional[RetryPolicy] = None,
                 cohort_target: Optional[int] = None, cohort_override=None,
                 recovery=None, metrics_logger=None, pace_controller=None,
                 dp=None, robust=None):
        super().__init__(args, comm, rank=0, size=size)
        self.params = {k: np.asarray(v) for k, v in init_params.items()}
        self.rounds = int(rounds)
        # the ONE RoundProgram this server executes: the caller's policy
        # is the program's cohort leg, and every cohort draw / report
        # fold goes through its jax-free host view (the sim engine
        # lowers the same program via compile_sim -- the conformance
        # suite pins the two consumers equal). round_policy stays the
        # live steered attribute; _steer_locked re-replaces the program.
        # dp rides the program for the manifest + epsilon accounting
        # (the mechanism itself is client-side); robust swaps the fold.
        self.program = RoundProgram(cohort=round_policy, dp=dp,
                                    robust=robust)
        self._host = self.program.host_view()
        self.round_policy = round_policy
        self.retry_policy = retry_policy or RetryPolicy()
        self.cohort_target = cohort_target
        self.cohort_override = cohort_override
        self.recovery = recovery
        self.metrics_logger = metrics_logger
        self.alive = set(range(1, size))
        self.round_idx = 0
        self.attempt = 0
        self.failed = None  # set to a reason string on unrecoverable stop
        self.history = []          # per-round aggregated params
        self.reporting_log = []    # per-round sorted reporting ranks
        self.counters = {"rounds_degraded": 0, "rounds_abandoned": 0,
                         "clients_dropped": 0, "clients_rejoined": 0,
                         "clients_resumed": 0, "retries": 0, "resumes": 0}
        # closed-loop pace steering (resilience/steering.py): when armed,
        # every round decision re-derives deadline_s/overselect from the
        # windowed report-latency tail + observed loss fraction, within
        # operator bounds. None = today's fixed-policy path, bit for bit.
        self.pace = pace_controller
        self._last_selected = 0  # last cohort size (over-selection incl.)
        self._last_target = 0    # last aggregation target C -- the loss
        # denominator the controller tracks (reports short of C is the
        # shortfall over-selection exists to cover; selected/C would
        # read surplus over-selection itself as loss and ratchet)
        self._controller = RoundController(
            round_policy, self._on_round_complete, self._on_round_abandoned)
        # one detached span per round attempt (begun at _open_round on the
        # turnover thread, ended at the decision on a serve/timer thread);
        # its context rides every SYNC so client spans stitch under it
        self._round_span = None
        # perf-monitor state (all guarded by _advance_lock; written only
        # while a monitor is armed): attempt-open wall time for the
        # report-latency/straggler-tail histogram, last decision outcome
        # + counts for status.json, and the decision's unconsumed round
        # duration for the rounds/hour pace gauge
        self._round_t0 = None
        self._last_outcome = None
        self._outcomes = {"complete": 0, "degraded": 0, "abandoned": 0}
        self._pending_round_dt = None
        # serializes round turnover and guards `alive`. Sync sends happen
        # OUTSIDE this lock (_open_round returns them, _send_syncs
        # delivers) so a blocking write to a wedged peer can never pin
        # the deadline/abandon machinery. RLock as defense in depth: a
        # failed unlocked send dispatches PEER_LOST synchronously on the
        # sending thread, and that chain may re-enter a turnover callback
        # (depth bounded by max_round_retries -- the abandon path is the
        # only recursive one, since zero reports can never meet quorum).
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
        """Kick off round 0 (or the checkpointed round on resume).

        The restore runs UNDER ``_advance_lock``: ``run_tcp_fedavg``
        starts client threads before the server FSM, so a racing send
        failure can dispatch PEER_LOST (and drive a turnover) while the
        restore is still rewriting ``params``/``round_idx`` -- writing
        them unlocked races those handler threads."""
        syncs, span = [], None
        with self._advance_lock:
            if self.recovery is not None:
                saved = self.recovery.restore_latest()
                if saved is not None:
                    self.params = {k: np.asarray(v)
                                   for k, v in saved["global_state"].items()}
                    self.round_idx = int(saved["round_idx"])
                    self.counters["resumes"] += 1
            done = self.round_idx >= self.rounds
            if not done:
                syncs = self._open_round()
                span = self._round_span
            done = done or self.failed is not None
        # finish() OUTSIDE the lock: it reaches the transport's STOP wave
        # (blocking per-peer socket writes) and must not pin the turnover
        # lock every handler needs
        if done:
            self.finish()
            return
        self._send_syncs(syncs, span)

    def _open_round(self):
        """Open the next round attempt: sample the cohort and arm the
        controller. Runs UNDER ``_advance_lock``; returns the sync
        messages for :meth:`_send_syncs` to deliver OUTSIDE the lock --
        a blocking ``sendall`` to a wedged-but-alive client (full send
        buffer, keepalives still ACKed) must never pin the lock the
        deadline/abandon machinery needs."""
        alive = sorted(self.alive)
        if not alive:
            self._fail("every client is lost")
            return []
        target = min(self.cohort_target or len(alive), len(alive))
        if self.cohort_override is not None:
            cohort = list(self.cohort_override(self.round_idx, self.attempt))
            target = min(target, len(cohort))
        else:
            cohort = self._host.sample_ranks(
                self.round_idx, self.attempt, alive,
                self._host.select_count(target, len(alive)))
        self._last_selected = len(cohort)
        self._last_target = target
        self._controller.begin(self.round_idx, self.attempt, cohort, target)
        self._round_t0 = (time.time()
                          if get_perf_monitor() is not None else None)
        tracer = get_tracer()
        self._round_span = tracer.start_span(
            "round", root=True, rank=0, round=self.round_idx,
            attempt=self.attempt, cohort=len(cohort), target=target)
        syncs = []
        for r in cohort:
            m = Message(MSG_S2C_SYNC, 0, r)
            m.add("params", self.params)
            m.add("round", self.round_idx)
            m.add("attempt", self.attempt)
            tracer.inject(m, self._round_span.context)
            syncs.append((r, m))
        return syncs

    def _send_syncs(self, syncs, span=None):
        """Deliver the opened round's syncs (no locks held). A send that
        outlives its round attempt (deadline fired mid-delivery and a new
        attempt opened) is harmless: the message carries its (round,
        attempt) tag and stale reports land in the late counter. ``span``
        is the caller's under-lock snapshot of the round span
        (``self._round_span`` mutates under ``_advance_lock``; reading it
        here would race the turnover threads)."""
        if not syncs:
            return
        with get_tracer().span(
                "broadcast", parent=None if span is None else span.context,
                n=len(syncs)):
            for _r, m in syncs:
                try:
                    send_with_retry(self.com_manager, m, self.retry_policy,
                                    counters=self.counters)
                except (ConnectionError, OSError):
                    pass  # peer-lost dispatch already told the controller

    def _on_report(self, msg):
        mon = get_perf_monitor()
        if mon is not None:
            with self._advance_lock:  # _round_t0 mutates under the lock
                # only reports for the CURRENTLY open (round, attempt)
                # are measured against its t0: a straggler whose round
                # already turned over would otherwise be clocked against
                # the NEW round's open and land in a LOW bucket --
                # inverting the straggler tail for exactly the events it
                # exists to capture (those land in the late counter)
                t0 = (self._round_t0
                      if (int(msg.get("round")) == self.round_idx
                          and int(msg.get("attempt")) == self.attempt)
                      else None)
            if t0 is not None:
                # round-open -> report latency: the distribution whose
                # upper buckets are the straggler tail (observed outside
                # the lock -- the registry has its own)
                mon.observe_report_latency(time.time() - t0)
        # parents under the client's "report" span (context injected into
        # the report message, adopted by the manager dispatch loop)
        with get_tracer().span("report-recv",
                               rank=int(msg.get_sender_id()),
                               round=int(msg.get("round"))):
            self._controller.report(
                msg.get("round"), msg.get("attempt"), msg.get_sender_id(),
                msg.get("num_samples"), self._report_payload(msg))

    def _report_payload(self, msg):
        """Plain reports stay numpy param dicts; a compressed report
        (``cdelta``) becomes a :class:`CompressedUpdate` against the
        OPEN round's params -- read under ``_advance_lock``, which also
        serializes round turnover, so whenever the controller accepts
        the report (round/attempt match) the captured base IS the model
        that round broadcast; a mismatched base only ever pairs with a
        report the controller rejects as late. The fold decodes-and-
        folds the delta sparsely (O(k) for topk) at the turnover -- the
        hub relayed the payload on a header peek and nothing densified
        it per report."""
        enc = msg.get(WIRE_DELTA_KEY)
        if enc is None:
            return {k: np.asarray(v) for k, v in msg.get("params").items()}
        with self._advance_lock:
            base = self.params
        return CompressedUpdate(enc=enc, spec=str(msg.get(WIRE_SPEC_KEY)),
                                base=base, base_key=0)

    def _on_peer_lost(self, msg):
        rank = int(msg.get_sender_id())
        # alive mutates under _advance_lock: _open_round reads it
        # (sorted) on the turnover thread, and mutating a set
        # mid-iteration raises. controller.peer_lost runs OUTSIDE the
        # lock: it can fire a turnover callback, and those must never
        # inherit a held _advance_lock (their _send_syncs runs unlocked
        # by design -- see _open_round).
        with self._advance_lock:
            if rank in self.alive:
                self.alive.discard(rank)
                self.counters["clients_dropped"] += 1
                logging.warning("server: client rank %d lost "
                                "(%d alive)", rank, len(self.alive))
        self._controller.peer_lost(rank)

    # -- round turnover (serve/timer threads) ------------------------------
    def _on_round_complete(self, reports, outcome):
        syncs, span = [], None
        tracer = get_tracer()
        with self._advance_lock:
            rspan = self._round_span
            with tracer.span(
                    "aggregate",
                    parent=None if rspan is None else rspan.context,
                    reports=len(reports)):
                # base = the params this round broadcast (read before
                # the assignment rebinds them): the robust norm-clip
                # fold clips each report's delta against exactly the
                # model the cohort trained on
                self.params, _total = self._host.fold_reports(
                    reports, base=self.params)
            if rspan is not None:
                rspan.set(outcome=outcome, reports=len(reports)).end()
            self.history.append(dict(self.params))
            self.reporting_log.append(sorted(reports))
            degraded = outcome == ROUND_DEGRADED
            self.counters["rounds_degraded"] += int(degraded)
            self._last_outcome = outcome
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
            if self._round_t0 is not None:
                self._pending_round_dt = time.time() - self._round_t0
            self._log_round(len(reports), degraded)
            if self.recovery is not None:
                done = self.round_idx + 1 >= self.rounds
                self.recovery.maybe_save(self.round_idx + 1, self.params,
                                         last=done)
            self.round_idx += 1
            self.attempt = 0
            done = self.round_idx >= self.rounds
            if not done:
                if self.pace is not None:
                    self._steer_locked(outcome, len(reports))
                syncs = self._open_round()
                span = self._round_span
            done = done or self.failed is not None
        if done:                    # see start(): no STOP wave under the
            self.finish()           # turnover lock
            self._report_health()
            return
        self._send_syncs(syncs, span)
        self._report_health()

    def _on_round_abandoned(self, reports):
        syncs, span = [], None
        with self._advance_lock:
            rspan = self._round_span
            if rspan is not None:
                rspan.set(outcome="abandoned", reports=len(reports)).end()
            self.counters["rounds_abandoned"] += 1
            self._last_outcome = "abandoned"
            self._outcomes["abandoned"] += 1
            logging.warning("round %d attempt %d abandoned with %d reports",
                            self.round_idx, self.attempt, len(reports))
            self.attempt += 1
            if self.attempt > self.round_policy.max_round_retries:
                self._fail(f"round {self.round_idx} abandoned "
                           f"{self.attempt} times")
            else:
                if self.pace is not None:
                    # abandon-backoff: the re-run attempt opens with a
                    # longer deadline, not the one that just starved
                    self._steer_locked("abandoned", len(reports))
                syncs = self._open_round()
                span = self._round_span
            done = self.failed is not None
        if done:  # see start(): finish() outside the lock
            self.finish()
            self._report_health()
            return
        self._send_syncs(syncs, span)
        self._report_health()

    def _steer_locked(self, outcome, n_reports):
        """One pace decision per round turnover (runs UNDER
        ``_advance_lock``). The decided deadline/overselect replace the
        frozen ``RoundPolicy`` on both the server and the controller, so
        the NEXT ``begin()`` arms the steered deadline."""
        dec = self.pace.decide(outcome=outcome,
                               selected=self._last_target,
                               reporting=min(n_reports, self._last_target),
                               obs=self.pace.observe_registry())
        if (dec.deadline_s != self.round_policy.deadline_s
                or dec.overselect != self.round_policy.overselect):
            self.round_policy = dataclasses.replace(
                self.round_policy, deadline_s=dec.deadline_s,
                overselect=dec.overselect)
            # the program IS the round definition: steering evolves it
            # (pure-data replace) so host-view cohort math reads the
            # live knobs, not the ones the server was constructed with
            self.program = self.program.replace(cohort=self.round_policy)
            self._host = self.program.host_view()
            self._controller.policy = self.round_policy
            logging.info("server: pace steering -> deadline %.3fs, "
                         "overselect %.3f (%s)", dec.deadline_s,
                         dec.overselect, dec.reason)

    def _on_peer_join(self, msg):
        """Rejoin protocol: a previously shed/lost rank's fresh HELLO
        was accepted by the transport -- re-admit it to the alive set so
        the next ``_open_round`` can sample it, AND resume it into the
        round in flight: the rank is admitted to the open attempt's
        cohort (:meth:`RoundController.admit`) and handed the current
        model with the round's (round, attempt) context, so it
        contributes *this* round instead of idling to the next.
        Re-admission shipped first (the alive-set half); this is the
        work-resumption half -- ``clients_resumed`` counts the ranks
        that actually got mid-round work. The resume never extends the
        round: the target is unchanged, the deadline stays armed, and a
        resumed rank that stays silent costs nothing over-selection
        would not already cover."""
        rank = int(msg.get_sender_id())
        sync = None
        with self._advance_lock:
            if self.failed is not None or rank in self.alive:
                logging.info("server: peer-join for rank %d ignored "
                             "(already alive or run failed)", rank)
                return
            self.alive.add(rank)
            self.counters["clients_rejoined"] += 1
            if self._controller.admit(self.round_idx, self.attempt, rank):
                self.counters["clients_resumed"] += 1
                m = Message(MSG_S2C_SYNC, 0, rank)
                m.add("params", self.params)
                m.add("round", self.round_idx)
                m.add("attempt", self.attempt)
                rspan = self._round_span
                get_tracer().inject(
                    m, None if rspan is None else rspan.context)
                sync = m
        if sync is not None:
            logging.warning("server: rank %d rejoined -- resumed into "
                            "round %d attempt %d", rank,
                            int(sync.get("round")), int(sync.get("attempt")))
            # delivered OUTSIDE the lock, same discipline as _send_syncs
            try:
                send_with_retry(self.com_manager, sync, self.retry_policy,
                                counters=self.counters)
            except (ConnectionError, OSError):
                pass  # peer-lost dispatch already told the controller
        else:
            logging.warning("server: rank %d rejoined -- eligible from "
                            "the next cohort", rank)
        self._report_health()

    def _report_health(self):
        """Status.json + round-pace snapshot for the perf monitor --
        called from the turnover/serve threads AFTER ``_advance_lock``
        is released (the status write is file I/O; the snapshot takes
        the lock only briefly). No-op when the monitor is off."""
        mon = get_perf_monitor()
        if mon is None:
            return
        with self._advance_lock:
            fields = {
                "server": "resilient",
                "round": self.round_idx,
                "attempt": self.attempt,
                "rounds_total": self.rounds,
                "last_outcome": ("failed" if self.failed is not None
                                 else self._last_outcome),
                "outcome_counts": dict(self._outcomes),
                "alive_ranks": sorted(self.alive),
                "clients_dropped": self.counters["clients_dropped"],
                "clients_resumed": self.counters["clients_resumed"],
            }
            if self.pace is not None:
                fields["pace"] = self.pace.status_fields()
            # the active round definition (steering replaces it mid-run):
            # an operator reading status.json sees WHICH program the
            # fleet is executing, not just how fast
            fields["program"] = self.program.manifest()
            dt, self._pending_round_dt = self._pending_round_dt, None
        if dt is not None:
            mon.observe_round(dt)
        rph = mon.rounds_per_hour()
        if rph is not None:
            # the one pace metric both paradigms report (async feeds it
            # flush-to-flush): steered-vs-fixed comparisons read this
            fields["rounds_per_hour"] = rph
        mon.status_update(force=True, **fields)  # decision-rate writes:
        # one per round attempt, never a hot path

    def _log_round(self, n_reports, degraded):
        if self.metrics_logger is None:
            return
        rec = {"round": self.round_idx, "res/reports": n_reports,
               "res/degraded": int(degraded)}
        if self.program.dp is not None:
            # epsilon accounting rides every round record: the round
            # being logged is the (round_idx + 1)-th completed release
            rec.update(self.program.dp.record(self.round_idx + 1))
        rec.update({f"res/{k}": v for k, v in self.counters.items()})
        rec.update({f"res/{k}": v
                    for k, v in self._controller.counters.items()})
        if self.pace is not None:
            rec.update(self.pace.record())
        self.metrics_logger(rec)

    def _fail(self, reason):
        """Mark the run failed and stop the controller. Runs UNDER
        ``_advance_lock``; the lock-exiting caller performs the actual
        ``finish()`` (transport STOP wave = blocking writes) outside."""
        self.failed = reason
        if self._round_span is not None:
            # an attempt left open by an unrecoverable stop still records
            # (Span.end is idempotent: a decided round already ended it)
            self._round_span.set(outcome="failed").end()
        logging.error("resilient server giving up: %s", reason)
        self._controller.cancel()

    def finish(self):
        self._controller.cancel()
        super().finish()


def _sample_ranks(round_idx, attempt, ranks, k):
    """Seeded-by-(round, attempt) cohort over explicit rank ids -- the
    program's :func:`~fedml_tpu_torch.program.cohort.sample_ranks` under its
    historical name (kept for callers/tests that import it from here).
    Shares the :func:`~fedml_tpu_torch.program.cohort.attempt_seed` fold with
    ``client_sampling`` so both paths draw agreeing cohorts for the same
    (round, attempt)."""
    return _program_sample_ranks(round_idx, attempt, ranks, k)


def quadratic_trainer(lr=0.25):
    """Deterministic 'local training' oracle for control-plane scenarios:
    one gradient-descent step on ``0.5 * ||w - t_rank||^2`` where the
    target is a fixed function of the rank. Real GD arithmetic, bitwise
    reproducible, rank-distinguishable -- the chaos smoke's A/B oracle."""

    def train(params, round_idx, rank):
        out = {}
        for k in sorted(params):
            w = np.asarray(params[k], np.float32)
            target = np.full_like(w, np.float32(rank))
            out[k] = w + np.float32(lr) * (target - w)
        return out, float(10 * rank)

    return train


def run_tcp_fedavg(world_size, rounds, round_policy, init_params,
                   fault_plan=None, retry_policy=None, cohort_target=None,
                   cohort_override=None, trainer=None, recovery=None,
                   metrics_logger=None, host="localhost", port=None,
                   timeout=60.0, join_timeout=90.0, transport="tcp",
                   pace_controller=None, late_clients=(),
                   decode_workers=1, compressor=None, dp=None,
                   robust=None):
    """Drive a full multi-rank TCP FedAvg scenario in one process.

    Clients run in daemon threads (rank r wrapped by ``fault_plan`` when
    given); the server FSM runs its receive loop on the caller thread.
    ``transport`` selects the byte layer (``--transport``: "tcp" =
    thread-per-client hub, "eventloop" = selector loop) -- the FSMs are
    identical either way; ``decode_workers`` is the event loop's
    parallel frame-decode stage (1 = inline decode). ``pace_controller`` arms closed-loop pace
    steering on the server (``--pace_steering``); ``late_clients`` is a
    list of ``(rank, delay_s)`` re-dials exercising the rejoin protocol
    (a fresh unfaulted client HELLOing back in after its original
    incarnation was killed or shed). ``compressor`` (e.g. ``"qsgd"``)
    arms wire compression on every client: reports ship compressed
    deltas (error feedback on the biased compressors) and the server
    folds them sparsely against the round's base (``None``/``"none"`` =
    today's plain reports, byte-identical). ``dp`` (a
    ``program.DPPolicy``) privatizes every client's update delta
    (clip -> per-(rank, round, attempt) seeded noise) before the uplink
    encode, and rides the server's program for manifest + epsilon
    accounting; ``robust`` (a ``program.RobustPolicy``) swaps the
    server fold for the leg's robust variant.
    Returns the server (``.history``, ``.reporting_log``, ``.counters``,
    ``.failed``).
    """
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
            # a late re-dial can race teardown: nothing left to rejoin
            logging.warning("rank %d: (re)dial failed -- server gone?",
                            rank)
            return
        if faulted and fault_plan is not None:
            comm = fault_plan.wrap(comm, rank)
        fsm = ResilientFedAvgClient(None, comm, rank, world_size, trainer,
                                    compressor=compressor, dp=dp)
        fsm.run()

    threads = [threading.Thread(target=run_client, args=(r,), daemon=True,
                                name=f"res-client-{r}")
               for r in range(1, world_size)]
    threads += [threading.Thread(target=run_client, args=(r, d, False),
                                 daemon=True, name=f"res-rejoin-{r}")
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
    server = ResilientFedAvgServer(
        None, comm, world_size, init_params, rounds, round_policy,
        retry_policy=retry_policy, cohort_target=cohort_target,
        cohort_override=cohort_override, recovery=recovery,
        metrics_logger=metrics_logger, pace_controller=pace_controller,
        dp=dp, robust=robust)
    server.register_message_receive_handlers()
    server.start()
    if server.round_idx < server.rounds and server.failed is None:
        loop = threading.Thread(target=server.com_manager
                                .handle_receive_message, daemon=True,
                                name="res-server-loop")
        loop.start()
        loop.join(timeout=join_timeout)
        if loop.is_alive():
            server.com_manager.stop_receive_message()
            loop.join(timeout=10.0)
            raise TimeoutError(
                f"resilient server hung past {join_timeout}s "
                f"(round {server.round_idx}, failed={server.failed})")
    else:
        # resume found nothing to do (or start() already failed):
        # release the connected clients
        server.com_manager.stop_receive_message()
    for t in threads:
        t.join(timeout=10.0)
    return server


__all__ = ["MSG_S2C_SYNC", "MSG_C2S_REPORT", "add_resilience_args",
           "SimResilience", "ResilientFedAvgClient", "ResilientFedAvgServer",
           "quadratic_trainer", "run_tcp_fedavg"]
