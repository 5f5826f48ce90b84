"""FedAvg round loop (counterpart of ``fedml_tpu/algorithms/fedavg.py``)
on one device, along every single-device path of the reference:

- ``--bucket_edges`` or ``--async_agg``: the cohort's raw shards stream
  through ``BucketedStreamRunner`` chunk by chunk, folded on the host in
  fp64, synchronously, or under ``--async_agg`` through the program's
  ``BufferedAggregator`` (built once, its version and counters living
  across rounds; ``async/*`` rides every round record);
- shards resident on the device (when they fit ``device_data_cap_gb``
  and ``device_resident`` is not off): a round is a seeded cohort draw,
  an index schedule and one of ``--wave_mode`` 1 (size-sorted waves,
  ``WaveRunner``), 0 (the flat round), 2 (vmap lanes) or 3 (packed
  lanes, falling back to 2 for model families without a packed
  lowering);
- otherwise the host-packed round: the cohort's batches are packed on
  the host and uploaded each round (``RoundProgram.compile_sim``).

The API builds its one ``RoundProgram`` from the arguments, as the
reference does. Every path draws its cohort through
:meth:`FedAvgAPI._sample_cohort`: the seeded draw, or under
``--overselect``/``--straggler_p`` the reporting subset of
``SimResilience`` (steered by ``--pace_steering``), whose ``res/*`` and
``pace/*`` fields ride the round's record.

``--compressor`` (``compressor=``) compresses each client's update with
error feedback: through the host-packed compressed round (residency is
bypassed), or on the bucketed path as streaming error feedback, where
``none`` runs the plain chunk program. One ``ResidualStore`` sized by
``device_data_cap_gb`` carries the residuals by client id for both
(they are not checkpointed, as in the reference), and every record
carries ``bytes_on_wire`` and ``compression_ratio``.

``mesh=`` (a ``clients`` mesh, ``parallel/mesh.py``) runs the round over
the mesh's ranks, every rank the same loop on its own device: with
``--wave_mode`` 2 or 3 the resident rows are sharded in blocks over the
ranks and trained as lanes (``ShardedLaneRunner``), otherwise each rank
trains its block of the host-packed cohort (``make_sharded_round``).
The per-client metrics are gathered to every rank
(``multihost.gather_metrics``). A compressor or the bucketed path on a
mesh is refused, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import numpy as np
import torch

from fedml_tpu_torch.compression.compressors import get_compressor
from fedml_tpu_torch.compression.integration import (
    ResidualStore, compressed_payload_nbytes, raw_payload_nbytes)
from fedml_tpu_torch.core.trainer import TrainSpec
from fedml_tpu_torch.observability.perfmon import get_perf_monitor
from fedml_tpu_torch.observability.tracing import get_tracer
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig, LaneRunner,
                                             ShardedLaneRunner, WaveRunner,
                                             fold_seed, make_eval_fn,
                                             make_indexed_sim_round)
from fedml_tpu_torch.parallel.multihost import (gather_metrics,
                                                global_cohort)
from fedml_tpu_torch.parallel.packing import (_steps_for, pack_cohort,
                                              pack_eval, pack_schedule,
                                              packing_backend,
                                              parse_bucket_edges,
                                              stack_clients)
from fedml_tpu_torch.program.aggregation import AggregationPolicy
from fedml_tpu_torch.program.cohort import client_sampling
from fedml_tpu_torch.program.round import RoundProgram
from fedml_tpu_torch.resilience.integration import SimResilience
from fedml_tpu_torch.resilience.steering import PaceController
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.profiling import end_of_round_sync, off_round_work
from fedml_tpu_torch.utils.torch_import import gate_split, reference_tree

#: ``local-train`` span mode of each resident ``wave_mode``
_MODES = {0: "flat", 1: "waves", 2: "lanes", 3: "mxu-lanes"}


class FedAvgAPI:
    """Round-loop orchestrator.

    Args:
      dataset: the 8-tuple contract ``[train_num, test_num, train_global,
        test_global, train_local_num_dict, train_local_dict,
        test_local_dict, class_num]`` with numpy shards (NHWC images, flat
        features or ``[n, T]`` token ids).
      spec: a :class:`TrainSpec` (``stacked_loss_fn`` for every path, a
        ``lane_loss_builder`` for packed lanes).
      args: the reference's hyperparameter namespace (``lr``, ``wd``,
        ``batch_size``, ``epochs``, ``client_chunk``, ``wave_mode``,
        ``device_resident``, ``device_data_cap_gb``, ``device_dtype``,
        ``bucket_edges``, ``ci``, ...).
      device: ``None`` runs on the GPU and raises without one; pass
        ``"cpu"`` to run on the CPU. On a mesh it defaults to the mesh's.
      mesh: a ``clients`` :class:`~fedml_tpu_torch.parallel.mesh.Mesh`
        for the sharded rounds.
      payload_fn / server_fn / server_state: aggregator hooks; payload_fn
        takes client- or lane-stacked local state.
      compressor: a spec string or compressor (default
        ``args.compressor``).
    """

    def __init__(self, dataset, spec: TrainSpec, args, mesh=None,
                 payload_fn=None, server_fn=None, server_state=None,
                 metrics_logger=None, device=None, compressor=None):
        (self.train_data_num, self.test_data_num, self.train_data_global,
         self.test_data_global, self.train_data_local_num_dict,
         self.train_data_local_dict, self.test_data_local_dict,
         self.class_num) = dataset
        self.spec, self.args, self.mesh = spec, args, mesh
        device = device if device is not None else getattr(args, "device",
                                                           None)
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"device {self.device} is not the mesh's "
                             f"{mesh.device}")
        self.metrics_logger = metrics_logger or (
            lambda d: logging.info("%s", d))

        self.cfg = cfg = ClientUpdateConfig(
            optimizer=getattr(args, "client_optimizer", "sgd"),
            lr=args.lr,
            weight_decay=getattr(args, "wd", 0.0),
            momentum=getattr(args, "momentum", 0.0),
            grad_clip=getattr(args, "grad_clip", None))
        self.compressor = get_compressor(
            compressor if compressor is not None
            else getattr(args, "compressor", None))
        if self.compressor is not None and mesh is not None:
            raise ValueError(
                "compressor= applies to the single-chip simulation and the "
                "distributed control-plane paths; mesh rounds aggregate "
                "over collectives, where the wire bottleneck being "
                "compressed does not exist")
        async_policy = AggregationPolicy.from_args(args)
        use_buckets = (getattr(args, "bucket_edges", None) is not None
                       or async_policy is not None)
        if use_buckets and mesh is not None:
            raise ValueError(
                "--bucket_edges/--async_agg run the single-chip bucketed "
                "streaming path; it does not compose with --mesh (the "
                "sharded-lane path owns multi-chip)")
        if (use_buckets and self.compressor is not None
                and self.compressor.name == "none"):
            # the identity has no wire transform to stream: the plain
            # chunk program, so --compressor none is no flag at all
            logging.info("bucketed streaming: --compressor none is the "
                         "identity -- running the plain chunk program")
            self.compressor = None
        # the one RoundProgram this API executes, its codec leg what runs
        self.program = RoundProgram.from_args(
            args, codec=(self.compressor if self.compressor is not None
                         else "none"),
            client_update=(spec, cfg))
        self.round_fn = self.program.compile_sim(spec, cfg, payload_fn,
                                                 server_fn, mesh=mesh,
                                                 compressed=False)
        self.compressed_round_fn = None
        if self.compressor is not None and not use_buckets:
            self.compressed_round_fn = self.program.compile_sim(
                spec, cfg, payload_fn, server_fn, compressed=True,
                compressor=self.compressor)
        self.eval_fn = make_eval_fn(spec)
        self.bucket_runner = None
        self.async_agg = None
        self._async_window = 4
        if use_buckets:
            self._init_bucketed(spec, args, payload_fn, server_fn)
            if async_policy is not None:
                self.async_agg = self.program.host_view().make_aggregator()
                self._async_window = async_policy.async_window

        self.device_data = None
        self.packed_lane_runner = None
        self.sharded_lane_runner = None
        resident = str(getattr(args, "device_resident", "auto")).lower()
        mode = int(getattr(args, "wave_mode", 1))
        chunk = getattr(args, "client_chunk", 8) or 8
        # compressed rounds thread residuals, which only the host-packed
        # round does: residency is bypassed under a compressor. On a mesh
        # only the lanes read resident rows
        stacked = (self._stack_if_fits(args)
                   if resident not in ("0", "false", "none", "")
                   and self.bucket_runner is None
                   and self.compressor is None
                   and (mesh is None or mode in (2, 3)) else None)
        if stacked is not None and mesh is not None:
            # the rows sharded in blocks over the ranks, each rank
            # training the cohort members it owns as lanes
            self.device_data = global_cohort(
                mesh, {"x": stacked["x"], "y": stacked["y"]})
            if stacked["bf16"]:
                local = self.device_data.local
                local["x"] = local["x"].to(torch.bfloat16)
            self._client_ns = stacked["n"]
            self.sharded_lane_runner = ShardedLaneRunner(
                spec, cfg, mesh, payload_fn, server_fn, n_lanes=chunk,
                packed=mode == 3 and spec.lane_loss_builder is not None)
        elif stacked is not None:
            x = torch.as_tensor(stacked["x"], device=self.device)
            self.device_data = {
                "x": x.to(torch.bfloat16) if stacked["bf16"] else x,
                "y": torch.as_tensor(stacked["y"],
                                     device=self.device).long()}
            self._client_ns = stacked["n"]
            self.wave_runner = WaveRunner(spec, cfg, payload_fn, server_fn,
                                          client_chunk=chunk)
            self.lane_runner = LaneRunner(spec, cfg, payload_fn, server_fn,
                                          n_lanes=chunk)
            if (int(getattr(args, "wave_mode", 1)) == 3
                    and spec.lane_loss_builder is not None):
                self.packed_lane_runner = LaneRunner(
                    spec, cfg, payload_fn, server_fn, n_lanes=chunk,
                    packed=True)
            self.indexed_round_fn = make_indexed_sim_round(
                spec, cfg, payload_fn, server_fn,
                client_chunk=getattr(args, "client_chunk", None))
        self.server_state = server_state if server_state is not None else ()
        # over-selection and simulated deadline misses: restricting the
        # cohort to the reporting subset is the renormalised partial
        # aggregate (the rounds weight by per-client sample counts)
        self.resilience = SimResilience.from_args(args)
        self._last_res_record = None
        # pace steering adapts the over-selection eps from the previous
        # round's record; the simulation has no wall clock, so the
        # deadline knobs stay put
        self.pace = PaceController.from_args(args)
        if self.pace is not None and self.resilience is None:
            logging.warning(
                "--pace_steering without --overselect/--straggler_p: the "
                "simulation rounds have no sampling loop to steer; "
                "ignoring the flag")
            self.pace = None
        self.seed = int(getattr(args, "seed", 0))
        self._data_rng = np.random.default_rng(self.seed)
        self.round_idx = 0
        self.history = []
        self._last_trip = None
        self.global_state = spec.init_fn(self.seed, self.device)
        if self.compressor is not None:
            self._init_compression(args)

    def _init_compression(self, args):
        """The residual store shared by both lowerings (dense rows on the
        device when the population fits ``device_data_cap_gb``) and the
        per-client update bytes, from shapes alone. The bytes are framed
        under the reference's parameter names
        (:func:`~fedml_tpu_torch.utils.torch_import.reference_tree`), so
        a port run and a reference run count the same bytes; the
        residuals live in the layout the compressor sees (an LSTM's gate
        leaves, :func:`~fedml_tpu_torch.utils.torch_import.gate_split`)."""
        params = self.global_state["params"]
        self._ef_store = ResidualStore(
            gate_split(params), num_clients=len(self.train_data_local_dict),
            dense_cap_gb=float(getattr(args, "device_data_cap_gb", 2.0)))
        wire = reference_tree(params)
        self._payload_bytes = compressed_payload_nbytes(self.compressor,
                                                        wire)
        self._raw_payload_bytes = raw_payload_nbytes(wire)

    def _init_bucketed(self, spec, args, payload_fn, server_fn):
        """The streaming runner, its edges sized from the POPULATION's
        maximum step count so the bucket shapes hold across rounds."""
        if spec.stacked_loss_fn is None:
            raise NotImplementedError(
                f"spec '{spec.name}' has no stacked_loss_fn: the bucketed "
                "path trains a chunk's clients at once")
        pop_ns = [int(v) for v in self.train_data_local_num_dict.values()]
        eff_bs = (args.batch_size if args.batch_size not in (-1, 0)
                  else max(1, max(pop_ns)))
        s_max = max(_steps_for(max(n, 1), eff_bs, args.epochs)
                    for n in pop_ns)
        edges = parse_bucket_edges(getattr(args, "bucket_edges", None),
                                   s_max)
        self.bucket_runner = self.program.compile_bucketed(
            spec, self.cfg, payload_fn, server_fn,
            compressor=self.compressor,
            client_chunk=getattr(args, "client_chunk", 8) or 8,
            batch_size=eff_bs, epochs=args.epochs, edges=edges)

    def _stack_if_fits(self, args):
        """Stack every client's padded shard on the host when the stacks
        fit ``device_data_cap_gb`` on the device; ``device_dtype`` bf16
        halves a floating ``x`` there (``"bf16"``). Returns ``{"x", "y",
        "n", "bf16"}`` or None."""
        C = len(self.train_data_local_dict)
        n_max = max(1, max(len(d["y"])
                           for d in self.train_data_local_dict.values()))
        x0 = np.asarray(self.train_data_local_dict[0]["x"])
        y0 = np.asarray(self.train_data_local_dict[0]["y"])
        cast_bf16 = (getattr(args, "device_dtype", None) in ("bf16",
                                                             "bfloat16")
                     and np.issubdtype(x0.dtype, np.floating))
        x_itemsize = 2 if cast_bf16 else x0.dtype.itemsize
        row = (int(np.prod(x0.shape[1:], dtype=np.int64)) * x_itemsize
               + int(np.prod(y0.shape[1:], dtype=np.int64) or 1)
               * y0.dtype.itemsize)
        if C * n_max * row > float(getattr(args, "device_data_cap_gb",
                                           2.0)) * 1e9:
            return None
        host = stack_clients([self.train_data_local_dict[i]
                              for i in range(C)])
        return dict(host, bf16=cast_bf16)

    def _sample_cohort(self, round_idx):
        """Cohort for one round: the seeded draw, or with resilience on
        the over-selected cohort trimmed to its reporting subset."""
        if self.resilience is None:
            self._last_res_record = None
            with get_tracer().span("cohort-select", round=int(round_idx)):
                return client_sampling(round_idx,
                                       len(self.train_data_local_dict),
                                       self.args.client_num_per_round)
        if self.pace is not None and self._last_res_record is not None:
            # steer before sampling. The loss is the shortfall against
            # the target C: surplus trimmed by "first C win" must not read
            # as loss, or eps ratchets up on its own success
            prev = self._last_res_record
            target = min(self.args.client_num_per_round,
                         len(self.train_data_local_dict))
            dec = self.pace.decide(
                outcome=("degraded" if prev["res/degraded"]
                         else "complete"),
                selected=target,
                reporting=min(prev["res/reporting"], target))
            self.resilience.policy = dataclasses.replace(
                self.resilience.policy, overselect=dec.overselect)
            self.program = self.program.replace(
                cohort=dataclasses.replace(self.program.cohort,
                                           overselect=dec.overselect))
        # SimResilience.sample opens its own cohort-select span
        client_indexes, record = self.resilience.sample(
            round_idx, len(self.train_data_local_dict),
            self.args.client_num_per_round)
        if self.pace is not None:
            record.update(self.pace.record())
        self._last_res_record = record
        return client_indexes

    def _cohort(self, round_idx):
        """The host-packed round's cohort: its draw and its batches,
        packed on the host and uploaded (the ``broadcast``)."""
        client_indexes = self._sample_cohort(round_idx)
        logging.info("client_indexes = %s", client_indexes)
        datasets = [self.train_data_local_dict[i] for i in client_indexes]
        if all(len(d["y"]) == 0 for d in datasets):
            raise ValueError(
                f"round {round_idx}: every sampled client has an empty shard")
        with get_tracer().span("broadcast", clients=len(client_indexes)):
            packed = pack_cohort(datasets, self.args.batch_size,
                                 self.args.epochs, rng=self._data_rng)
            if self.mesh is not None:
                # every rank packed the same cohort (the same seeded
                # stream); each places its own block
                return client_indexes, global_cohort(self.mesh, packed)
            packed = {k: torch.as_tensor(v, device=self.device)
                      for k, v in packed.items()}
            packed["y"] = packed["y"].long()
        return client_indexes, packed

    def train_one_round(self):
        # span model (the reference's): the host enqueues the round's
        # device work asynchronously, so "local-train" measures the
        # enqueue (plus the host work inside it) and the device wait lands
        # in "aggregate", where the end-of-round synchronize sits
        tracer = get_tracer()
        mon = get_perf_monitor()  # one global read when monitoring is off
        t0 = time.time()
        with (mon.xprof(self.round_idx) if mon is not None
              else contextlib.nullcontext()):
            with tracer.span("round", round=int(self.round_idx)):
                metrics = self._traced_round_body(tracer, t0)
        if mon is not None:
            # true steps are known on the host on the bucketed path only;
            # elsewhere the per-step histogram is skipped rather than
            # reading the device
            steps = (self._last_bucket_info["bucket"]["true_steps"]
                     if self.bucket_runner is not None else None)
            mon.observe_round(metrics["round_time_s"], steps=steps)
        self.round_idx += 1
        return metrics

    def _traced_round_body(self, tracer, t0):
        round_seed = int(fold_seed(self.seed, self.round_idx))
        if self.bucket_runner is not None:
            client_indexes = self._sample_cohort(self.round_idx)
            logging.info("bucketed round over %d clients",
                         len(client_indexes))
            datasets = [self.train_data_local_dict[i]
                        for i in client_indexes]
            if all(len(d["y"]) == 0 for d in datasets):
                raise ValueError(f"round {self.round_idx}: every sampled "
                                 f"client has an empty shard")
            with tracer.span("local-train", mode="bucketed",
                             clients=len(client_indexes)):
                (self.global_state, self.server_state,
                 info) = self.bucket_runner.run_round(
                    self.global_state, self.server_state, datasets,
                    round_seed, data_rng=self._data_rng,
                    aggregator=self.async_agg,
                    async_window=self._async_window,
                    client_ids=client_indexes,
                    residual_store=(self._ef_store
                                    if self.compressor is not None
                                    else None))
            self._last_bucket_info = info
            self._last_cohort_size = len(client_indexes)
        elif self.device_data is not None:
            info = self._resident_round(tracer, round_seed)
        elif self.compressed_round_fn is not None:
            client_indexes, packed = self._cohort(self.round_idx)
            with tracer.span("local-train", mode="compressed"):
                # rows gathered and scattered by stable client id
                cohort_res = self._ef_store.gather(client_indexes)
                (self.global_state, self.server_state, new_res,
                 info) = self.compressed_round_fn(
                    self.global_state, self.server_state, packed,
                    cohort_res, round_seed)
                self._ef_store.scatter(client_indexes, new_res)
            self._last_cohort_size = len(client_indexes)
        else:
            _, packed = self._cohort(self.round_idx)
            with tracer.span("local-train", mode="packed"):
                (self.global_state, self.server_state,
                 info) = self.round_fn(self.global_state, self.server_state,
                                       packed, round_seed)
        self._last_trip = info.get("trip")
        with tracer.span("aggregate"):
            end_of_round_sync(self.global_state, self.device)
        dt = time.time() - t0
        with tracer.span("report"):
            round_metrics = (gather_metrics(info["metrics"])
                             if self.mesh is not None else info["metrics"])
            m = {k: float(v.sum()) for k, v in round_metrics.items()}
        self._last_metrics = m
        # the round's metrics as summed, per-client axes and all (FedSeg
        # reads its confusion matrix from them)
        self._last_round_metrics = round_metrics
        train_metrics = {
            "round": self.round_idx,
            "Train/Loss": m["loss_sum"] / max(m["count"], 1),
            "Train/Acc": m["correct"] / max(m["count"], 1),
            "round_time_s": dt}
        if self._last_res_record is not None:
            train_metrics.update(self._last_res_record)
        if self.bucket_runner is not None:
            b = info["bucket"]
            train_metrics.update({
                "bucket/clients": b["clients"],
                "bucket/shapes": b["buckets_used"],
                "bucket/chunks": b["chunks"],
                "bucket/executed_steps": b["executed_steps"],
                "bucket/true_steps": b["true_steps"],
                "bucket/waste_frac": b["waste_frac"]})
            if "executed_flops" in b:
                # the cost model's attribution (--costmodel)
                train_metrics.update({
                    "bucket/executed_flops": b["executed_flops"],
                    "bucket/true_flops": b["true_flops"],
                    "bucket/flops_waste_frac": b["flops_waste_frac"]})
            # the buffer's counters ride every round record on async runs
            train_metrics.update(info.get("async") or {})
            if self.round_idx == 0:
                # the two backends shuffle from different PRNG families
                train_metrics["packing_backend"] = packing_backend()
        if self.compressor is not None:
            # the round's uplink: encoded bytes a client are static given
            # the template (the downlink broadcast is not compressed)
            cohort = self._last_cohort_size
            wire = self._payload_bytes * cohort
            train_metrics["bytes_on_wire"] = wire
            train_metrics["compression_ratio"] = round(
                self._raw_payload_bytes * cohort / wire, 3)
        return train_metrics

    def _resident_round(self, tracer, round_seed):
        """One round over the device-resident shards by ``wave_mode``."""
        client_indexes = self._sample_cohort(self.round_idx)
        logging.info("client_indexes = %s", client_indexes)
        ns = [self._client_ns[i] for i in client_indexes]
        if sum(ns) == 0:
            raise ValueError(f"round {self.round_idx}: every sampled "
                             f"client has an empty shard")
        with tracer.span("broadcast", clients=len(client_indexes)):
            sched = pack_schedule(ns, self.args.batch_size,
                                  self.args.epochs, rng=self._data_rng)
        mode = int(getattr(self.args, "wave_mode", 1))
        state = (self.global_state, self.server_state)
        if self.sharded_lane_runner is not None:
            with tracer.span("local-train", mode="sharded-lanes"):
                *state, info = self.sharded_lane_runner.run_round(
                    *state, self.device_data, client_indexes, sched,
                    round_seed)
        elif mode in (2, 3):
            runner = (self.packed_lane_runner
                      if mode == 3 and self.packed_lane_runner is not None
                      else self.lane_runner)
            with tracer.span("local-train",
                             mode=_MODES[3 if runner.packed else 2]):
                *state, info = runner.run_round(
                    *state, self.device_data, client_indexes, sched,
                    round_seed)
        elif mode == 1:
            with tracer.span("local-train", mode=_MODES[1]):
                *state, info = self.wave_runner.run_round(
                    *state, self.device_data, client_indexes, sched,
                    round_seed)
        else:
            with tracer.span("local-train", mode=_MODES[0]):
                sel = torch.as_tensor(np.asarray(client_indexes, np.int64),
                                      device=self.device)
                dd = {"x": self.device_data["x"][sel],
                      "y": self.device_data["y"][sel]}
                sched_t = {k: torch.as_tensor(v, device=self.device)
                           for k, v in sched.items()}
                sched_t["idx"] = sched_t["idx"].long()
                *state, info = self.indexed_round_fn(*state, dd, sched_t,
                                                     round_seed)
        self.global_state, self.server_state = state
        return info

    def _packed_global_eval(self):
        """The global test set packed once. A pack of at most 25% of
        ``device_data_cap_gb`` stays on the device; a larger one stays on
        the host (uploaded batch by batch at each evaluation)."""
        if not hasattr(self, "_eval_packed"):
            packed = pack_eval(self.test_data_global, self.args.batch_size)
            nbytes = sum(v.nbytes for v in packed.values())
            cap = 0.25 * float(
                getattr(self.args, "device_data_cap_gb", 2.0)) * 1e9
            if nbytes <= cap:
                packed = {k: torch.as_tensor(v, device=self.device)
                          for k, v in packed.items()}
                packed["y"] = packed["y"].long()
            self._eval_packed = packed
        return self._eval_packed

    @staticmethod
    def _test_metrics(totals):
        m = {k: float(v) for k, v in totals.items()}
        count = max(m["count"], 1)
        return {"Test/Loss": m["loss_sum"] / count,
                "Test/Acc": m["correct"] / count}

    def evaluate_global(self):
        """Test loss and accuracy of the global model on the global test
        set: the metrics are summed on the device and read once."""
        return self._test_metrics(self.eval_fn(self.global_state,
                                               self._packed_global_eval()))

    def evaluate_local(self, max_clients=None):
        """Test loss and accuracy over the clients' local test shards
        (``--ci`` evaluates one client); ``{}`` when every shard is
        empty."""
        if getattr(self.args, "ci", 0):
            max_clients = 1
        totals = None
        for i, d in self.test_data_local_dict.items():
            if max_clients is not None and i >= max_clients:
                break
            if d is None or len(d["y"]) == 0:
                continue
            m = self.eval_fn(self.global_state,
                             pack_eval(d, self.args.batch_size))
            totals = m if totals is None else {k: totals[k] + m[k]
                                               for k in totals}
        return {} if totals is None else self._test_metrics(totals)

    def train(self, on_round=None):
        """Round loop until ``comm_round``; evaluates every
        ``frequency_of_the_test`` rounds and on the last, inside an
        ``eval`` span carrying the trained round and booked as off-round
        work (an auditor never charges its kernel loads to the next
        round). ``on_round(api, metrics)`` runs after each round."""
        freq = getattr(self.args, "frequency_of_the_test", 5)
        while self.round_idx < self.args.comm_round:
            metrics = self.train_one_round()
            last = self.round_idx == self.args.comm_round
            if self.round_idx % freq == 0 or last:
                with get_tracer().span(
                        "eval", round=int(metrics.get("round",
                                                      self.round_idx - 1))):
                    with off_round_work():
                        metrics.update(self.evaluate_global())
            self.metrics_logger(metrics)
            self.history.append(metrics)
            if on_round is not None:
                on_round(self, metrics)
        return self.global_state


__all__ = ["FedAvgAPI", "client_sampling"]
