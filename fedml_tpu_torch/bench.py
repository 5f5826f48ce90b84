"""The port's bench: FedAvg rounds per hour of the two flagship recipes
on one NVIDIA H100 (counterpart of the repository's ``bench.py``).

    python -m fedml_tpu_torch.bench          # ResNet-56 flagship, uncut
    python -m fedml_tpu_torch.bench --lm     # federated LM flagship, uncut
    python -m fedml_tpu_torch.bench --smoke --platform cpu [--lm]
    python -m fedml_tpu_torch.bench --massive_cohort [N] [--massive_async 1]
        [--compressor SPEC]
    python -m fedml_tpu_torch.bench --compression_sweep [--sweep_model M]
    python -m fedml_tpu_torch.bench --check
    python -m fedml_tpu_torch.bench --soak [N] [--compressor SPEC]
    python -m fedml_tpu_torch.bench --tree_soak [N] [--tree_fanout 2,2]
    python -m fedml_tpu_torch.bench --steering [--steering_rounds R]
        [--steering_scale S] [--steering_transport tcp|eventloop]

**ResNet-56 flagship** (no flags): cross-silo FedAvg on CIFAR-10-shaped
synthetic data (50,000 samples, 32x32, LDA alpha=0.5, seed 0), 32
clients all sampled, batch 64, SGD lr 0.001 wd 0.001, 20 local epochs,
crop/flip/Cutout on, shards resident on the device, eight clients at a
time as packed lanes (``--mode 3``), ResNet-56 in bf16. One warmup round,
then ``--rounds`` measured rounds. ``--mode`` 2 (vmap lanes), 1 (waves)
and 0 (flat; also ``--flat``) run the same recipe through the other
round runners.

**LM flagship** (``--lm``): TransformerLM d_model 512, 4 layers, heads of
128, T 80, vocab 90, bf16, on 32 LEAF-Shakespeare-shaped synthetic
clients, batch 4, 1 epoch, AMSGrad lr 3e-4, streamed through bucketed
chunks of 8 on geometric edges.

**Massive cohort** (``--massive_cohort [N]``, N 50,000 when bare): one
card streams rounds of N ragged simulated LR clients (lognormal(2, 1)
shard sizes clipped to 1-400, 16 features, 4 classes, seed 0; the
reference's ``_ragged_lr_clients``) through the bucketed path: every
client each round, batch 8, SGD lr 0.05, 1 epoch, geometric edges,
``--massive_chunk`` clients a chunk, no resident shards; with
``--massive_async 1`` through the buffered async aggregator
(``--buffer_k``, ``--staleness_decay``, window 4). One warmup round,
then ``--rounds`` measured rounds; the headline is clients/s. With
``--compressor SPEC`` every client's update is compressed with error
feedback inside the chunk (streaming EF), and the record adds
``bytes_on_wire``, ``compression_ratio`` and ``residual_store`` (dense
rows on the device or a sparse host dict).

**Compression tools** (``bench.py``'s ``run_compression_tools``):
``--compression_sweep`` prints one line a ``--compressors`` spec on the
``--sweep_model`` (``resnet56`` or ``cnn``) parameters: the encoded
bytes of one update through the codec, the ratios against the raw
binary frame and the JSON lists, and the median encode and decode ms of
``--repeats`` calls on the device; ``--check`` is the codec's size gate
(the ``none`` frame at least 5x smaller than the JSON lists). Bytes are
counted with the parameters under the reference's names and layouts
(``utils/torch_import.py``), so they equal the reference's.

**Control-plane soaks** (``run_soak_bench``, ``run_tree_soak_bench``;
host only, no device): ``--soak [N]`` (N 1,000 when bare) drives N
swarm connections from a subprocess through a real buffered-async
server over the selector event loop (``net/soak.py``) under
``observability.enable(perfmon=True)``; the headline is reports/s, with
bytes a report, the ``fed_report_latency_seconds`` tail and the decode
seconds a report, and the run's ``status.json`` must end final. ``--tree_soak [N]`` shards N leaves over a
real tree of edge processes (``topology/``, ``--tree_fanout``) and
audits every tier's ``status.json``. ``--soak_updates``,
``--soak_jitter``, ``--soak_trace``, ``--soak_params`` and
``--compressor`` shape both; ``--soak_decode_workers`` the soak's
server, ``--tree_transport`` and ``--tree_steering`` the tree.

**Pace steering** (``--steering``; host only, no device): bench.py's
``run_steering_bench``. One seeded diurnal trace (day, flash crowd,
outage, then night with correlated dropouts), a sweep of fixed
(deadline, overselect) configurations and one run under the
``PaceController``, all over the real control plane (``run_tcp_fedavg``
on ``--steering_transport``) with the perf monitor armed; the headline
is the steered rounds/hour, beside the best surviving fixed
configuration whose final model stays within ``--steering_quality_tol``
of an unshaped full-participation run. It passes at a speedup of 1.10
or more.

**Kernel builds.** ``--warmup`` builds the run's kernel libraries before
the warmup round (``fedml_tpu_torch.compile``; the record adds
``warmup_programs`` and ``warmup_seconds``), and ``--compile_cache_dir
DIR`` builds and loads them in DIR instead of ``build/``
(``utils/compile_cache.py``; the record names it).

Each run prints one JSON record with the reference's keys, appends it
to ``--ledger`` (default ``bench_results/torch_ledger.jsonl``, a ledger
of the port's own; ``''`` disables) and returns it from :func:`main`.
``--check-regress`` judges the ledger's newest record of each metric
against the median of its predecessors
(:func:`~fedml_tpu_torch.observability.perfmon.check_regression`).

Where the port differs from ``bench.py`` on purpose:

- FLOPs come from ``torch.utils.flop_counter`` over one single-client
  step on a CPU replica of the state (``flops_source:
  "torch-flop-counter"``, :mod:`~fedml_tpu_torch.observability.costmodel`),
  cross-checked against the analytic constants; the LM's executed FLOPs
  are that count times the round's executed client-steps.
- The compile fields (``compile_count``, ``compile_seconds``,
  ``warmup_compiles``, ``steady_compiles``) count this run's ``nvcc``
  builds of the port's kernels (``ops/_build.py``), not XLA compiles.
- ``phase_timings_s`` is the median seconds of each round span over the
  measured rounds (``round``, ``cohort-select``, ``broadcast``,
  ``local-train``, ``lanes``, ``wave`` and ``server-update`` or
  ``bucket-chunk``, ``aggregate``,
  ``report``), and ``phase_totals_s`` each span's seconds a round, its
  spans summed. ``local-train`` is the host's enqueue; the device wait
  lands in ``aggregate``.
- There is no CPU fallback and no device probe: without a card the bench
  fails (``--platform cpu`` asks for the CPU, and tags the metric as a
  smoke). On the CPU ``mfu``, ``achieved_tflops`` and the peak are null.
- There is no degrade ladder: the one configuration asked for runs, or
  the bench fails. A flag the reference bench lacks fails. Every failure
  prints the one-line record with ``error``, and the command exits
  non-zero.
- ``device`` is the card's name and ``power_limit_w`` its power limit
  (``nvidia-smi``); ``host_cpu`` and ``host_cpus`` name the host that
  enqueues the rounds' work. The massive cohort's record also names
  its ``packing_backend`` (the native and numpy schedules shuffle from
  different PRNG families) and its ``chunks`` a round.
- With ``--profile_dir`` on the card the record adds ``device_busy_s``
  (the card's kernel and copy seconds a profiled round) and
  ``device_busy_share`` (their share of the profiled rounds' wall time).

``BASELINE_ROUNDS_PER_HOUR`` (60) is ``bench.py``'s estimate of the
original FedML recipe on 8 V100s under MPI; it is not a measured number.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import threading
import time
import traceback
import types

import numpy as np
import torch

from fedml_tpu_torch.data.shakespeare import synthetic_shakespeare_clients
from fedml_tpu_torch.observability.costmodel import (FLOPS_SOURCE,
                                                     train_step_flops)
from fedml_tpu_torch.observability.perfmon import (DEFAULT_REGRESS_BAND,
                                                   append_ledger,
                                                   check_regression)
from fedml_tpu_torch.observability.tracing import Tracer, set_tracer
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.utils.compile_cache import compilation_cache
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.profiling import profile_trace

# constants copied from bench.py (the port imports nothing of it)
BASELINE_ROUNDS_PER_HOUR = 60.0
FLAGSHIP_EPOCHS = 20
# ResNet-56 (CIFAR): 125.75M MACs/sample forward; a training step is
# about 3x the forward (forward, input grad, weight grad)
RESNET56_MACS_PER_SAMPLE = 125.75e6
TRAIN_FLOPS_PER_SAMPLE = 3 * 2 * RESNET56_MACS_PER_SAMPLE
#: tolerance between an analytic constant and the counted FLOPs
FLOPS_XCHECK_TOL = 0.30

#: dense bf16 peak (TFLOP/s) by device name, NVIDIA's data sheets
_PEAK_TFLOPS = (("h100 nvl", 835.0), ("h100 pcie", 756.0),
                ("h100 sxm", 989.4), ("h100 80gb hbm3", 989.4))
#: assumed for any other name: the H100 SXM
_ASSUMED_PEAK_TFLOPS = 989.4

_FAILURE_METRIC = "FedAvg rounds/hour (CIFAR-10-scale ResNet-56)"
_LM_FAILURE_METRIC = "federated-LM rounds/hour (TransformerLM)"
_MASSIVE_FAILURE_METRIC = "massive-cohort clients/sec (bucketed streaming)"
_SMOKE_TAG = " [SMOKE -- not baseline-comparable]"

_STEERING_FAILURE_METRIC = "fedpace steered rounds/hour"


def peak_flops(device_name):
    """Dense bf16 peak FLOP/s of a card by its name: the H100 SXM, PCIe
    and NVL parts; the SXM peak for any other name."""
    name = device_name.lower()
    for key, tf in _PEAK_TFLOPS:
        if key in name:
            return tf * 1e12
    return _ASSUMED_PEAK_TFLOPS * 1e12


def emit_failure(error, metric=_FAILURE_METRIC):
    """The one-JSON-line contract on every failure path; returns the
    record printed."""
    out = {"metric": metric, "value": 0.0, "unit": "rounds/hour",
           "vs_baseline": 0.0, "error": error}
    print(json.dumps(out), flush=True)
    return out


def arm_watchdog(budget_s, context, metric=_FAILURE_METRIC):
    """Print the failure line and exit the process if no result came
    within ``budget_s`` (a round wedged on the device cannot be unblocked
    from Python). Cancel the returned timer when the run ends."""

    def fire():
        emit_failure(f"watchdog: no result within {budget_s:.0f}s "
                     f"({context})", metric)
        os._exit(1)

    t = threading.Timer(budget_s, fire)
    t.daemon = True
    t.start()
    return t


def card_power_limit_w():
    """The first card's power limit in W, from ``nvidia-smi``; None when
    it reports none."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    try:
        return float(line.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        return None


def _device_fields(device):
    """``device`` and ``power_limit_w`` for a record, and the peak FLOP/s
    (None on the CPU)."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}, None
    name = torch.cuda.get_device_name(device)
    return ({"device": name, "power_limit_w": card_power_limit_w()},
            peak_flops(name))


def _build_counts():
    return dict(_build.build_stats)


def _builds_since(before):
    now = _build.build_stats
    return {k: now[k] - before[k] for k in now}


def _warmup(args, api):
    """``--warmup``: build the run's kernel libraries now; the record's
    ``warmup_programs`` and ``warmup_seconds`` (empty without it)."""
    if not args.warmup:
        return {}
    from fedml_tpu_torch.compile import warmup_api
    report = warmup_api(api)
    return {"warmup_programs": report["warmup/programs"],
            "warmup_seconds": report["warmup/seconds"]}


def _phase_fields(tracer, rounds):
    """``phase_timings_s``: the median seconds of each span name over the
    traced rounds (the reference's field); ``phase_totals_s``: the
    seconds of each span name a round, all its spans summed (a round has
    one ``bucket-chunk`` span per chunk)."""
    durs = sorted(tracer.durations_by_name().items())
    return {"phase_timings_s": {name: round(float(np.median(d)), 4)
                                for name, d in durs},
            "phase_totals_s": {name: round(float(np.sum(d)) / rounds, 4)
                               for name, d in durs}}


def _measured_rounds(api, rounds, profile_dir):
    """``rounds`` rounds under a fresh :class:`Tracer` (and, with
    ``profile_dir``, ``torch.profiler``): round times, each round's
    metrics and sample counts, the tracer and the profile's fields."""
    tracer = Tracer()
    prev = set_tracer(tracer)
    times, metrics, samples = [], [], []
    try:
        with profile_trace(profile_dir,
                           enabled=profile_dir is not None) as prof:
            for _ in range(rounds):
                t0 = time.time()
                metrics.append(api.train_one_round())
                times.append(time.time() - t0)
                samples.append(api._last_metrics["count"])
    finally:
        set_tracer(prev)
    return times, metrics, samples, tracer, _profile_fields(prof, rounds)


def _profile_fields(prof, rounds):
    """With ``--profile_dir`` on the card: ``device_busy_s``, the card's
    busy seconds a profiled round, and ``device_busy_share``, their share
    of the profiled rounds' wall time (the profiler's own host cost
    included)."""
    if prof["device_busy_s"] is None:
        return {}
    return {"device_busy_s": round(prof["device_busy_s"] / rounds, 4),
            "device_busy_share": round(prof["device_busy_s"]
                                       / prof["wall_s"], 4)}


def _host_fields(cpuinfo="/proc/cpuinfo"):
    """The host the record was taken on, which enqueues every launch of
    the round: its CPU model and the CPUs this process may use."""
    info = {}
    try:
        with open(cpuinfo) as f:
            for line in f:
                if not line.strip():
                    break  # the first CPU's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    model = info.get("model name")
    if model in (None, "", "unknown") and "model" in info:
        # a virtual machine may hide the name; its family and model
        # numbers still name the generation
        model = (f"{info.get('vendor_id', '?')} family "
                 f"{info.get('cpu family', '?')} model {info['model']}")
    return {"host_cpu": model or platform.processor() or None,
            "host_cpus": len(os.sched_getaffinity(0))}


def _peak_memory_gb(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


# ---------------------------------------------------------------------------
# the ResNet-56 flagship
# ---------------------------------------------------------------------------
#: the record's ``exec_mode`` of each ``--mode`` (bench.py's names)
_EXEC_MODES = {3: "mxu-lanes", 2: "lanes", 1: "waves", 0: "flat"}


def _wave_mode(args):
    return 0 if args.flat else args.mode


def build_api(args, device):
    """The flagship's ``FedAvgAPI`` (``bench.py:build_api``): the smoke
    shrinks the data to 16 samples a client at 16x16 and one epoch."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.data.augment import make_cifar_augment
    from fedml_tpu_torch.data.synthetic import load_synthetic_images
    from fedml_tpu_torch.models import resnet56

    if args.smoke:
        n_train, image, epochs = 2 * args.clients * 8, 16, 1
    else:
        n_train, image, epochs = 50_000, 32, args.epochs
    dataset = load_synthetic_images(
        client_num=args.clients, n_train=n_train,
        n_test=max(64, n_train // 50), image_size=image, partition="hetero",
        partition_alpha=0.5, seed=0)
    model = resnet56(class_num=10, dtype=torch.bfloat16)
    augment_fn = None
    if not args.no_augment:
        augment_fn = make_cifar_augment(
            pad=4 if image >= 32 else 2,
            cutout_length=16 if image >= 32 else 4)
    spec = make_classification_spec(model, augment_fn=augment_fn,
                                    lane_lowering=args.lane_lowering)
    run_args = types.SimpleNamespace(
        client_num_in_total=args.clients, client_num_per_round=args.clients,
        comm_round=10 ** 9, epochs=epochs, batch_size=args.batch_size,
        lr=0.001, wd=0.001, client_optimizer="sgd",
        frequency_of_the_test=10 ** 9, seed=0,
        client_chunk=args.client_chunk, wave_mode=_wave_mode(args),
        device_resident="auto", device_data_cap_gb=4.0,
        device_dtype=args.device_dtype)
    if args.algo == "fedopt":
        # the reference bench's second line: the same engine and shapes,
        # server Adam on the pseudo-gradient
        from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
        run_args.server_optimizer, run_args.server_lr = "adam", 0.001
        return FedOptAPI(dataset, spec, run_args, device=device), image
    return FedAvgAPI(dataset, spec, run_args, device=device), image


def run_resnet_bench(args, device):
    """Warmup round, measured rounds, then the FLOP count; the record of
    ``bench.py``'s ``main``."""
    api, image = build_api(args, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    builds0 = _build_counts()
    t0 = time.time()
    warm_fields = _warmup(args, api)
    api.train_one_round()  # warmup (builds the kernels it launches)
    compile_s = time.time() - t0
    warm = _builds_since(builds0)
    rounds = 1 if args.smoke else args.rounds
    times, _, samples, tracer, prof = _measured_rounds(api, rounds,
                                                       args.profile_dir)
    peak_mem = _peak_memory_gb(device)
    round_s = float(np.median(times))
    samples_per_round = float(np.mean(samples))
    bs = args.batch_size
    step_flops = train_step_flops(
        api.spec, api.cfg, {"x": ((bs, image, image, 3), torch.float32),
                            "y": ((bs,), torch.int64),
                            "mask": ((bs,), torch.float32)})
    flops_per_sample = step_flops / bs
    analytic = TRAIN_FLOPS_PER_SAMPLE * (image / 32) ** 2
    fields, peak = _device_fields(device)
    achieved = samples_per_round * flops_per_sample / round_s
    smoke = args.smoke or device.type != "cuda"
    epochs_run = 1 if args.smoke else args.epochs
    flagship = (not smoke and epochs_run == FLAGSHIP_EPOCHS
                and args.clients == 32 and args.batch_size == 64)
    steps_round = samples_per_round / bs
    mode = _wave_mode(args)
    steps_key = {1: "wave_steps_per_round", 2: "lane_steps_per_round",
                 3: "lane_steps_per_round"}.get(mode)
    return {
        "metric": (f"{'FedOpt' if args.algo == 'fedopt' else 'FedAvg'} "
                   "rounds/hour (CIFAR-10-scale ResNet-56, "
                   f"{args.clients} clients, bs{bs}, {epochs_run} local "
                   "epochs)"
                   + ("" if args.lane_lowering is None
                      else f" [lane_lowering={args.lane_lowering}]")
                   + (_SMOKE_TAG if smoke else "")),
        "value": round(3600.0 / round_s, 2),
        "unit": "rounds/hour",
        "vs_baseline": (round(3600.0 / round_s / BASELINE_ROUNDS_PER_HOUR, 2)
                        if flagship else 0.0),
        "round_time_s": round(round_s, 3),
        "round_times_s": [round(t, 3) for t in times],
        "compile_s": round(compile_s, 1),
        "compile_count": warm["builds"],
        "compile_seconds": round(warm["seconds"], 4),
        **warm_fields,
        "samples_per_round": samples_per_round,
        **({} if steps_key is None else {steps_key: int(api._last_trip)}),
        "ms_per_step_batch": round(1e3 * round_s / max(steps_round, 1), 3),
        "model_train_flops_per_sample": flops_per_sample,
        "flops_source": FLOPS_SOURCE,
        "analytic_flops_per_sample": analytic,
        "flops_vs_analytic": round(flops_per_sample / analytic, 3),
        "achieved_tflops": (None if peak is None
                            else round(achieved / 1e12, 2)),
        "mfu": None if peak is None else round(achieved / peak, 4),
        "assumed_peak_tflops": None if peak is None else peak / 1e12,
        **fields,
        **_host_fields(),
        "peak_memory_gb": peak_mem,
        **_phase_fields(tracer, rounds),
        **prof,
        "exec_mode": _EXEC_MODES[mode],
    }


# ---------------------------------------------------------------------------
# the federated LM flagship
# ---------------------------------------------------------------------------
_synthetic_shakespeare_clients = synthetic_shakespeare_clients


def _lm_analytic_flops_per_token(d, n_layers, seq, vocab):
    """Matmul-only train FLOPs/token (3x forward; causal attention at
    half cost)."""
    fwd = n_layers * (24 * d * d + 2 * seq * d) + 2 * d * vocab
    return 3.0 * fwd


def run_lm_bench(args, device):
    """``--lm``: warmup round, measured rounds, the FLOP count; the
    record of ``bench.py``'s ``run_lm_bench`` with ``phase_timings_s``."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
    from fedml_tpu_torch.data.shakespeare import SEQUENCE_LENGTH, VOCAB_SIZE
    from fedml_tpu_torch.models.transformer import TransformerLM

    d, L_layers, T = args.lm_d_model, args.lm_layers, args.lm_seq
    C, bs = args.lm_clients, args.lm_batch
    if T is None:
        T = SEQUENCE_LENGTH
    if args.smoke:
        d, L_layers, T, C = min(d, 64), min(L_layers, 2), min(T, 32), min(C, 8)
    if args.lm_data_dir:
        # V and T come from the file (the smoke's cut of T does not apply)
        from fedml_tpu_torch.data.shakespeare import load_shakespeare
        dataset = load_shakespeare(args.lm_data_dir, client_num=C,
                                   leaf=bool(args.lm_leaf))
        V = dataset[7]
        T = dataset[2]["x"].shape[1]
    else:
        V = VOCAB_SIZE
        dataset = _synthetic_shakespeare_clients(C, T, V)
    model = TransformerLM(vocab_size=V, n_layers=L_layers,
                          n_heads=max(1, d // 128), d_model=d, max_len=T,
                          dtype=torch.bfloat16)
    spec = make_seq_classification_spec(model, name="lm")
    run_args = types.SimpleNamespace(
        client_num_in_total=C, client_num_per_round=C,
        comm_round=10 ** 9, epochs=args.lm_epochs, batch_size=bs,
        lr=3e-4, wd=0.0, client_optimizer="adam",
        frequency_of_the_test=10 ** 9, seed=0,
        client_chunk=args.lm_chunk, bucket_edges="geometric",
        device_resident="0")
    api = FedAvgAPI(dataset, spec, run_args, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    builds0 = _build_counts()
    t0 = time.time()
    warm_fields = _warmup(args, api)
    api.train_one_round()
    compile_s = time.time() - t0
    warm = _builds_since(builds0)
    rounds = 1 if args.smoke else args.rounds
    builds1 = _build_counts()
    times, metrics, _, tracer, prof = _measured_rounds(api, rounds,
                                                       args.profile_dir)
    steady = _builds_since(builds1)
    peak_mem = _peak_memory_gb(device)
    round_s = float(np.median(times))
    rph = 3600.0 / round_s
    binfo = api._last_bucket_info["bucket"]
    tokens_round = binfo["true_steps"] * bs * T
    analytic = _lm_analytic_flops_per_token(d, L_layers, T, V)
    step_flops = train_step_flops(
        api.spec, api.cfg, {"x": ((bs, T), torch.int32),
                            "y": ((bs, T), torch.int64),
                            "mask": ((bs,), torch.float32)})
    # executed client-steps include the padded ones: the device's load
    executed_flops = step_flops * binfo["executed_steps"]
    achieved = executed_flops / round_s
    fields, peak = _device_fields(device)
    smoke = args.smoke or device.type != "cuda"
    return {
        "metric": (f"federated-LM rounds/hour (TransformerLM d{d} "
                   f"L{L_layers} T{T} V{V}, bf16 flash-attn, {C} clients, "
                   f"bs{bs}, {args.lm_epochs} local epochs)"
                   + (_SMOKE_TAG if smoke else "")),
        "value": round(rph, 2),
        "unit": "rounds/hour",
        "lm_rounds_per_hour": round(rph, 2),
        "round_s": round(round_s, 3),
        "round_times_s": [round(t, 3) for t in times],
        "rounds_measured": rounds,
        "tokens_per_round": int(tokens_round),
        "tokens_per_s": round(tokens_round / round_s),
        "executed_flops": executed_flops,
        "achieved_tflops": (None if peak is None
                            else round(achieved / 1e12, 3)),
        "mfu": None if peak is None else round(achieved / peak, 6),
        "flops_source": FLOPS_SOURCE,
        "analytic_flops_per_token": analytic,
        "assumed_peak_tflops": None if peak is None else peak / 1e12,
        "compile_s": round(compile_s, 2),
        "warmup_compiles": warm["builds"],
        "warmup_compile_s": round(warm["seconds"], 2),
        "warmup_cache_hits": warm["cached"],
        "warmup_cache_misses": warm["builds"],
        "steady_compiles": steady["builds"],
        **warm_fields,
        "bucket_shapes": binfo["buckets_used"],
        "bucket_waste_frac": metrics[-1].get("bucket/waste_frac"),
        "train_loss": round(float(metrics[-1]["Train/Loss"]), 4),
        "n_params": sum(int(v.numel())
                        for v in api.global_state["params"].values()),
        **fields,
        **_host_fields(),
        "peak_memory_gb": peak_mem,
        **_phase_fields(tracer, rounds),
        **prof,
        "train_flops_per_token_step_cost": step_flops / (bs * T),
        "step_cost_vs_analytic": round(step_flops / (bs * T) / analytic, 3),
    }


# ---------------------------------------------------------------------------
# the massive cohort
# ---------------------------------------------------------------------------
def _ragged_lr_clients(clients, dim=16, classes=4, seed=0):
    """A ragged population (``bench.py``'s ``_ragged_lr_clients``, byte
    for byte): lognormal shard sizes clipped to 1-400, one draw of
    features and labels for the whole population, then per-client
    views; the 8-tuple with the first 256 samples as the test set."""
    rng = np.random.default_rng(seed)
    ns = np.clip(rng.lognormal(mean=2.0, sigma=1.0, size=clients),
                 1, 400).astype(np.int64)
    total = int(ns.sum())
    x = rng.standard_normal((total, dim)).astype(np.float32)
    y = rng.integers(0, classes, total).astype(np.int32)
    local, local_num = {}, {}
    off = 0
    for c in range(clients):
        n = int(ns[c])
        local[c] = {"x": x[off:off + n], "y": y[off:off + n]}
        local_num[c] = n
        off += n
    test = {"x": x[:256], "y": y[:256]}
    return [total, len(test["y"]), {"x": x, "y": y}, test, local_num,
            local, {0: test}, classes]


def _bucket_flops(api, per_bucket, bs, dim):
    """FLOPs of the round's used bucket edges: one single-client step,
    counted once (its shape does not depend on the edge), times each
    edge's executed and true client-steps."""
    step = train_step_flops(api.spec, api.cfg, {
        "x": ((bs, dim), torch.float32), "y": ((bs,), torch.int64),
        "mask": ((bs,), torch.float32)})
    rows = [dict(b, flops_per_step=step,
                 executed_flops=step * b["executed_steps"],
                 true_flops=step * b["true_steps"]) for b in per_bucket]
    return (rows, sum(b["executed_flops"] for b in rows),
            sum(b["true_flops"] for b in rows))


def run_massive_cohort(args, device):
    """``--massive_cohort [N]``: a warmup round and ``--rounds`` measured
    rounds of N ragged LR clients streamed through the bucketed path
    (``bench.py``'s ``run_massive_cohort``); buffered async with
    ``--massive_async 1``. The record's headline is clients/s."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.models.linear import LogisticRegression
    from fedml_tpu_torch.parallel.packing import packing_backend

    C, dim, classes, bs = int(args.massive_cohort), 16, 4, 8
    dataset = _ragged_lr_clients(C, dim=dim, classes=classes)
    spec = make_classification_spec(
        LogisticRegression(dim, classes, apply_sigmoid=False))
    run_args = types.SimpleNamespace(
        client_num_in_total=C, client_num_per_round=C,
        comm_round=10 ** 9, epochs=1, batch_size=bs, lr=0.05, wd=0.0,
        client_optimizer="sgd", frequency_of_the_test=10 ** 9, seed=0,
        client_chunk=args.massive_chunk, bucket_edges="geometric",
        async_agg=int(args.massive_async), buffer_k=args.buffer_k,
        staleness_decay=args.staleness_decay, async_window=4,
        device_resident="0", compressor=args.compressor)
    api = FedAvgAPI(dataset, spec, run_args, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    builds0 = _build_counts()
    t0 = time.time()
    api.train_one_round()
    compile_s = time.time() - t0
    warm = _builds_since(builds0)
    rounds = args.rounds
    builds1 = _build_counts()
    times, metrics, _, tracer, prof = _measured_rounds(api, rounds,
                                                       args.profile_dir)
    steady = _builds_since(builds1)
    round_s = float(np.median(times))
    last = metrics[-1]
    binfo = api._last_bucket_info["bucket"]
    per_bucket, exec_f, true_f = _bucket_flops(
        api, [b for b in binfo["per_bucket"] if not b["skipped"]], bs, dim)
    fields, _ = _device_fields(device)
    comp = api.compressor is not None
    out = {
        "metric": (f"massive-cohort clients/sec (bucketed streaming, {C} "
                   "ragged LR clients"
                   + (", async buffered" if args.massive_async else "")
                   + (f", {args.compressor} streaming-EF" if comp else "")
                   + ")" + ("" if device.type == "cuda" else _SMOKE_TAG)),
        "value": round(C / round_s, 1),
        "unit": "clients/sec",
        "compressor": args.compressor if comp else None,
        "clients_per_round": C,
        "rounds_measured": rounds,
        "round_s": round(round_s, 3),
        "round_times_s": [round(t, 3) for t in times],
        "compile_s": round(compile_s, 2),
        "warmup_compiles": warm["builds"],
        "warmup_compile_s": round(warm["seconds"], 2),
        "steady_compiles": steady["builds"],
        "bucket_shapes": binfo["buckets_used"],
        "chunks": binfo["chunks"],
        "bucket_waste_frac": last.get("bucket/waste_frac"),
        "executed_steps": last.get("bucket/executed_steps"),
        "true_steps": last.get("bucket/true_steps"),
        "train_loss": round(float(last["Train/Loss"]), 4),
        "packing_backend": packing_backend(),
        **fields,
        **_host_fields(),
        "peak_memory_gb": _peak_memory_gb(device),
        "per_bucket": per_bucket,
        "executed_flops": exec_f,
        "true_flops": true_f,
        "flops_waste_frac": round(1.0 - true_f / exec_f, 4) if exec_f else None,
        "flops_source": FLOPS_SOURCE if exec_f else "unavailable",
        "achieved_gflops": round(exec_f / round_s / 1e9, 3),
        **_phase_fields(tracer, rounds),
        **prof,
    }
    if args.massive_async:
        out["async"] = {k.split("/", 1)[1]: v for k, v in last.items()
                        if k.startswith("async/")}
    if comp:
        # the uplink of the streaming-EF round (static bytes a client
        # times the cohort)
        out["bytes_on_wire"] = last["bytes_on_wire"]
        out["compression_ratio"] = last["compression_ratio"]
        out["residual_store"] = "dense" if api._ef_store.dense else "sparse"
    return out


# ---------------------------------------------------------------------------
# the compression tools
# ---------------------------------------------------------------------------
#: the codec size gate: the none frame against the JSON lists
CHECK_THRESHOLD = 5.0


def params_to_lists(tree):
    """Tree of arrays -> tree of nested Python lists (the JSON codec the
    binary frames replace; ``fedml_tpu/core/message.py``'s)."""
    if isinstance(tree, dict):
        return {k: params_to_lists(v) for k, v in tree.items()}
    return np.asarray(tree).tolist()


def _json_list_nbytes(params):
    """Bytes of the JSON nested-list codec for this tree."""
    return len(json.dumps(params_to_lists(params)).encode())


def _sweep_state(model_name, device):
    """The ``--sweep_model`` state (``resnet56`` at 10 classes or the
    digits CNN) from the spec's initialisers, seed 0, on ``device``."""
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.models import resnet56
    from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg

    model = (CNNOriginalFedAvg(only_digits=True) if model_name == "cnn"
             else resnet56(class_num=10))
    return make_classification_spec(model).init_fn(0, device)


def reference_variables(state, model_name):
    """The sweep state's params as the reference lays them out: nested
    flax names, conv kernels HWIO, dense kernels ``[in, out]`` (numpy)."""
    from fedml_tpu_torch.utils import torch_import as ti

    if model_name == "cnn":
        return ti.cv_state_to_variables(state)["params"]
    return ti.state_to_variables(state, 56)["params"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_compression_tools(args, device):
    """``--check``: the size gate's record. ``--compression_sweep``: one
    line a spec, printed as it is measured, and a record holding them
    (``rows``). Encoded bytes are one client's update through the codec
    under the reference's names; times are the median of ``--repeats``
    calls on ``device`` after one warm call."""
    from fedml_tpu_torch.compression.codec import (decode_tree, encode_tree,
                                                   tree_wire_nbytes)
    from fedml_tpu_torch.compression.compressors import (get_compressor,
                                                         tree_map)
    from fedml_tpu_torch.utils.torch_import import reference_tree

    state = _sweep_state(args.sweep_model, device)
    params = state["params"]
    ref = reference_variables(state, args.sweep_model)
    n_params = sum(int(v.numel()) for v in params.values())
    raw_binary = tree_wire_nbytes(ref)
    json_bytes = _json_list_nbytes(ref)
    fields, _ = _device_fields(device)
    if args.check:
        ratio = json_bytes / raw_binary
        return {"metric": "codec size regression (none codec vs JSON "
                          f"lists, {args.sweep_model}-sized pytree)",
                "n_params": n_params, "json_list_bytes": json_bytes,
                "binary_bytes": raw_binary, "ratio": round(ratio, 2),
                "threshold": CHECK_THRESHOLD,
                "pass": ratio >= CHECK_THRESHOLD}
    rows = []
    for spec_str in args.compressors.split(","):
        spec_str = spec_str.strip()
        comp = get_compressor(spec_str)
        stacked = {k: v.unsqueeze(0) for k, v in params.items()}
        seeds = np.zeros(1, np.int64)

        def encode():
            return comp.compress(stacked, seeds)

        enc = encode()  # warm
        comp.decompress(enc, params)
        enc_t, dec_t = [], []
        for _ in range(args.repeats):
            _sync(device)
            t0 = time.perf_counter()
            enc = encode()
            _sync(device)
            enc_t.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            comp.decompress(enc, params)
            _sync(device)
            dec_t.append(time.perf_counter() - t0)
        one = tree_map(lambda x: x[0], enc)  # the client's wire form
        wire = encode_tree(reference_tree(one))
        decode_tree(wire)  # the host decode path stays exercised
        row = {"compressor": spec_str, "model": args.sweep_model,
               "n_params": n_params, "encoded_bytes": len(wire),
               "raw_binary_bytes": raw_binary, "json_list_bytes": json_bytes,
               "ratio_vs_binary": round(raw_binary / len(wire), 2),
               "ratio_vs_json": round(json_bytes / len(wire), 2),
               "encode_ms": round(1e3 * float(np.median(enc_t)), 2),
               "decode_ms": round(1e3 * float(np.median(dec_t)), 2),
               **fields}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return {"metric": f"compression sweep ({args.sweep_model}-sized "
                      f"pytree, {len(rows)} compressors)",
            "rows": rows, **fields}


# ---------------------------------------------------------------------------
# the control-plane soaks (host only: sockets and numpy, no device)
# ---------------------------------------------------------------------------
def _soak_report_frame_nbytes(init_params, compressor=None):
    """Exact on-wire bytes of one swarm report frame for this model --
    plain (full params) or compressed (EF delta schema). Static given
    the template: encoded sizes are shape-only for every wire
    compressor, so the plain/compressed byte ratio needs no second
    measurement run."""
    from fedml_tpu_torch.compression.codec import message_to_wire
    from fedml_tpu_torch.compression.wire import (ef_step, encode_rng,
                                                  host_compressor)
    from fedml_tpu_torch.core.message import Message

    params = {k: np.asarray(v, np.float32) for k, v in init_params.items()}
    out = Message("res_report", 1, 0)
    comp = host_compressor(compressor)
    if comp is None:
        out.add("params", params)
    else:
        enc, _dec, _res = ef_step(
            comp, {k: np.zeros_like(v) for k, v in params.items()},
            None, encode_rng((0, 0, 0)))
        out.add("cdelta", enc)
        out.add("compressor", comp.spec)
    out.add("num_samples", 1.0)
    out.add("round", 0)
    out.add("attempt", 0)
    return len(message_to_wire(out))


def _soak_trace_file(args, d, name):
    """The DiurnalTrace JSON the swarms replay: ``--soak_trace diurnal``
    is the built-in curve, dropout-free (every swarm client replies --
    the soak counts reports); any other value is a trace file."""
    if not args.soak_trace:
        return None
    if args.soak_trace != "diurnal":
        return args.soak_trace
    from fedml_tpu_torch.resilience.faults import DiurnalTrace
    return DiurnalTrace.example(dropout=0.0).to_file(os.path.join(d, name))


def run_soak_bench(args):
    """``--soak [N]``: the event-loop control-plane bench (bench.py's
    ``run_soak_bench``, the same record). The headline is reports/s of N
    swarm connections through a real buffered-async server over the
    selector transport, with connection count, bytes a report (and the
    wire reduction under ``--compressor``), the
    ``fed_report_latency_seconds`` tail and the decode seconds a report.
    With a ledger it also prints and appends the decode frames/s row
    and, compressed, the wire-reduction row; the headline record is
    returned (and printed last by :func:`main`)."""
    import tempfile

    from fedml_tpu_torch.net.soak import run_soak
    from fedml_tpu_torch.observability import enable

    n = int(args.soak)
    soak_params = {"w": np.zeros(int(args.soak_params), np.float32)}
    d = tempfile.mkdtemp(prefix="bench_soak_")
    status_path = os.path.join(d, "status.json")
    trace_file = _soak_trace_file(args, d, "soak_trace.json")
    t0 = time.time()
    with enable(perfmon=True, status_path=status_path) as obs:
        server, summary = run_soak(
            n, total_updates=int(args.soak_updates),
            jitter_s=float(args.soak_jitter), trace_path=trace_file,
            join_timeout=max(300.0, n / 10.0),
            decode_workers=int(args.soak_decode_workers),
            init_params=soak_params, compressor=args.compressor)
    wall_s = time.time() - t0
    if server.failed is not None:
        raise RuntimeError(f"eventloop-soak: {server.failed}")
    with open(status_path) as f:
        status = json.load(f)
    if status.get("final") is not True:
        raise RuntimeError(f"eventloop-soak: status.json not final: "
                           f"{status}")
    reports = server.counters["reports"]
    q = obs.registry.histogram_quantile
    # decode-seconds-per-report is the quantity the batched and parallel
    # ingest stage exists to move
    ingest = server.com_manager.ingest_stats()
    decode_s_per_report = (ingest["decode_s"] / ingest["frames"]
                           if ingest["frames"] else None)
    # measured uplink bytes a report against the static plain frame of
    # the same model: wire_reduction is what --compressor buys
    raw_frame = _soak_report_frame_nbytes(soak_params)
    this_frame = _soak_report_frame_nbytes(soak_params, args.compressor)
    measured_per_report = (server.com_manager.bytes_received / reports
                           if reports else None)
    comp_tag = (f", {summary['compressor']} compressed"
                if summary.get("compressor") else "")
    jitter_model = "diurnal-trace" if trace_file else "uniform"
    # the metric string carries the regime (report size, arrival model,
    # compressor): ledger lineages never judge each other across regimes
    out = {
        "metric": f"eventloop-soak reports/sec ({n} connections, "
                  f"{int(args.soak_params)}-float reports, "
                  f"{jitter_model}, async buffered{comp_tag})",
        "value": round(reports / wall_s, 1),
        "unit": "reports/sec",
        "compressor": summary.get("compressor"),
        "soak_params": int(args.soak_params),
        "report_frame_bytes": this_frame,
        "raw_report_frame_bytes": raw_frame,
        "measured_bytes_per_report": (round(measured_per_report, 1)
                                      if measured_per_report else None),
        "wire_reduction": (round(raw_frame / measured_per_report, 2)
                           if measured_per_report else None),
        "connections": summary.get("connections"),
        "connections_per_sec": round(n / wall_s, 1),
        "updates": server.agg.version,
        "reports": reports,
        "wall_s": round(wall_s, 3),
        "report_latency_p50_s": q("fed_report_latency_seconds", 0.5),
        "report_latency_p90_s": q("fed_report_latency_seconds", 0.9),
        "report_latency_p99_s": q("fed_report_latency_seconds", 0.99),
        "sheds": getattr(server.com_manager, "sheds", 0),
        "status_outcome": status.get("outcome"),
        "transport": "eventloop",
        "jitter_model": jitter_model,
        "swarm_dropped": summary.get("dropped", 0),
        "decode_workers": ingest["workers"],
        "ingest_frames": ingest["frames"],
        "ingest_decode_s": ingest["decode_s"],
        "decode_s_per_report": (round(decode_s_per_report, 9)
                                if decode_s_per_report else None),
    }
    rows = []
    if ingest["frames"] and ingest["decode_s"] > 0:
        # decode throughput (frames per decode second, higher is
        # better): --check-regress fires on a decode slowdown even when
        # reply jitter masks the wall-clock reports/s
        rows.append({
            "metric": f"eventloop-soak decode frames/sec "
                      f"({n} connections, {int(args.soak_params)}"
                      f"-float reports, {jitter_model}{comp_tag})",
            "value": round(ingest["frames"] / ingest["decode_s"], 1),
            "unit": "frames/decode-sec",
            "decode_workers": ingest["workers"],
            "ingest_frames": ingest["frames"],
            "decode_s_per_report": out["decode_s_per_report"]})
    if out["compressor"] and out["wire_reduction"]:
        # the measured wire reduction as its own one-sided metric
        rows.append({
            "metric": f"eventloop-soak wire reduction "
                      f"({n} connections, {out['compressor']})",
            "value": out["wire_reduction"],
            "unit": "x-vs-plain-frames",
            "report_frame_bytes": out["report_frame_bytes"],
            "raw_report_frame_bytes": out["raw_report_frame_bytes"],
            "measured_bytes_per_report": out["measured_bytes_per_report"]})
    if args.ledger:
        for row in rows:
            print(json.dumps(row), flush=True)
            append_ledger(row, args.ledger)
    return out


def run_tree_soak_bench(args):
    """``--tree_soak [N]``: the process-tree federation bench (bench.py's
    ``run_tree_soak_bench``, the same record). N leaves shard across a
    real tree of edge processes (``--tree_fanout``), each bottom edge
    driving its own soak swarm; the coordinator folds the edges'
    (compressed) upstream reports in this process. The record: leaf
    reports/s through the whole tree, the supervision counters (a clean
    run kills nothing and leaves no zombies) and the per-tier
    ``status.json`` audit -- every tier final, parseable and on the
    program's invariant core (``topology.tree.manifest_core``).
    ``run_tree`` itself appends the tree-soak row and one reports/s row
    per edge to the ledger. Leftover processes fail the bench."""
    import tempfile

    from fedml_tpu_torch.topology import TreeSpec, manifest_core, run_tree

    fanout = tuple(int(f) for f in str(args.tree_fanout).split(","))
    n = int(args.tree_soak)
    leaves_per_edge = max(1, n // int(np.prod(fanout)))
    d = tempfile.mkdtemp(prefix="bench_tree_")
    trace_file = _soak_trace_file(args, d, "tree_trace.json")
    steering = bool(args.tree_steering)
    spec = TreeSpec(
        fanout=fanout, leaves_per_edge=leaves_per_edge,
        total_updates=int(args.soak_updates),
        transport=args.tree_transport, compressor=args.compressor,
        trace=trace_file, jitter_s=float(args.soak_jitter),
        steering=steering,
        # a real edge deadline so outage-dark leaves cannot wedge a
        # round, a flush deadline shorter than the outage so the
        # coordinator's degraded path runs, and a tier envelope the
        # controllers steer inside (the reference's knobs)
        edge_deadline_s=8.0, flush_deadline_s=10.0,
        tier_bounds={"deadline_s": [0.25, 120.0]} if steering else {})
    init_params = {"w": np.zeros(int(args.soak_params), np.float32)}
    t0 = time.time()
    res = run_tree(spec, d, init_params=init_params,
                   join_timeout=max(300.0, n / 5.0),
                   ledger_path=args.ledger or None)
    wall_s = time.time() - t0
    server = res["server"]
    if server.failed is not None:
        raise RuntimeError(f"tree-soak: {server.failed}")
    # one status.json per process in the tree, all final, all on the
    # SAME program core (steered knobs aside)
    expected_statuses = 1 + sum(
        int(np.prod(fanout[:t + 1])) for t in range(len(fanout)))
    cores = []
    for name, st in sorted(res["statuses"].items()):
        if st.get("final") is not True:
            raise RuntimeError(f"tree-soak: {name} is not final")
        cores.append(manifest_core(st["program"]))
    if len(cores) != expected_statuses:
        raise RuntimeError(f"tree-soak: {len(cores)} status files, "
                           f"expected {expected_statuses}")
    if any(c != cores[0] for c in cores):
        raise RuntimeError("tree-soak: program cores diverged")
    if res["zombies"]:
        raise RuntimeError(f"tree-soak: {res['zombies']} zombie processes")
    total_reports = sum(s.get("reports", 0)
                        for ss in res["swarm_summaries"].values()
                        for s in ss)
    jitter_model = "diurnal-trace" if trace_file else "uniform"
    comp_tag = f", {args.compressor} upstream" if args.compressor else ""
    return {
        "metric": f"tree-soak leaf reports/sec through bench "
                  f"({spec.n_leaves} leaves, fanout "
                  f"{'x'.join(map(str, fanout))}, {spec.transport}, "
                  f"{jitter_model}, "
                  f"{'steered' if steering else 'fixed'}{comp_tag})",
        "value": round(total_reports / max(wall_s, 1e-9), 1),
        "unit": "reports/sec",
        "leaves": spec.n_leaves,
        "fanout": list(fanout),
        "transport": spec.transport,
        "compressor": args.compressor,
        "jitter_model": jitter_model,
        "steering": steering,
        "updates": server.agg.version,
        "reports": total_reports,
        "statuses": len(cores),
        "program_cores_match": True,
        "respawned": res["respawned"],
        "killed": res["killed"],
        "zombies": res["zombies"],
        "clients_dropped": server.counters["clients_dropped"],
        "clients_rejoined": server.counters["clients_rejoined"],
        "wall_s": round(wall_s, 3),
    }


# ---------------------------------------------------------------------------
# pace steering
# ---------------------------------------------------------------------------
def _quality_rel(final, ref):
    """Max relative leaf deviation between two parameter trees (the
    steering bench's convergence-within-tolerance metric)."""
    num = max(float(np.max(np.abs(np.asarray(final[k], np.float64)
                                  - np.asarray(ref[k], np.float64))))
              for k in ref)
    den = max(max(float(np.max(np.abs(np.asarray(v, np.float64))))
                  for v in ref.values()), 1e-9)
    return num / den


def run_steering_bench(args):
    """``--steering``: bench.py's ``run_steering_bench`` (the same
    record and pass rule). One seeded diurnal trace, a sweep of fixed
    (deadline, overselect) configurations and one steered run, all over
    ``run_tcp_fedavg`` with the perf monitor armed so the controller
    reads live ``fed_report_latency_seconds`` windows. A fixed deadline
    must outlast the outage (shorter ones abandon the round past its
    retries and fail the run) and then pays it on every night round,
    whose correlated dropouts hold the round to its deadline; the
    steered run backs off through the outage and tightens to the night's
    tail. Returns the record; it passes when the steered run's final
    model is within ``--steering_quality_tol`` of the unshaped reference
    and its rounds/hour beat the best qualifying fixed configuration's by
    1.10 or more."""
    import tempfile

    from fedml_tpu_torch.observability import enable
    from fedml_tpu_torch.program.cohort import CohortPolicy
    from fedml_tpu_torch.resilience import (PaceBounds, PaceController,
                                            run_tcp_fedavg)
    from fedml_tpu_torch.resilience.faults import (DiurnalTrace, LoadPhase,
                                                   TraceLoadGen)

    scale = float(args.steering_scale)
    if args.steering_trace:
        trace = DiurnalTrace.from_file(args.steering_trace)
    else:
        # one shot: day, flash crowd, outage, then night to the end of
        # the run (repeat=False), so every round past the outage is a
        # night round for every configuration
        trace = DiurnalTrace([
            LoadPhase(dur_s=0.15 * scale, delay_s=0.05, jitter=0.5,
                      name="day"),
            LoadPhase(dur_s=0.1 * scale, delay_s=0.02, jitter=0.5,
                      name="flash"),
            LoadPhase(dur_s=5.5 * scale, delay_s=1.5, jitter=0.2,
                      name="outage"),
            LoadPhase(dur_s=600.0, delay_s=0.3, jitter=0.5,
                      dropout_p=0.5, name="night"),
        ], repeat=False, seed=args.steering_seed)
    world = 9
    cohort_target = 5
    quorum = 0.5
    rounds = int(args.steering_rounds)
    transport = args.steering_transport
    w0 = {"w": np.zeros((8, 8), np.float32), "b": np.ones(8, np.float32)}
    population = list(range(1, world))
    join_timeout = max(240.0, 60.0 * scale * rounds)

    def one_run(policy, pace=None, shaped=True):
        gen = (TraceLoadGen(trace, seed=args.steering_seed,
                            population=population) if shaped else None)
        d = tempfile.mkdtemp(prefix="bench_steering_")
        t0 = time.time()
        with enable(perfmon=True, flightrec_dir=d, compile_events=False):
            if gen is not None:
                gen.reset_epoch()
            try:
                srv = run_tcp_fedavg(
                    world, rounds, policy, w0, fault_plan=gen,
                    cohort_target=cohort_target, transport=transport,
                    pace_controller=pace, join_timeout=join_timeout)
            except TimeoutError as e:
                return {"failed": f"hung: {e}",
                        "wall_s": round(time.time() - t0, 3)}
        wall = time.time() - t0
        out = {"wall_s": round(wall, 3),
               "rounds_completed": len(srv.history),
               "degraded": srv.counters["rounds_degraded"],
               "abandoned": srv.counters["rounds_abandoned"]}
        if srv.failed is not None or len(srv.history) < rounds:
            out["failed"] = srv.failed or "incomplete"
            return out
        out["rph"] = round(rounds / wall * 3600.0, 2)
        out["final"] = srv.history[-1]
        return out

    # the unshaped full-participation run: the convergence yardstick
    ref = one_run(CohortPolicy(deadline_s=30.0, quorum=quorum),
                  shaped=False)
    if "rph" not in ref:
        raise RuntimeError(f"reference run failed: {ref}")

    quality_tol = float(args.steering_quality_tol)
    fixed = []
    for d_s, eps in [(0.6, 0.6), (1.2, 0.0), (2.5, 0.6)]:
        r = one_run(CohortPolicy(deadline_s=d_s, overselect=eps,
                                  quorum=quorum))
        r["config"] = {"deadline_s": d_s, "overselect": eps}
        if "rph" in r:
            r["quality_rel"] = round(_quality_rel(r.pop("final"),
                                                  ref["final"]), 4)
        fixed.append(r)
        print(f"# fixed {r['config']}: "
              + (f"{r['rph']} rph, quality {r['quality_rel']}"
                 if "rph" in r else f"FAILED ({r['failed']})"),
              file=sys.stderr)

    pace = PaceController(
        PaceBounds(deadline_s=(0.25, 8.0), overselect=(0.0, 1.0)),
        seed=args.steering_seed, deadline_s=1.0, overselect=0.0)
    steered = one_run(CohortPolicy(deadline_s=1.0, quorum=quorum),
                      pace=pace)
    if "rph" not in steered:
        raise RuntimeError(f"steered run failed: {steered.get('failed')}")
    steered["quality_rel"] = round(_quality_rel(steered.pop("final"),
                                                ref["final"]), 4)

    qualified = [r for r in fixed
                 if "rph" in r and r["quality_rel"] <= quality_tol]
    best_fixed = (max(qualified, key=lambda r: r["rph"]) if qualified
                  else None)
    speedup = (round(steered["rph"] / best_fixed["rph"], 3)
               if best_fixed else None)
    threshold = 1.10  # the gate: at least 10% more rounds/hour
    ok = (steered["quality_rel"] <= quality_tol and best_fixed is not None
          and speedup is not None and speedup >= threshold)
    return {
        "metric": (f"fedpace steered rounds/hour (seeded diurnal trace "
                   f"x{scale}, {transport}, {world - 1} clients, "
                   f"target {cohort_target})"),
        "value": steered["rph"],
        "unit": "rounds/hour",
        "rounds": rounds,
        "steered": steered,
        "pace_decisions": len(pace.decisions),
        "pace_final": {"deadline_s": pace.deadline_s,
                       "overselect": pace.overselect},
        "fixed_sweep": fixed,
        "best_fixed_rph": best_fixed["rph"] if best_fixed else None,
        "best_fixed_config": best_fixed["config"] if best_fixed else None,
        "speedup_vs_best_fixed": speedup,
        "speedup_threshold": threshold,
        "quality_tol": quality_tol,
        "trace": trace.to_dict(),
        "transport": transport,
        "pass": ok,
    }


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
def _parser():
    p = argparse.ArgumentParser(
        prog="python -m fedml_tpu_torch.bench", allow_abbrev=False,
        description="FedAvg rounds/hour of the flagship recipes on the "
                    "card (one JSON record)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes to validate the bench path quickly "
                        "(result is NOT comparable to the baseline)")
    p.add_argument("--rounds", type=int, default=3,
                   help="measured rounds (after one warmup round)")
    p.add_argument("--epochs", type=int, default=FLAGSHIP_EPOCHS)
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--client_chunk", type=int, default=8,
                   help="clients trained at once (packed lanes)")
    p.add_argument("--mode", type=int, default=3, choices=(0, 1, 2, 3),
                   help="3 = packed lanes (the lane axis folded into "
                        "channels, models/lane_packed.py), 2 = vmap "
                        "lanes, 1 = size-sorted waves, 0 = flat")
    p.add_argument("--flat", action="store_true",
                   help="the flat round (--mode 0)")
    p.add_argument("--no_augment", action="store_true",
                   help="drop the recipe's crop/flip/Cutout augmentation")
    p.add_argument("--lane_lowering", default=None,
                   choices=("auto", "blockdiag", "bgc", "pallas"),
                   help="mode-3 per-lane conv strategy "
                        "(models/lane_packed.py): blockdiag (default); "
                        "bgc = batch-group convs everywhere; auto = bgc "
                        "for Ci<=32 stages, blockdiag for Ci=64; pallas = "
                        "bgc forward with the hand-written dW kernel on "
                        "the backward (ops/grouped_conv.py)")
    p.add_argument("--device_dtype", type=str, default=None,
                   choices=("bf16", "bfloat16"),
                   help="halve the device residency of the image data")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "measured rounds and record the card's busy "
                        "share of them")
    p.add_argument("--algo", choices=("fedavg", "fedopt"), default="fedavg",
                   help="fedopt: the ResNet recipe with server Adam on "
                        "the pseudo-gradient (server lr 0.001)")
    p.add_argument("--lm", action="store_true",
                   help="the federated LM flagship: LEAF-Shakespeare-"
                        "shaped TransformerLM through the bucketed "
                        "streaming engine and the flash-attention "
                        "kernels")
    p.add_argument("--lm_clients", type=int, default=32)
    p.add_argument("--lm_batch", type=int, default=4,
                   help="LM bench: sequences per local step")
    p.add_argument("--lm_epochs", type=int, default=1,
                   help="LM bench: local epochs per round (LEAF recipe)")
    p.add_argument("--lm_d_model", type=int, default=512,
                   help="LM bench: model width (heads of dim 128)")
    p.add_argument("--lm_layers", type=int, default=4)
    p.add_argument("--lm_seq", type=int, default=None,
                   help="LM bench: sequence length (default: the LEAF "
                        "Shakespeare 80-char window)")
    p.add_argument("--lm_chunk", type=int, default=8,
                   help="LM bench: clients per streamed chunk")
    p.add_argument("--lm_data_dir", type=str, default=None,
                   help="LM bench: real Shakespeare data (TFF h5 layout; "
                        "--lm_leaf 1 for LEAF JSON). Default: synthetic "
                        "LEAF-shaped shards")
    p.add_argument("--lm_leaf", type=int, default=0)
    p.add_argument("--massive_cohort", nargs="?", const=50_000, type=int,
                   default=None, metavar="N",
                   help="bucketed-streaming massive-cohort bench: rounds "
                        "of N (default 50,000) ragged simulated LR "
                        "clients on one card; the headline is clients/s")
    p.add_argument("--massive_async", type=int, default=0,
                   help="massive-cohort bench: the buffered async "
                        "aggregation path (--buffer_k/--staleness_decay)")
    p.add_argument("--massive_chunk", type=int, default=128,
                   help="massive-cohort bench: clients per streamed chunk")
    p.add_argument("--buffer_k", type=int, default=2048,
                   help="massive-cohort bench: async buffer K")
    p.add_argument("--staleness_decay", type=float, default=0.5,
                   help="massive-cohort bench: async staleness exponent")
    p.add_argument("--soak", nargs="?", const=1000, type=int,
                   default=None, metavar="N",
                   help="event-loop soak bench (net/soak.py): one host "
                        "drives N (default 1,000) swarm connections "
                        "through a real buffered-async server over the "
                        "selector transport; the record has "
                        "connections/s, reports/s and the "
                        "fed_report_latency_seconds tail (p50/p90/p99). "
                        "Host only: no device")
    p.add_argument("--soak_updates", type=int, default=3,
                   help="soak bench: async server updates (flush windows)")
    p.add_argument("--soak_jitter", type=float, default=0.5,
                   help="soak bench: max seeded per-report reply jitter "
                        "in seconds (the latency histogram's tail)")
    p.add_argument("--soak_trace", type=str, default=None,
                   help="soak bench: replay a DiurnalTrace JSON file as "
                        "the swarm's reply model instead of uniform "
                        "--soak_jitter ('diurnal' = the built-in "
                        "day/outage/night/flash curve, dropout-free)")
    p.add_argument("--soak_params", type=int, default=16384,
                   help="soak bench: model floats a report (the payload "
                        "is about 4x this in bytes uncompressed)")
    p.add_argument("--soak_decode_workers", type=int, default=1,
                   help="soak bench: parallel frame-decode workers on "
                        "the server transport (net/ingest.py DecodeStage; "
                        "1 = inline dispatcher decode). Trajectories are "
                        "identical at any setting")
    p.add_argument("--tree_soak", nargs="?", const=1000, type=int,
                   default=None, metavar="N",
                   help="process-tree soak bench (topology/): N (default "
                        "1,000) leaves sharded across a real tree of edge "
                        "processes (--tree_fanout), the coordinator "
                        "folding the edges' upstream reports in this "
                        "process; audits every tier's status.json. "
                        "Reuses --soak_updates/--soak_jitter/"
                        "--soak_trace/--soak_params/--compressor. Host "
                        "only: no device")
    p.add_argument("--tree_fanout", type=str, default="2",
                   help="tree soak: comma-separated edge fan-out per "
                        "tier, root-first ('2' = 2 edges; '2,2' = "
                        "edges-of-edges, 4 bottom edges)")
    p.add_argument("--tree_transport", default="eventloop",
                   choices=("tcp", "eventloop"),
                   help="tree soak: transport for every star in the tree")
    p.add_argument("--tree_steering", action="store_true",
                   help="tree soak: arm one PaceController per tier "
                        "(coordinator + every edge), edge bounds "
                        "clamped inside the coordinator's envelope")
    p.add_argument("--compressor", type=str, default=None,
                   help="compression spec (e.g. 'qsgd', 'topk:0.1', "
                        "'signsgd'). --soak: swarm clients ship "
                        "EF-compressed report deltas over the event-loop "
                        "wire; --tree_soak: the coordinator-facing edge "
                        "hop compresses; --massive_cohort: streamed with "
                        "error feedback in the chunk")
    p.add_argument("--compression_sweep", action="store_true",
                   help="measure each --compressors spec on a "
                        "--sweep_model pytree (encoded bytes, encode and "
                        "decode ms on the device)")
    p.add_argument("--check", action="store_true",
                   help="size-regression gate: the binary none-codec "
                        "frame must be >=5x smaller than the JSON-list "
                        "path (exit 1 on regression)")
    p.add_argument("--sweep_model", choices=("resnet56", "cnn"),
                   default="resnet56")
    p.add_argument("--compressors", type=str,
                   default="none,topk:0.01,topk:0.1,randk:0.1,qsgd:8,"
                           "signsgd",
                   help="comma-separated specs for --compression_sweep")
    p.add_argument("--repeats", type=int, default=5,
                   help="timing repeats a spec in --compression_sweep")
    p.add_argument("--steering", action="store_true",
                   help="pace-steering bench (resilience/steering.py): on "
                        "one seeded diurnal trace, a sweep of fixed "
                        "(deadline, overselect) configurations and one "
                        "steered run over the real control plane; the "
                        "record has the steered rounds/hour, the best "
                        "surviving fixed configuration's and the speedup, "
                        "passing at >= 1.10x with the final model within "
                        "--steering_quality_tol. Host only: no device")
    p.add_argument("--steering_rounds", type=int, default=20,
                   help="steering bench: federated rounds per run")
    p.add_argument("--steering_scale", type=float, default=1.0,
                   help="steering bench: trace duration multiplier "
                        "(smaller = faster, noisier)")
    p.add_argument("--steering_seed", type=int, default=7,
                   help="steering bench: trace/load-generator seed")
    p.add_argument("--steering_trace", type=str, default=None,
                   help="steering bench: DiurnalTrace JSON file to "
                        "replay (default: the built-in curve)")
    p.add_argument("--steering_transport", default="tcp",
                   choices=("tcp", "eventloop"),
                   help="steering bench: control-plane transport")
    p.add_argument("--steering_quality_tol", type=float, default=0.5,
                   help="steering bench: max relative final-model "
                        "deviation from the unshaped full-participation "
                        "run for a run to qualify")
    p.add_argument("--warmup", type=int, default=0,
                   help="build the run's kernel libraries before the "
                        "warmup round (fedml_tpu_torch.compile); the "
                        "record adds warmup_programs and warmup_seconds")
    p.add_argument("--compile_cache_dir", type=str, default=None,
                   help="build and load the kernel libraries in this "
                        "directory instead of build/ "
                        "(utils/compile_cache.py)")
    p.add_argument("--ledger", type=str,
                   default="bench_results/torch_ledger.jsonl",
                   help="perf-regression ledger of the port: every run "
                        "appends its record here (JSONL; '' disables)")
    p.add_argument("--check-regress", "--check_regress",
                   dest="check_regress", action="store_true",
                   help="judge the ledger's newest record of each metric "
                        "against the median of its predecessors; exit 1 "
                        "below median*(1-band). Touches no device")
    p.add_argument("--regress_band", type=float, default=None,
                   help="noise band for --check-regress (default 0.15)")
    p.add_argument("--platform", choices=("default", "cpu"),
                   default="default",
                   help="cpu runs on the CPU (a smoke of the path; its "
                        "numbers are no device metric)")
    return p


def _refusal(args, unknown):
    """Why the command line asks for something the port does not run,
    or None."""
    for tok in unknown:
        if tok.startswith("--"):
            return (f"{tok.split('=', 1)[0]} is not a flag of the port's "
                    "bench")
    if args.rounds < 1:
        return f"--rounds {args.rounds}: measure at least 1 round"
    if args.compressor is not None and not (
            args.massive_cohort or args.soak or args.tree_soak):
        return ("--compressor applies to --massive_cohort, --soak and "
                "--tree_soak")
    if args.repeats < 1:
        return f"--repeats {args.repeats}: time at least 1 call"
    return None


def main(argv=None):
    """Run the bench for ``argv`` (default ``sys.argv[1:]``); prints and
    returns one record (a failure record carries ``error``)."""
    args, unknown = _parser().parse_known_args(argv)
    tools = args.compression_sweep or args.check
    # the control-plane benches run on the host alone, before the
    # flagship recipes
    soak = (None if tools else run_steering_bench if args.steering
            else run_soak_bench if args.soak
            else run_tree_soak_bench if args.tree_soak else None)
    metric = ("compression tools" if tools
              else _STEERING_FAILURE_METRIC if args.steering
              else "eventloop-soak" if args.soak
              else "tree-soak" if args.tree_soak
              else _MASSIVE_FAILURE_METRIC if args.massive_cohort
              else _LM_FAILURE_METRIC if args.lm
              else _FAILURE_METRIC.replace("FedAvg", "FedOpt")
              if args.algo == "fedopt" else _FAILURE_METRIC)
    refusal = _refusal(args, unknown)
    if refusal is not None:
        return emit_failure(refusal, metric)
    if args.check_regress:
        band = (args.regress_band if args.regress_band is not None
                else DEFAULT_REGRESS_BAND)
        ok, detail = check_regression(args.ledger, band=band)
        print(json.dumps(detail), flush=True)
        return detail
    # compile + warmup + measured rounds at a ceiling of 5 min a round
    budget_s = max(45 * 60, 5 * 60 + (args.rounds + 1) * 5 * 60)
    watchdog = arm_watchdog(budget_s, f"{args.rounds} rounds", metric)
    try:
        with compilation_cache(args.compile_cache_dir):
            if soak is not None:
                record = soak(args)
            else:
                device = (torch.device("cpu") if args.platform == "cpu"
                          else resolve_device(None))
                run = (run_compression_tools if tools
                       else run_massive_cohort if args.massive_cohort
                       else run_lm_bench if args.lm else run_resnet_bench)
                record = run(args, device)
    except Exception:  # the one-line contract: report, then fail
        traceback.print_exc()
        return emit_failure(traceback.format_exc(limit=3)[-800:], metric)
    finally:
        watchdog.cancel()
    if args.compile_cache_dir is not None:
        record["compile_cache_dir"] = args.compile_cache_dir
    print(json.dumps(record), flush=True)
    # run_tree appends the tree soak's own rows
    if args.ledger and not tools and soak is not run_tree_soak_bench:
        append_ledger(record, args.ledger)
    return record


def _exit_code(record):
    return 1 if "error" in record or record.get("pass") is False else 0


if __name__ == "__main__":
    sys.exit(_exit_code(main()))
