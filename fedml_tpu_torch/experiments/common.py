"""Shared plumbing of the port's experiment mains (counterpart of
``fedml_tpu/experiments/common.py``): the reference's flags with their
names and defaults, setup, the dataset and model switch, the spec choice
and the run loop.

Every flag of the reference parses, so its command lines run here. A
flag whose path is not ported (``--mesh``) refuses a non-default value
with ``NotImplementedError`` naming its ROADMAP item
(:func:`refuse_unported`). The run goes to the card; ``--platform cpu``
asks for the CPU, and without a card and without it the main raises
(:func:`device_for`).

The run-time tooling wraps ``api.train`` in :func:`run_fedavg_family`:
``--warmup`` builds the kernel libraries before the loop, then the
observability switchboard (:func:`observability_scope`: ``--trace``,
``--flightrec``, ``--perfmon`` with ``--status_path`` and
``--xprof_round``, ``--costmodel``), ``--profile_dir``, the race audit
(:func:`race_audit_scope`) and the runtime audit (:func:`audit_scope`)
nest around it, as in the reference.
"""

from __future__ import annotations

import argparse
import logging
import random

import numpy as np
import torch

from fedml_tpu_torch.resilience.integration import add_resilience_args
from fedml_tpu_torch.resilience.steering import add_steering_args

#: the segmentation sets (``main_fedseg`` trains them)
SEGMENTATION_SETS = ("synthetic_segmentation", "pascal_voc", "coco_seg")
#: flag -> (value that runs, the ROADMAP item a change waits for)
_UNPORTED = {
    "mesh": (0, "ROADMAP A15 (multi-device)"),
}


def add_base_args(parser: argparse.ArgumentParser):
    """The reference's flags (``fedml_tpu/experiments/common.py
    add_base_args`` with the resilience, async, steering and
    observability groups), same names and defaults."""
    p = parser
    p.add_argument("--model", type=str, default="lr",
                   help="model name (models/factory.py)")
    p.add_argument("--dataset", type=str, default="synthetic",
                   help="dataset name (data/registry.py)")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--partition_method", type=str, default="hetero",
                   help="homo | hetero (LDA) | hetero-fix")
    p.add_argument("--partition_alpha", type=float, default=0.5)
    p.add_argument("--client_num_in_total", type=int, default=10)
    p.add_argument("--client_num_per_round", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--client_optimizer", type=str, default="sgd")
    p.add_argument("--lr", type=float, default=0.03)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=1,
                   help="local epochs per round")
    p.add_argument("--comm_round", type=int, default=10)
    p.add_argument("--is_mobile", type=int, default=0,
                   help="accepted for parity; ignored")
    p.add_argument("--frequency_of_the_test", type=int, default=5)
    p.add_argument("--gpu_server_num", type=int, default=1,
                   help="accepted for parity; ignored")
    p.add_argument("--gpu_num_per_server", type=int, default=1,
                   help="accepted for parity; ignored")
    p.add_argument("--ci", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_augmentation", type=int, default=1,
                   help="train-time crop/flip/Cutout for the CIFAR family "
                        "on the device; 0 disables")
    p.add_argument("--mesh", type=int, default=0,
                   help="multi-device rounds: not ported (ROADMAP A15)")
    p.add_argument("--wave_mode", type=int, default=1, choices=(0, 1, 2, 3),
                   help="device-resident rounds: 3 = packed lanes (falls "
                        "back to 2 without a packed lowering), 2 = vmap "
                        "lanes, 1 = size-sorted waves (default), 0 = flat")
    p.add_argument("--client_chunk", type=int, default=8,
                   help="clients trained at once on the device-resident "
                        "path (activation-memory knob)")
    p.add_argument("--device_resident", type=str, default="auto",
                   help="auto | 0: keep client shards on the device when "
                        "they fit --device_data_cap_gb")
    p.add_argument("--device_data_cap_gb", type=float, default=2.0)
    p.add_argument("--device_dtype", type=str, default=None,
                   choices=("bf16", "bfloat16"),
                   help="keep resident floating image data in bfloat16")
    p.add_argument("--compressor", type=str, default=None,
                   help="client-update compression spec: none | topk:R | "
                        "randk:R | qsgd:BITS | signsgd; error feedback per "
                        "client, bytes_on_wire / compression_ratio in every "
                        "round record; default off")
    p.add_argument("--moe_experts", type=int, default=8,
                   help="expert count of --model moe_transformer")
    p.add_argument("--model_dtype", type=str, default=None,
                   choices=("bf16", "bfloat16"),
                   help="bf16 compute with fp32 master parameters")
    p.add_argument("--platform", type=str, default=None,
                   help="cpu runs on the CPU; default the card")
    p.add_argument("--run_dir", type=str, default=None,
                   help="metrics.jsonl / summary.json / config.json dir")
    p.add_argument("--enable_wandb", type=int, default=0)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--save_frequency", type=int, default=10,
                   help="checkpoint every N rounds")
    p.add_argument("--resume", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the round loop")
    p.add_argument("--audit", type=int, default=0)
    p.add_argument("--compile_cache_dir", type=str, default=None)
    p.add_argument("--warmup", type=int, default=0)
    add_resilience_args(p)
    # buffered async aggregation and bucketed streaming
    p.add_argument("--async_agg", type=int, default=0,
                   help="FedBuff buffered async aggregation on the bucketed "
                        "streaming path (turns it on by itself)")
    p.add_argument("--buffer_k", type=int, default=64,
                   help="async: client updates per server update")
    p.add_argument("--staleness_decay", type=float, default=0.5,
                   help="async: an update s versions stale weighs "
                        "(1+s)**-a")
    p.add_argument("--flush_deadline", type=float, default=0.0,
                   help="async: parsed into the policy; a simulated round "
                        "flushes on --buffer_k and at its end only")
    p.add_argument("--async_window", type=int, default=4,
                   help="async: chunks in flight before the oldest folds")
    p.add_argument("--bucket_edges", type=str, default=None,
                   help="bucketed ragged streaming: 'geometric' or a comma "
                        "list of local-step edges")
    add_steering_args(p)
    # observability
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--trace_dir", type=str, default=None)
    p.add_argument("--flightrec", type=int, default=0)
    p.add_argument("--perfmon", type=int, default=0)
    p.add_argument("--status_path", type=str, default=None)
    p.add_argument("--xprof_round", type=int, default=None)
    p.add_argument("--xprof_dir", type=str, default=None)
    p.add_argument("--costmodel", type=int, default=0)
    # synthetic-dataset size overrides
    p.add_argument("--n_train", type=int, default=None)
    p.add_argument("--n_test", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    return p


def refuse_unported(args):
    """Raise ``NotImplementedError`` naming the ROADMAP item of the first
    flag set to a value whose path the port does not run."""
    for name, (runs, item) in _UNPORTED.items():
        if getattr(args, name, runs) != runs:
            raise NotImplementedError(f"--{name} waits for {item}")
    if getattr(args, "platform", None) not in (None, "cpu"):
        raise ValueError(f"--platform {args.platform!r}: the port runs on "
                         "the card (default) or, asked, on the cpu")


def device_for(args) -> torch.device:
    """The card unless ``--platform cpu``; raises without a card."""
    from fedml_tpu_torch.utils.device import resolve_device

    return resolve_device("cpu" if getattr(args, "platform", None) == "cpu"
                          else None)


def setup(args, run_name=None):
    """Logging, seeds and the metrics sink (``--run_dir``, mirrored to
    wandb under ``--enable_wandb`` where it imports)."""
    from fedml_tpu_torch.utils.metrics import MetricsLogger, init_logging

    init_logging(proctitle=run_name)
    logging.info("args = %s", vars(args))
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    return MetricsLogger(run_dir=args.run_dir,
                         enable_wandb=bool(getattr(args, "enable_wandb", 0)),
                         run_name=run_name, config=args)


def compile_cache_scope(args):
    """The run's kernel build directory (``--compile_cache_dir``, else
    ``build/``), restored when the run ends."""
    from fedml_tpu_torch.utils.compile_cache import compilation_cache

    return compilation_cache(getattr(args, "compile_cache_dir", None))


def audit_scope(args, logger, wired=True):
    """``--audit`` context: arms the runtime auditor
    (``fedml_tpu_torch.analysis.runtime.audit``) with the run's metrics
    sink. Mains whose round loop has no ``end_of_round_sync`` pass
    ``wired=False``: the flag then warns instead of producing a
    zero-round report."""
    from fedml_tpu_torch.analysis.runtime import audit

    enabled = bool(getattr(args, "audit", 0))
    if enabled and not wired:
        logging.warning(
            "--audit is not wired for this entry point (its round loop "
            "has no end_of_round_sync interception point); ignoring the "
            "flag")
        enabled = False
    return audit(metrics_logger=logger, enabled=enabled)


def observability_scope(args, logger):
    """``--trace/--flightrec/--perfmon/--costmodel`` context: arms the
    switchboard (``fedml_tpu_torch.observability.enable``) with the run's
    metrics sink. Exports ``trace.json``/``spans.jsonl`` to
    ``--trace_dir`` (default ``--run_dir``), flight-recorder dumps,
    ``metrics.prom`` and ``status.json`` to ``--run_dir`` (else the trace
    dir), and the ``--xprof_round`` capture to ``--xprof_dir`` (else that
    same directory); a run with every flag off gets the no-op tracer."""
    from fedml_tpu_torch.observability import enable

    trace = bool(getattr(args, "trace", 0))
    run_dir = getattr(args, "run_dir", None)
    trace_dir = getattr(args, "trace_dir", None) or run_dir
    if trace and trace_dir is None:
        trace_dir = "."
        logging.warning("--trace without --trace_dir/--run_dir: exporting "
                        "trace.json/spans.jsonl to the working directory")
    return enable(trace=trace, trace_dir=trace_dir,
                  flightrec=bool(getattr(args, "flightrec", 0)),
                  flightrec_dir=run_dir or trace_dir,
                  metrics_logger=logger,
                  perfmon=bool(getattr(args, "perfmon", 0)),
                  status_path=getattr(args, "status_path", None),
                  xprof_dir=getattr(args, "xprof_dir", None),
                  xprof_round=getattr(args, "xprof_round", None),
                  cost_model=bool(getattr(args, "costmodel", 0)))


def race_audit_scope(args, logger):
    """``--race_audit`` context: arms the concurrency race sanitizer
    (``fedml_tpu_torch.analysis.runtime.race_audit``). The simulated
    rounds are single-threaded and create few locks, so a zero report
    there is honest; the TCP drivers are where it bites."""
    from fedml_tpu_torch.analysis.runtime import race_audit

    return race_audit(enabled=bool(getattr(args, "race_audit", 0)),
                      metrics_logger=logger)


def example_train_data(dataset):
    """The pooled train set, or a non-empty client shard when the loader
    keeps none."""
    global_train = dataset[2]
    if global_train is None or "x" not in global_train:
        global_train = next(d for d in dataset[5].values()
                            if d is not None and len(d["y"]))
    return global_train


def load_dataset_and_model(args):
    """Dataset switch and model factory; the model is sized from one
    sample of the data (a torch module fixes its input width)."""
    from fedml_tpu_torch.data.registry import load_dataset
    from fedml_tpu_torch.models.factory import create_model

    dataset = load_dataset(args, args.dataset)
    x = np.asarray(example_train_data(dataset)["x"])
    model = create_model(args, args.model, output_dim=dataset[7],
                         input_shape=x.shape[1:])
    return dataset, model


def make_spec(args, model, dataset):
    """Task spec by dataset, as the reference chooses it: per-token
    cross-entropy for the sequence sets, the sigmoid multilabel loss for
    ``stackoverflow_lr``, classification otherwise, with the CIFAR
    family's on-device augmentation under ``--data_augmentation``."""
    from fedml_tpu_torch.algorithms import specs

    name = args.dataset
    if name in ("stackoverflow_nwp", "shakespeare", "fed_shakespeare",
                "synthetic_sequences"):
        return specs.make_seq_classification_spec(model)
    if name == "stackoverflow_lr":
        return specs.make_multilabel_spec(model)
    augment_fn = None
    if (getattr(args, "data_augmentation", 0)
            and name in ("cifar10", "cifar100", "cinic10")):
        from fedml_tpu_torch.data.augment import make_cifar_augment
        from fedml_tpu_torch.data.cifar import normalized_black
        augment_fn = make_cifar_augment(pad=4, cutout_length=16,
                                        pad_fill=normalized_black(name))
    return specs.make_classification_spec(model, augment_fn=augment_fn)


def prepare(parser, argv, run_name):
    """A main's common start: parse ``argv``, refuse unported flags,
    resolve the device, set up logging, seeds and the metrics sink, load
    the dataset and build the model and spec. ``run_name(args)`` names
    the run. Returns ``(args, device, logger, dataset, spec)``."""
    args = parser.parse_args(argv)
    refuse_unported(args)
    if args.dataset in SEGMENTATION_SETS:
        raise ValueError(
            f"--dataset {args.dataset}: per-pixel labels train through "
            "main_fedseg (DeepLab and the segmentation spec), not through "
            "a classification main")
    device = device_for(args)
    logger = setup(args, run_name=run_name(args))
    dataset, model = load_dataset_and_model(args)
    spec = make_spec(args, model, dataset)
    return args, device, logger, dataset, spec


def run_fedavg_family(api, args, logger):
    """``api.train`` with the reference's checkpoint wiring and run-time
    tooling: with ``--checkpoint_dir`` the
    config is snapshot, ``--resume`` restores the global state, the
    server state, the run's seed, the batch-shuffle generator and the
    round index from the latest checkpoint (logging ``res/resumes``), and
    a checkpoint is saved every ``--save_frequency`` rounds and at the
    last one. The run builds its kernel libraries in
    ``--compile_cache_dir`` (:func:`compile_cache_scope`); after any
    restore and before the loop, ``--warmup`` builds them all
    (``compile.warmup_api``; its report goes to the sink). The loop runs
    inside the observability scope, ``--profile_dir``'s trace, the race
    audit and the runtime audit, nested as in the reference. Works for
    any API with those attributes and a ``train(on_round=)`` (every
    FedAvg-family main and the centralized trainer)."""
    from fedml_tpu_torch.utils.checkpoint import Checkpointer
    from fedml_tpu_torch.utils.profiling import profile_trace

    ckpt = None
    if args.checkpoint_dir:
        ckpt = Checkpointer(args.checkpoint_dir)
        ckpt.save_config(args)
        if args.resume:
            saved = ckpt.restore(server_state_template=api.server_state,
                                 device=api.device)
            if saved is not None:
                api.global_state = saved["global_state"]
                api.server_state = saved["server_state"]
                if saved["rng"] is not None:
                    api.seed = int(saved["rng"])
                if saved["data_rng"] is not None:
                    api._data_rng = saved["data_rng"]
                api.round_idx = saved["round_idx"]
                logging.info("resumed from round %d", api.round_idx)
                logger({"round": api.round_idx, "res/resumes": 1})

    def on_round(api_, metrics):
        last = api_.round_idx == args.comm_round
        if (ckpt is not None
                and (api_.round_idx % args.save_frequency == 0 or last)):
            ckpt.save(api_.round_idx, api_.global_state,
                      server_state=api_.server_state, rng=api_.seed,
                      metric=metrics.get("Test/Acc"),
                      data_rng=api_._data_rng)

    with compile_cache_scope(args) as cache_dir:
        if getattr(args, "warmup", 0):
            from fedml_tpu_torch.compile import warmup_api
            logger({**warmup_api(api), "warmup/cache_dir": cache_dir})
        with observability_scope(args, logger):
            with profile_trace(args.profile_dir,
                               enabled=args.profile_dir is not None):
                with race_audit_scope(args, logger):
                    with audit_scope(args, logger):
                        api.train(on_round=on_round)
    return api.global_state


__all__ = ["add_base_args", "refuse_unported", "device_for", "setup",
           "compile_cache_scope", "audit_scope", "observability_scope", "race_audit_scope",
           "example_train_data", "load_dataset_and_model", "make_spec",
           "prepare", "run_fedavg_family"]
