"""Long-horizon convergence evidence (counterpart of
``scripts/convergence.py``).

The port's equivalence tests hold one round of each execution mode to
the reference at tiny shapes; what they cannot rule out is a SLOW
divergence: bf16 compute or the lane scheduler bending the training
curve over 100+ rounds. This script runs the flagship recipe's shape
(or a scaled stand-in) for N rounds per config over ``{bf16, fp32} x
{lanes, flat}``, logs per-round Train/Acc and Train/Loss curves as
JSONL, and asserts the plateau (mean train accuracy over the last
``--tail`` rounds) agrees across all configs within ``--tol``.

``lanes`` is ``--wave_mode 2`` (vmap lanes) and ``flat`` 0; ``lanes3``
(``--wave_mode 3``, the packed lanes) is available through
``--configs``. The ResNet runs under the ``blockdiag`` lowering, so no
config launches a hand-written kernel.

Default scale: 8 clients, 512 samples, 16x16 images, 1 local epoch,
depth 14, 100 rounds. ``--flagship``: 32 clients, 50k samples, 32x32,
depth 56, 20 epochs (the card only). ``--tiny``: 2 clients, 128
samples, 8x8, depth 8, 4 rounds, tail 2 (a smoke).

Usage:
  python -m fedml_tpu_torch.scripts.convergence [--rounds N]
      [--outdir bench_results/convergence]
  python -m fedml_tpu_torch.scripts.convergence --flagship
  python -m fedml_tpu_torch.scripts.convergence --platform cpu --tiny
Exit 0 when the plateaus agree, 1 when they diverge.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import torch

from fedml_tpu_torch.scripts._common import (add_platform_flag, device_of,
                                             device_record)

CONFIGS = {"bf16_lanes": ("bf16", 2), "fp32_lanes": ("fp32", 2),
           "bf16_flat": ("bf16", 0), "fp32_flat": ("fp32", 0),
           # wave_mode 3: the packed lanes, held against flat as well
           "bf16_lanes3": ("bf16", 3), "fp32_lanes3": ("fp32", 3)}


def run_config(name, dtype, wave_mode, args, device):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.data.augment import make_cifar_augment
    from fedml_tpu_torch.data.synthetic import load_synthetic_images
    from fedml_tpu_torch.models.resnet import CifarResNet

    dataset = load_synthetic_images(
        client_num=args.clients, n_train=args.n_train,
        n_test=max(64, args.n_train // 50), image_size=args.image,
        partition="hetero", partition_alpha=0.5, seed=0)
    model = CifarResNet(
        depth=args.depth, num_classes=10,
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    spec = make_classification_spec(
        model, augment_fn=make_cifar_augment(
            pad=4 if args.image >= 32 else 2,
            cutout_length=16 if args.image >= 32 else 4),
        lane_lowering="blockdiag")
    run_args = types.SimpleNamespace(
        client_num_in_total=args.clients, client_num_per_round=args.clients,
        comm_round=args.rounds, epochs=args.epochs, batch_size=64,
        lr=args.lr, wd=0.001, client_optimizer="sgd",
        frequency_of_the_test=10 ** 9, seed=0, client_chunk=8,
        wave_mode=wave_mode, device_resident="auto",
        device_data_cap_gb=4.0, device_dtype=None)
    api = FedAvgAPI(dataset, spec, run_args, device=device)

    curve = []
    path = os.path.join(args.outdir, f"{name}.jsonl")
    t0 = time.time()
    with open(path, "w") as f:
        for r in range(args.rounds):
            m = api.train_one_round()
            rec = {"round": r, "train_acc": float(m["Train/Acc"]),
                   "train_loss": float(m["Train/Loss"])}
            curve.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()  # partial curves must survive a killed run
            if r % 10 == 0 or r == args.rounds - 1:
                print(f"  [{name}] round {r}: acc={rec['train_acc']:.4f} "
                      f"loss={rec['train_loss']:.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
    tail = [c["train_acc"] for c in curve[-args.tail:]]
    return {"name": name, "dtype": dtype,
            # from the config name, the rule convergence_summarize uses
            "mode": name.split("_", 1)[1],
            "plateau_acc": sum(tail) / len(tail),
            "final_loss": curve[-1]["train_loss"],
            "rounds": args.rounds, "wall_s": time.time() - t0}


def parser():
    p = argparse.ArgumentParser("convergence")
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--n_train", type=int, default=512)
    p.add_argument("--image", type=int, default=16)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--depth", type=int, default=14,
                   help="CifarResNet depth (6n+2); --flagship forces 56")
    p.add_argument("--lr", type=float, default=0.03)
    p.add_argument("--tail", type=int, default=10,
                   help="plateau = mean train acc over the last N rounds")
    p.add_argument("--tol", type=float, default=0.03,
                   help="max allowed plateau spread across configs")
    p.add_argument("--outdir", default="bench_results/convergence")
    p.add_argument("--flagship", action="store_true",
                   help="full recipe: 32 clients, 50k samples, 32x32, "
                        "20 local epochs (the card)")
    p.add_argument("--tiny", action="store_true",
                   help="2 clients, 128 samples, 8x8, depth 8, 4 rounds, "
                        "tail 2: a smoke")
    add_platform_flag(p)
    p.add_argument("--configs", default="bf16_lanes,fp32_lanes,"
                                        "bf16_flat,fp32_flat")
    return p


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if args.flagship and args.platform == "cpu":
        p.error("--flagship is the full 32-client/50k/20-epoch recipe; "
                "it belongs on the card")
    if args.flagship:
        args.clients, args.n_train, args.image, args.epochs = 32, 50_000, 32, 20
        args.depth = 56
    if args.tiny:
        args.clients, args.n_train, args.image, args.depth = 2, 128, 8, 8
        args.rounds, args.tail = 4, 2
    names = [n.strip() for n in args.configs.split(",")]
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:  # fail BEFORE hours of training, not on the last config
        p.error(f"unknown config(s) {unknown}; choose from "
                f"{sorted(CONFIGS)}")
    device = device_of(args)
    os.makedirs(args.outdir, exist_ok=True)
    results = []
    for name in names:
        dtype, mode = CONFIGS[name]
        print(f"== {name}: dtype={dtype} mode={mode} "
              f"rounds={args.rounds} ==", flush=True)
        results.append(run_config(name, dtype, mode, args, device))

    accs = [r["plateau_acc"] for r in results]
    spread = max(accs) - min(accs)
    summary = {"results": results, "plateau_spread": spread,
               "tol": args.tol, "scale": vars(args) | {"configs": None},
               "agree": spread <= args.tol, **device_record(device)[0]}
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    for r in results:
        print(f"{r['name']:>11}: plateau_acc={r['plateau_acc']:.4f} "
              f"final_loss={r['final_loss']:.4f} wall={r['wall_s']:.1f}s")
    print(f"plateau spread {spread:.4f} (tol {args.tol}): "
          f"{'AGREE' if summary['agree'] else 'DIVERGED'}")
    return summary


if __name__ == "__main__":
    sys.exit(0 if main()["agree"] else 1)
