"""FedGKT round-latency bench (counterpart of ``scripts/bench_gkt.py``):
seconds a round of ``FedGKTAPI`` at the reference's CIFAR-10 recipe
scale -- ``resnet8_56`` edges, the ResNet-56 tail (9 blocks a stage) on
the server, 50,000 samples over the cohort, 32x32, batch 256, SGD lr
0.01, wd 1e-4 -- the first round (with its warm-up) apart from the
median of ``--rounds`` measured ones. The reference publishes no GKT
wall-clock number, so the record carries no ``vs_baseline``.

Timing: the host clock around each round, which ends in a
synchronise (the round's logits come back to the host); on the card
that is the round's time, with ``--platform cpu`` a CPU run's.

Usage: python -m fedml_tpu_torch.scripts.bench_gkt [--rounds 3]
       [--platform cpu --tiny]
Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
import types

from fedml_tpu_torch.scripts._common import (add_platform_flag, device_of,
                                             device_record, median, sync)


def main(argv=None):
    p = argparse.ArgumentParser("bench_gkt")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--clients", type=int, default=8)
    add_platform_flag(p)
    p.add_argument("--tiny", action="store_true",
                   help="tiny shapes: a smoke, not comparable")
    args = p.parse_args(argv)
    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.data.synthetic import load_synthetic_images
    from fedml_tpu_torch.models.gkt import GKTServerResNet, resnet8_56

    dev = device_of(args)
    if args.tiny:
        n_train, image, bs, blocks = 8 * args.clients * 4, 8, 8, 1
    else:
        n_train, image, bs, blocks = 50_000, 32, 256, 9
    dataset = load_synthetic_images(
        client_num=args.clients, n_train=n_train,
        n_test=max(64, n_train // 50), image_size=image,
        partition="hetero", partition_alpha=0.5, seed=0)
    run_args = types.SimpleNamespace(
        client_num_in_total=args.clients, comm_round=10 ** 9,
        epochs=1, server_epochs=1, batch_size=bs, lr=0.01, wd=0.0001,
        client_optimizer="sgd", temperature=3.0, alpha_distill=1.0,
        seed=0, frequency_of_the_test=10 ** 9, device=dev)
    api = FedGKTAPI(dataset, resnet8_56(class_num=10),
                    GKTServerResNet(n=blocks, num_classes=10), run_args)

    t0 = time.time()
    api.train_one_round()
    sync(dev)
    first_s = time.time() - t0
    times = []
    for _ in range(args.rounds):
        t0 = time.time()
        m = api.train_one_round()
        sync(dev)
        times.append(time.time() - t0)
    med = median(times)
    scale = "SMOKE -- not comparable" if args.tiny else "CIFAR-10-scale"
    rec = {"metric": f"FedGKT round latency ({scale}, {args.clients} "
                     f"clients, bs{bs}, edge resnet8 + server "
                     f"{blocks}-block)",
           "value": med, "unit": "s/round", "rounds_per_hour": 3600.0 / med,
           "first_round_s": first_s, "round_s": times,
           "samples_per_round": n_train,
           "train_acc_last": float(m["Train/Acc"]), **device_record(dev)[0]}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
