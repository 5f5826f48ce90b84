"""Robust FedAvg experiment main (counterpart of
``fedml_tpu/experiments/main_fedavg_robust.py``), on the card:

    python -m fedml_tpu_torch.experiments.main_fedavg_robust \
        --dataset synthetic_images --model cnn --platform cpu ...

The first ``--adversary_num`` clients are poisoned (``data/poison.py``);
the defenses are ``--norm_bound`` clipping and ``--stddev`` noise. After
training, ``Backdoor/Acc`` (the attack success rate) goes to the metrics
sink. ``main(argv)`` returns ``(api, global_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("FedAvgRobust-torch")
    common.add_base_args(p)
    # defense knobs
    p.add_argument("--norm_bound", type=float, default=30.0)
    p.add_argument("--stddev", type=float, default=0.025,
                   help="weak-DP Gaussian noise std")
    # threat-model knobs
    p.add_argument("--poison_type", type=str, default="trigger",
                   help="trigger backdoor pattern family")
    p.add_argument("--poison_frac", type=float, default=0.5)
    p.add_argument("--target_label", type=int, default=0)
    p.add_argument("--adversary_num", type=int, default=1)
    return p


def main(argv=None):
    args, device, logger, dataset, spec = common.prepare(
        parser(), argv, lambda a: "FedAvgRobust")

    from fedml_tpu_torch.data.poison import poison_federated_dataset
    dataset, poisoned_test = poison_federated_dataset(
        dataset, adversary_clients=list(range(args.adversary_num)),
        poison_frac=args.poison_frac, target_label=args.target_label,
        seed=args.seed)

    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustAPI
    api = FedAvgRobustAPI(dataset, spec, args, device=device,
                          mesh=common.make_mesh(args, device),
                          metrics_logger=logger,
                          poisoned_test_data=poisoned_test)
    state = common.run_fedavg_family(api, args, logger)
    backdoor = api.evaluate_backdoor()
    logger(backdoor)
    logger.close()
    return api, state


if __name__ == "__main__":
    main()
