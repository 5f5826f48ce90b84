"""Centralized baseline experiment main (counterpart of
``fedml_tpu/experiments/main_centralized.py``): training on the pooled
dataset, for comparisons with federated runs. On the card:

    python -m fedml_tpu_torch.experiments.main_centralized --platform cpu ...

It runs through the FedAvg family's run loop, so ``--checkpoint_dir``
and ``--resume`` work here too. ``main(argv)`` returns ``(trainer,
global_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("Centralized-torch")
    common.add_base_args(p)
    return p


def main(argv=None):
    args, device, logger, dataset, spec = common.prepare(
        parser(), argv, lambda a: "Centralized")

    from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
    trainer = CentralizedTrainer(dataset, spec, args, metrics_logger=logger,
                                 device=device)
    state = common.run_fedavg_family(trainer, args, logger)
    logger.close()
    return trainer, state


if __name__ == "__main__":
    main()
