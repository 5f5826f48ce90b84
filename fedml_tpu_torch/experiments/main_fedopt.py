"""FedOpt experiment main (counterpart of
``fedml_tpu/experiments/main_fedopt.py``), on the card:

    python -m fedml_tpu_torch.experiments.main_fedopt --dataset synthetic \
        --model lr --server_optimizer adam
    python -m fedml_tpu_torch.experiments.main_fedopt --platform cpu ...

``--server_optimizer`` sgd (FedAvgM), adam (FedAdam), adagrad or yogi.
``main(argv)`` returns ``(api, global_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("FedOpt-torch")
    common.add_base_args(p)
    p.add_argument("--server_optimizer", type=str, default="sgd",
                   help="sgd (FedAvgM) | adam (FedAdam) | adagrad | yogi")
    p.add_argument("--server_lr", type=float, default=0.1)
    p.add_argument("--server_momentum", type=float, default=0.9)
    return p


def main(argv=None):
    args, device, logger, dataset, spec = common.prepare(
        parser(), argv, lambda a: f"FedOpt-{a.server_optimizer}")

    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
    api = FedOptAPI(dataset, spec, args, device=device,
                    mesh=common.make_mesh(args, device),
                    metrics_logger=logger)
    state = common.run_fedavg_family(api, args, logger)
    logger.close()
    return api, state


if __name__ == "__main__":
    main()
