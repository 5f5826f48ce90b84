"""FedAvg experiment main (counterpart of
``fedml_tpu/experiments/main_fedavg.py``), on the card:

    python -m fedml_tpu_torch.experiments.main_fedavg --dataset synthetic \
        --model lr --comm_round 2
    python -m fedml_tpu_torch.experiments.main_fedavg --platform cpu ...

``main(argv)`` returns ``(api, global_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("FedAvg-torch")
    common.add_base_args(p)
    return p


def main(argv=None):
    args, device, logger, dataset, spec = common.prepare(
        parser(), argv,
        lambda a: f"FedAVG-r{a.comm_round}-e{a.epochs}-lr{a.lr}")

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    api = FedAvgAPI(dataset, spec, args, device=device,
                    mesh=common.make_mesh(args, device),
                    metrics_logger=logger)
    state = common.run_fedavg_family(api, args, logger)
    logger.close()
    return api, state


if __name__ == "__main__":
    main()
