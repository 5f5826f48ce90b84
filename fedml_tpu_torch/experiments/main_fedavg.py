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


def main(argv=None):
    parser = argparse.ArgumentParser("FedAvg-torch")
    common.add_base_args(parser)
    args = parser.parse_args(argv)
    common.refuse_unported(args)
    device = common.device_for(args)

    logger = common.setup(args, run_name=f"FedAVG-r{args.comm_round}"
                                         f"-e{args.epochs}-lr{args.lr}")
    dataset, model = common.load_dataset_and_model(args)
    spec = common.make_spec(args, model, dataset)

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    api = FedAvgAPI(dataset, spec, args, device=device,
                    metrics_logger=logger)
    state = common.run_fedavg_family(api, args, logger)
    logger.close()
    return api, state


if __name__ == "__main__":
    main()
