"""TurboAggregate experiment main (counterpart of
``fedml_tpu/experiments/main_turboaggregate.py``; the reference's
``turboaggregate``: the MPC primitives of ``mpc_function.py:4-75``, the
weighted aggregate of ``TA_Aggregator.py:56-85``), on the card:

    python -m fedml_tpu_torch.experiments.main_turboaggregate \
        --dataset synthetic --model lr
    python -m fedml_tpu_torch.experiments.main_turboaggregate --platform cpu ...

FedAvg whose aggregate is the host's masked secure sum, through the
FedAvg family's run loop (``--checkpoint_dir``, ``--resume``). The sum is
always masked: the reference's ``--secure`` switch, which nothing there
reads, is not taken, so a command line that sets it fails to parse.
``main(argv)`` returns ``(api, global_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("TurboAggregate-torch")
    common.add_base_args(p)
    return p


def main(argv=None):
    args, device, logger, dataset, spec = common.prepare(
        parser(), argv, lambda a: "TurboAggregate")

    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
    api = TurboAggregateAPI(dataset, spec, args, metrics_logger=logger,
                            device=device)
    state = common.run_fedavg_family(api, args, logger)
    logger.close()
    return api, state


if __name__ == "__main__":
    main()
