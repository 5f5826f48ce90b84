"""Hierarchical FL experiment main (counterpart of
``fedml_tpu/experiments/main_hierarchical.py``), on the card:

    python -m fedml_tpu_torch.experiments.main_hierarchical --platform cpu \
        --group_num 2 --group_comm_round 2 ...

``main(argv)`` returns ``(api, global_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("HierarchicalFL-torch")
    common.add_base_args(p)
    p.add_argument("--group_num", type=int, default=2)
    p.add_argument("--group_comm_round", type=int, default=2,
                   help="intra-group rounds per global round")
    return p


def main(argv=None):
    args, device, logger, dataset, spec = common.prepare(
        parser(), argv, lambda a: "HierFL")

    from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvgAPI
    api = HierarchicalFedAvgAPI(dataset, spec, args, device=device,
                                mesh=common.make_mesh(args, device),
                                metrics_logger=logger)
    state = common.run_fedavg_family(api, args, logger)
    logger.close()
    return api, state


if __name__ == "__main__":
    main()
