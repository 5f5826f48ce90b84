"""FedGKT experiment main (counterpart of
``fedml_tpu/experiments/main_fedgkt.py``), on the card:

    python -m fedml_tpu_torch.experiments.main_fedgkt \
        --dataset synthetic_images --client_model resnet8_56
    python -m fedml_tpu_torch.experiments.main_fedgkt --platform cpu ...

The client/server pair (``--client_model`` resnet5_56|resnet8_56,
``--server_blocks`` blocks a server stage: 9 is ResNet-56's tail) and
the distillation knobs ``--temperature``, ``--alpha_distill`` and
``--server_epochs``. ``main(argv)`` returns ``(api, server_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("FedGKT-torch")
    common.add_base_args(p)
    p.add_argument("--client_model", type=str, default="resnet5_56",
                   choices=["resnet5_56", "resnet8_56"])
    p.add_argument("--server_blocks", type=int, default=9,
                   help="blocks per server stage (9 -> ResNet-56 tail)")
    p.add_argument("--temperature", type=float, default=3.0)
    p.add_argument("--alpha_distill", type=float, default=1.0)
    p.add_argument("--server_epochs", type=int, default=1)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    common.refuse_unported(args)
    device = common.device_for(args)
    logger = common.setup(args, run_name="FedGKT")
    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.data.registry import load_dataset
    from fedml_tpu_torch.models import gkt

    dataset = load_dataset(args, args.dataset)
    channels = common.example_train_data(dataset)["x"].shape[-1]
    client_model = getattr(gkt, args.client_model)(class_num=dataset[7],
                                                   in_channels=channels)
    server_model = gkt.GKTServerResNet(n=args.server_blocks,
                                       num_classes=dataset[7])
    api = FedGKTAPI(dataset, client_model, server_model, args,
                    metrics_logger=logger, device=device)
    with common.compile_cache_scope(args), \
            common.audit_scope(args, logger, wired=False):
        api.train()
    logger.close()
    return api, api.server_state


if __name__ == "__main__":
    main()
