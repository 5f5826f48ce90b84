"""FedNAS experiment main (counterpart of
``fedml_tpu/experiments/main_fednas.py``), on the card:

    python -m fedml_tpu_torch.experiments.main_fednas --stage search \
        --dataset synthetic_images
    python -m fedml_tpu_torch.experiments.main_fednas --stage train ...
    (``--platform cpu`` runs either on the CPU)

``--stage search`` runs the bilevel DARTS search (``--init_channels``,
``--layers``, ``--steps``, ``--arch_order``) and returns ``(api,
genotype)``; ``--stage train`` is FedAvg of the fixed network of
``--genotype`` (``DARTS_V1``) with ``--drop_path_prob`` and returns
``(api, global_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("FedNAS-torch")
    common.add_base_args(p)
    p.add_argument("--stage", type=str, default="search",
                   choices=["search", "train"])
    p.add_argument("--init_channels", type=int, default=16)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--steps", type=int, default=4,
                   help="intermediate nodes per search cell")
    p.add_argument("--arch_order", type=int, default=2,
                   help="1 = first-order DARTS, 2 = unrolled bilevel")
    p.add_argument("--arch_lr", type=float, default=3e-4)
    p.add_argument("--genotype", type=str, default="DARTS_V1",
                   help="train-stage genotype name (models.darts)")
    p.add_argument("--drop_path_prob", type=float, default=0.0)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    common.refuse_unported(args)
    device = common.device_for(args)
    logger = common.setup(args, run_name=f"FedNAS-{args.stage}")
    from fedml_tpu_torch.data.registry import load_dataset
    from fedml_tpu_torch.models import darts

    dataset = load_dataset(args, args.dataset)
    channels = common.example_train_data(dataset)["x"].shape[-1]
    if args.stage == "search":
        from fedml_tpu_torch.algorithms.fednas import FedNASAPI
        model = darts.DARTSNetwork(C=args.init_channels, layers=args.layers,
                                   num_classes=dataset[7], steps=args.steps,
                                   in_channels=channels)
        api = FedNASAPI(dataset, args, model=model, metrics_logger=logger,
                        device=device)
        genotype = api.train()
        logger({"genotype": str(genotype)})
        logger.close()
        return api, genotype

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    model = darts.DARTSFixedNetwork(
        genotype=getattr(darts, args.genotype), C=args.init_channels,
        layers=args.layers, num_classes=dataset[7],
        drop_path_prob=args.drop_path_prob, in_channels=channels)
    spec = make_classification_spec(model, name="fednas_train")
    api = FedAvgAPI(dataset, spec, args, device=device,
                    metrics_logger=logger)
    state = common.run_fedavg_family(api, args, logger)
    logger.close()
    return api, state


if __name__ == "__main__":
    main()
