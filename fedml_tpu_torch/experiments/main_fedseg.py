"""FedSeg experiment main (counterpart of
``fedml_tpu/experiments/main_fedseg.py``), on the card:

    python -m fedml_tpu_torch.experiments.main_fedseg \
        --dataset synthetic_segmentation --backbone resnet --outstride 16
    python -m fedml_tpu_torch.experiments.main_fedseg --platform cpu ...

DeepLab's ``--backbone`` (resnet: width 32, mobilenet: width 16) and
``--outstride`` (8 or 16), and the learning-rate schedule
``--lr_scheduler`` (cos|poly|step) with ``--lr_step`` and
``--warmup_epochs``. ``main(argv)`` returns ``(api, global_state)``.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("FedSeg-torch")
    common.add_base_args(p)
    p.add_argument("--backbone", type=str, default="resnet",
                   choices=["resnet", "mobilenet"])
    p.add_argument("--outstride", type=int, default=16, choices=[8, 16])
    p.add_argument("--lr_scheduler", type=str, default="poly",
                   choices=["cos", "poly", "step"])
    p.add_argument("--lr_step", type=int, default=0)
    p.add_argument("--warmup_epochs", type=int, default=0)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    common.refuse_unported(args)
    device = common.device_for(args)
    logger = common.setup(args, run_name=f"FedSeg-{args.backbone}")
    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
    from fedml_tpu_torch.algorithms.specs import make_segmentation_spec
    from fedml_tpu_torch.data.registry import load_dataset
    from fedml_tpu_torch.models.deeplab import DeepLab

    dataset = load_dataset(args, args.dataset)
    x = common.example_train_data(dataset)["x"]
    model = DeepLab(num_classes=dataset[7], backbone=args.backbone,
                    output_stride=args.outstride, in_channels=x.shape[-1])
    spec = make_segmentation_spec(model, num_classes=dataset[7])
    api = FedSegAPI(dataset, spec, args, device=device,
                    metrics_logger=logger)
    state = common.run_fedavg_family(api, args, logger)
    logger.close()
    return api, state


if __name__ == "__main__":
    main()
