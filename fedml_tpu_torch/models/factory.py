"""Model factory (counterpart of ``fedml_tpu/models/factory.py``): every
name of the reference's zoo -- ``lr``, ``cnn``, ``cnn_dropout``,
``resnet56``, ``resnet110``, ``resnet18_gn``, ``resnet34_gn``,
``resnet50_gn``, ``mobilenet``, ``mobilenet_v3``,
``efficientnet[-b0..b7]``, ``vgg11``/``13``/``16``/``19``, ``rnn``,
``rnn_fed_shakespeare``, ``rnn_stackoverflow``, ``transformer``,
``transformer_nwp`` and ``moe_transformer``. ``args.group_norm_channels``
(32), ``args.model_mode`` ("LARGE"), ``args.vgg_bn`` (False) and
``args.moe_experts`` (8) are read as the reference reads them."""

from __future__ import annotations

import logging

import torch

from fedml_tpu_torch.models import resnet_gn, vgg
from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg
from fedml_tpu_torch.models.efficientnet import efficientnet
from fedml_tpu_torch.models.layers import hwc
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.mobilenet import MobileNet
from fedml_tpu_torch.models.mobilenet_v3 import MobileNetV3
from fedml_tpu_torch.models.moe import MoETransformerLM
from fedml_tpu_torch.models.resnet import resnet56, resnet110
from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg, RNNStackOverflow
from fedml_tpu_torch.models.transformer import transformer_nwp


def create_model(args, model_name, output_dim, input_shape=None):
    """An uninitialised model for ``model_name``. ``args.model_dtype``
    ``"bf16"`` selects bf16 compute with fp32 master parameters.
    ``input_shape`` is one sample's shape (``x.shape[1:]``): a torch
    module fixes its input width at construction, where flax infers it,
    so ``lr`` needs it, the CNNs take it (default 28x28x1), the CV zoo
    sizes its first conv from its channels (default 3) and VGG its
    ``fc0`` from its spatial size (default 32x32)."""
    logging.info("create_model. model_name = %s, output_dim = %s",
                 model_name, output_dim)
    dt_name = getattr(args, "model_dtype", None) if args else None
    dtype = (torch.bfloat16 if dt_name in ("bf16", "bfloat16")
             else torch.float32)
    only_digits = output_dim == 10
    if model_name == "lr":
        if input_shape is None:
            raise ValueError("model 'lr' needs input_shape")
        dim = 1
        for d in input_shape:
            dim *= int(d)
        return LogisticRegression(dim, output_dim)
    if model_name in ("cnn", "cnn_dropout"):
        cls = CNNOriginalFedAvg if model_name == "cnn" else CNNDropOut
        return cls(only_digits=only_digits,
                   input_shape=input_shape or (28, 28, 1), dtype=dtype)
    if model_name == "resnet56":
        return resnet56(class_num=output_dim, dtype=dtype)
    if model_name == "resnet110":
        return resnet110(class_num=output_dim, dtype=dtype)
    # the CV zoo's first conv takes the images' channels (sequence models
    # see a 1-D sample shape, so read it only on these branches)
    in_ch = lambda: 3 if input_shape is None else hwc(input_shape)[2]
    if model_name in ("resnet18_gn", "resnet34_gn", "resnet50_gn"):
        group_norm = getattr(args, "group_norm_channels", 32) if args else 32
        return getattr(resnet_gn, model_name)(
            class_num=output_dim, group_norm=group_norm, in_channels=in_ch(),
            dtype=dtype)
    if model_name == "mobilenet":
        return MobileNet(num_classes=output_dim, in_channels=in_ch(),
                         dtype=dtype)
    if model_name == "mobilenet_v3":
        mode = getattr(args, "model_mode", "LARGE") if args else "LARGE"
        return MobileNetV3(model_mode=mode, num_classes=output_dim,
                           in_channels=in_ch(), dtype=dtype)
    if model_name.startswith("efficientnet"):
        name = "efficientnet-b0" if model_name == "efficientnet" else model_name
        return efficientnet(name, num_classes=output_dim, in_channels=in_ch(),
                            dtype=dtype)
    if model_name in ("vgg11", "vgg13", "vgg16", "vgg19"):
        return getattr(vgg, model_name)(
            class_num=output_dim,
            batch_norm=getattr(args, "vgg_bn", False) if args else False,
            input_shape=input_shape or (32, 32, 3), dtype=dtype)
    if model_name == "rnn":
        return RNNOriginalFedAvg(vocab_size=output_dim)
    if model_name == "rnn_fed_shakespeare":
        return RNNOriginalFedAvg(vocab_size=output_dim,
                                 output_all_timesteps=True)
    if model_name == "rnn_stackoverflow":
        return RNNStackOverflow(vocab_size=output_dim - 4)
    if model_name in ("transformer", "transformer_nwp"):
        return transformer_nwp(vocab_size=output_dim, dtype=dtype)
    if model_name == "moe_transformer":
        experts = getattr(args, "moe_experts", 8) if args else 8
        return MoETransformerLM(vocab_size=output_dim, n_experts=experts,
                                dtype=dtype)
    raise ValueError(f"unknown model: {model_name}")


__all__ = ["create_model"]
