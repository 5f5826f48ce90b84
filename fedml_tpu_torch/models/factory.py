"""Model factory (counterpart of ``fedml_tpu/models/factory.py``): the
names ``lr``, ``cnn``, ``cnn_dropout``, ``resnet56``, ``resnet110``,
``rnn``, ``rnn_fed_shakespeare``, ``rnn_stackoverflow``, ``transformer``,
``transformer_nwp`` and ``moe_transformer``. Every other name of the
reference's zoo raises, naming the ROADMAP item it waits for."""

from __future__ import annotations

import logging

import torch

from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.moe import MoETransformerLM
from fedml_tpu_torch.models.resnet import resnet56, resnet110
from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg, RNNStackOverflow
from fedml_tpu_torch.models.transformer import transformer_nwp

#: names of the reference's factory not ported yet, with their item
_UNPORTED = {
    "resnet18_gn": "A14", "resnet34_gn": "A14", "resnet50_gn": "A14",
    "mobilenet": "A14", "mobilenet_v3": "A14", "vgg11": "A14",
    "vgg13": "A14", "vgg16": "A14", "vgg19": "A14",
}


def create_model(args, model_name, output_dim, input_shape=None):
    """An uninitialised model for ``model_name``. ``args.model_dtype``
    ``"bf16"`` selects bf16 compute with fp32 master parameters.
    ``input_shape`` is one sample's shape (``x.shape[1:]``): a torch
    module fixes its input width at construction, where flax infers it,
    so ``lr`` needs it and the CNNs take it (default 28x28x1)."""
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
    item = _UNPORTED.get(model_name)
    if item is None and model_name.startswith("efficientnet"):
        item = "A14"
    if item is not None:
        raise NotImplementedError(
            f"model {model_name!r} waits for ROADMAP {item}")
    raise ValueError(f"unknown model: {model_name}")


__all__ = ["create_model"]
