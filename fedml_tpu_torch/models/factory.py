"""Model factory (counterpart of ``fedml_tpu/models/factory.py``; only
``resnet56`` is ported, the rest of the zoo waits for ROADMAP A4/A14)."""

from __future__ import annotations

import torch

from fedml_tpu_torch.models.resnet import resnet56


def create_model(args, model_name, output_dim):
    """An uninitialised model; ``args.model_dtype`` ``"bf16"`` selects bf16
    compute with fp32 master parameters."""
    dt_name = getattr(args, "model_dtype", None) if args else None
    dtype = (torch.bfloat16 if dt_name in ("bf16", "bfloat16")
             else torch.float32)
    if model_name == "resnet56":
        return resnet56(class_num=output_dim, dtype=dtype)
    raise NotImplementedError(
        f"model {model_name!r} waits for ROADMAP A4/A14 (only resnet56 is "
        "ported)")


__all__ = ["create_model"]
