"""Model zoo of the port (NHWC images or ``[B, T]`` token ids at the
public forward, like the reference)."""

from fedml_tpu_torch.models.resnet import CifarResNet, resnet56  # noqa: F401
from fedml_tpu_torch.models.transformer import (  # noqa: F401
    TransformerLM, lm_loss, transformer_nwp)
from fedml_tpu_torch.models.factory import create_model  # noqa: F401
