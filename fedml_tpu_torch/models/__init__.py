"""Model zoo of the port (NHWC images or ``[B, T]`` token ids at the
public forward, like the reference)."""

from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg  # noqa: F401
from fedml_tpu_torch.models.linear import LogisticRegression  # noqa: F401
from fedml_tpu_torch.models.moe import (  # noqa: F401
    MoEBlock, MoEMLP, MoETransformerLM)
from fedml_tpu_torch.models.resnet import (  # noqa: F401
    CifarResNet, resnet56, resnet110)
from fedml_tpu_torch.models.transformer import (  # noqa: F401
    TransformerLM, lm_loss, transformer_nwp)
from fedml_tpu_torch.models.factory import create_model  # noqa: F401
