"""Model zoo of the port (NHWC images or ``[B, T]`` token ids at the
public forward, like the reference)."""

from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg  # noqa: F401
from fedml_tpu_torch.models.efficientnet import (  # noqa: F401
    EfficientNet, efficientnet)
from fedml_tpu_torch.models.linear import LogisticRegression  # noqa: F401
from fedml_tpu_torch.models.mobilenet import MobileNet  # noqa: F401
from fedml_tpu_torch.models.mobilenet_v3 import MobileNetV3  # noqa: F401
from fedml_tpu_torch.models.moe import (  # noqa: F401
    MoEBlock, MoEMLP, MoETransformerLM)
from fedml_tpu_torch.models.resnet import (  # noqa: F401
    CifarResNet, resnet56, resnet110)
from fedml_tpu_torch.models.resnet_gn import (  # noqa: F401
    ResNetGN, resnet18_gn, resnet34_gn, resnet50_gn)
from fedml_tpu_torch.models.rnn import (  # noqa: F401
    RNNOriginalFedAvg, RNNStackOverflow)
from fedml_tpu_torch.models.transformer import (  # noqa: F401
    TransformerLM, lm_loss, transformer_nwp)
from fedml_tpu_torch.models.vgg import (  # noqa: F401
    VGG, vgg11, vgg13, vgg16, vgg19)
from fedml_tpu_torch.models.gkt import (  # noqa: F401
    GKTClientResNet, GKTServerResNet, resnet5_56, resnet8_56, resnet56_server)
from fedml_tpu_torch.models.darts import (  # noqa: F401
    DARTS_V1, DARTSFixedNetwork, DARTSNetwork, Genotype, derive_genotype)
from fedml_tpu_torch.models.factory import create_model  # noqa: F401
