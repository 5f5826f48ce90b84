"""Model zoo of the port (NHWC at the public forward, like the reference)."""

from fedml_tpu_torch.models.resnet import CifarResNet, resnet56  # noqa: F401
from fedml_tpu_torch.models.factory import create_model  # noqa: F401
