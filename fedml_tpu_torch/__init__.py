"""PyTorch/CUDA port of ``fedml_tpu`` for NVIDIA Hopper.

Module layout mirrors ``fedml_tpu/``; the JAX package is the reference
the tests hold this one against. The port imports neither JAX nor the
JAX package. Its entry points run on the GPU unless the caller passes
``device="cpu"``.

Importing the port fixes the float32 precision of convolutions and
matrix products to full fp32 (no TF32), as the reference computes them.
"""

import torch as _torch

_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False
