"""The port's core runtime (counterpart of ``fedml_tpu/core``)."""

from fedml_tpu_torch.core.topology import (  # noqa: F401
    AsymmetricTopologyManager,
    BaseTopologyManager,
    SymmetricTopologyManager,
    mixing_matrix,
)
