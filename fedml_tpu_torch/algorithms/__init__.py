"""FL algorithms of the port (counterpart of ``fedml_tpu/algorithms``).
The serverless, split, vertical and secure APIs and FedGKT and FedNAS
are exported here; the FedAvg family (FedSeg among it) is imported from
its modules."""

from fedml_tpu_torch.algorithms.decentralized import (  # noqa: F401
    DecentralizedFedAPI)
from fedml_tpu_torch.algorithms.decentralized_online import (  # noqa: F401
    DecentralizedOnlineAPI)
from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI  # noqa: F401
from fedml_tpu_torch.algorithms.fednas import (  # noqa: F401
    FedNASAPI, FedNASConfig)
from fedml_tpu_torch.algorithms.splitnn import SplitNNAPI  # noqa: F401
from fedml_tpu_torch.algorithms.turboaggregate import (  # noqa: F401
    TurboAggregateAPI)
from fedml_tpu_torch.algorithms.vertical import VerticalFLAPI  # noqa: F401
