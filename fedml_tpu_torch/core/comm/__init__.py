"""The control plane's transports (counterpart of
``fedml_tpu/core/comm``): in-process queues (:mod:`.local`), the TCP star
hub (:mod:`.tcp`) and the MQTT bridge (:mod:`.mqtt`, paho imported
lazily). The selector event-loop transport is
:mod:`fedml_tpu_torch.net.eventloop`."""

from fedml_tpu_torch.core.comm.base import (  # noqa: F401
    BaseCommunicationManager, Observer)
from fedml_tpu_torch.core.comm.local import (  # noqa: F401
    LocalCommManager, LocalCommNetwork)
from fedml_tpu_torch.core.comm.tcp import TcpCommManager  # noqa: F401
