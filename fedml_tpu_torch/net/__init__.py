"""The massive-connection control plane (counterpart of
``fedml_tpu/net``).

The threaded TCP transport (``core/comm/tcp.py``) spends one serve thread
and two locks per connection: honest at tens of ranks, dead at 10k. This
package is the control plane at its intended scale:

- :mod:`fedml_tpu_torch.net.eventloop` -- a single-threaded selector
  event-loop transport implementing the same ``BaseCommunicationManager``
  contract (same star topology, HELLO/GOODBYE/STOP frames, PEER_LOST
  synthesis, ``abort()``, wire metrics) with connection multiplexing,
  per-connection write-queue backpressure (high/low watermarks; slow
  peers are shed into the resilience layer's PEER_LOST path) and
  zero-copy frame assembly over the binary codec's buffer views.
- :mod:`fedml_tpu_torch.net.ingest` -- its parallel frame-decode stage.
- :mod:`fedml_tpu_torch.net.fanin` -- a hierarchical fan-in tier: edge
  aggregators each own a leaf star and forward one pre-aggregated report
  upstream, so the coordinator's buffered aggregator folds E edge
  reports instead of holding N client sockets (the round-robin grouping
  rule is the hierarchical algorithm's).
- :mod:`fedml_tpu_torch.net.soak` -- the many-connection soak harness:
  one client-side event loop drives thousands of protocol-complete swarm
  clients (HELLO -> SYNC -> train -> REPORT) from a subprocess, against a
  real async server in the parent. Evidence = ``status.json`` +
  ``fed_report_latency_seconds`` tails.

The FSMs (``ResilientFedAvgServer``, ``AsyncBufferedFedAvgServer``,
``ResilientFedAvgClient``) run unchanged over either transport, selected
by the drivers' ``transport=`` parameter (``run_tcp_fedavg`` /
``run_async_tcp_fedavg`` / ``run_fanin_fedavg``; ``--transport`` is the
flag form). The drivers construct ``TcpCommManager`` /
``EventLoopCommManager`` inline, as the reference's do.
"""

from __future__ import annotations

#: The ``--transport`` flag's choices on the distributed drivers.
TRANSPORTS = ("tcp", "eventloop")

__all__ = ["TRANSPORTS"]
