"""Resilience of the simulated rounds and of the distributed control
plane (counterpart of ``fedml_tpu/resilience``):

- ``faults``      -- seeded fault injection over any transport
                     (drop/delay/duplicate/reorder/stall/kill) and the
                     diurnal trace-driven load generator.
- ``policy``      -- send retry with exponential backoff; the
                     deadline-driven round controller (over-selection,
                     quorum, abandonment).
- ``async_agg``   -- the FedBuff-style buffered async server over TCP.
- ``steering``    -- closed-loop pace steering.
- ``recovery``    -- round-granular crash/resume over utils/checkpoint.
- ``integration`` -- the simulation rounds' over-selection and deadline
                     misses, the resilient server and client FSMs and
                     :func:`run_tcp_fedavg`.

Round semantics live in :mod:`fedml_tpu_torch.program`: both servers
execute a ``RoundProgram`` through its host view; their transports are
the threaded TCP hub and the selector event loop
(:mod:`fedml_tpu_torch.net`).
"""

from fedml_tpu_torch.resilience.async_agg import (AsyncAggPolicy,
                                                  AsyncBufferedFedAvgServer,
                                                  BufferedAggregator,
                                                  run_async_tcp_fedavg,
                                                  staleness_weight)
from fedml_tpu_torch.resilience.faults import (ACTIONS, DiurnalTrace,
                                               FaultPlan, FaultRule,
                                               FaultyCommManager, LoadPhase,
                                               TraceLoadGen,
                                               TraceShapedCommManager)
from fedml_tpu_torch.resilience.integration import (ResilientFedAvgClient,
                                                    ResilientFedAvgServer,
                                                    SimResilience,
                                                    add_resilience_args,
                                                    quadratic_trainer,
                                                    run_tcp_fedavg)
from fedml_tpu_torch.resilience.policy import (ROUND_ABANDONED,
                                               ROUND_COMPLETE,
                                               ROUND_DEGRADED,
                                               PeerUnreachableError,
                                               RetryPolicy, RoundController,
                                               RoundPolicy,
                                               aggregate_reports,
                                               fold_entries_fp64,
                                               send_with_retry)
from fedml_tpu_torch.resilience.recovery import RoundRecovery
from fedml_tpu_torch.resilience.steering import (PaceBounds, PaceController,
                                                 PaceDecision,
                                                 add_steering_args)

__all__ = [
    "ACTIONS", "FaultRule", "FaultPlan", "FaultyCommManager",
    "LoadPhase", "DiurnalTrace", "TraceLoadGen", "TraceShapedCommManager",
    "PaceBounds", "PaceController", "PaceDecision", "add_steering_args",
    "RetryPolicy", "RoundPolicy", "RoundController", "PeerUnreachableError",
    "send_with_retry", "aggregate_reports", "fold_entries_fp64",
    "ROUND_COMPLETE", "ROUND_DEGRADED", "ROUND_ABANDONED",
    "RoundRecovery",
    "SimResilience", "ResilientFedAvgClient", "ResilientFedAvgServer",
    "add_resilience_args", "quadratic_trainer", "run_tcp_fedavg",
    "AsyncAggPolicy", "BufferedAggregator", "AsyncBufferedFedAvgServer",
    "staleness_weight", "run_async_tcp_fedavg",
]
