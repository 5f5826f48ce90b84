"""Resilience of the simulated rounds (counterpart of
``fedml_tpu/resilience``): over-selection, seeded deadline misses and
quorum re-sampling (:mod:`.integration`), closed-loop pace steering
(:mod:`.steering`) and the diurnal load traces that drive them
(:mod:`.faults`, the simulation half).

The distributed control plane -- transports with fault injection, the
resilient server and client FSMs, retry and round policies, the
distributed async server and round recovery -- waits for ROADMAP A13;
the simulation's buffered async aggregator is
:class:`fedml_tpu_torch.program.aggregation.BufferedAggregator`.
"""

from fedml_tpu_torch.resilience.faults import (DiurnalTrace, LoadPhase,
                                               TraceLoadGen,
                                               TraceShapedCommManager)
from fedml_tpu_torch.resilience.integration import (SimResilience,
                                                    add_resilience_args)
from fedml_tpu_torch.resilience.steering import (PaceBounds, PaceController,
                                                 PaceDecision,
                                                 add_steering_args)

__all__ = ["LoadPhase", "DiurnalTrace", "TraceLoadGen",
           "TraceShapedCommManager", "SimResilience", "add_resilience_args",
           "PaceBounds", "PaceController", "PaceDecision",
           "add_steering_args"]
