"""Run-time guardrails of the port (counterpart of the run-time half of
``fedml_tpu/analysis``):

- :mod:`fedml_tpu_torch.analysis.runtime` -- ``audit()``, which books the
  kernel libraries built and loaded in each federated round (the port's
  compile events, in place of the reference's jit retraces) and counts
  state leaves found off the run's device at the end-of-round sync
  (the transfer guard), reporting through the metrics logger; wired to
  ``--audit`` on the experiment mains. Plus ``race_audit()``
  (``--race_audit``): instrumented control-plane locks recording
  acquisition order and held-while-blocking events.
- :mod:`fedml_tpu_torch.analysis.locks` -- the analysis-facing re-export
  of the lock factories (``fedml_tpu_torch/core/locks.py``).

The static analyzer (the reference's ``linter``, ``dataflow``,
``protocol``, ``concurrency`` and ``crossclass`` passes) is not part of
the port yet.
"""

from fedml_tpu_torch.analysis.runtime import (RaceAuditor, RuntimeAuditor,
                                              audit, current_auditor,
                                              race_audit)

__all__ = ["RuntimeAuditor", "audit", "current_auditor",
           "RaceAuditor", "race_audit"]
