"""fedlint for the port: static and run-time guardrails for the PyTorch
package (counterpart of ``fedml_tpu/analysis``). Two halves:

- :mod:`fedml_tpu_torch.analysis.linter` -- the static analyzer: an AST
  pass over the package with the reference's rule codes (FL1xx),
  ``# fedlint: disable=CODE`` suppressions, and a checked-in baseline
  (``fedlint_baseline.json``, empty) so the gate only fails on *new*
  findings. CLI: ``python -m fedml_tpu_torch.analysis`` (default path
  ``fedml_tpu_torch``; ``--list-rules`` prints the rule table). Its
  device-code rules are keyed on torch's traced sites
  (``torch.compile``, ``torch.jit.script``/``trace``,
  ``torch.cuda.make_graphed_callables``, ``with torch.cuda.graph``) and
  on asynchronous CUDA work (kernel entry points, ``nn.Module`` calls)
  where the reference's are keyed on ``jax.jit``; FL104 (donation) and
  FL111 (``lax.scan`` carries) have no torch meaning.
- :mod:`fedml_tpu_torch.analysis.dataflow` -- the project-wide symbol
  table of traced and graphed callables (decorators, wraps, builder
  returns across imports) and FL110, reading a CUDA-graph output after
  the next replay overwrote it.
- :mod:`fedml_tpu_torch.analysis.concurrency` -- the control plane's
  thread-safety rules (FL123 unguarded shared state, FL124 lock-order
  cycles, FL125 blocking under a state lock) and event-loop readiness
  (FL129, FL136), framework-neutral and the reference's own.
- The reference's five project-wide passes, run by ``lint_paths`` over
  the whole fileset, each index built once a run:
  :mod:`~fedml_tpu_torch.analysis.protocol` (FL120-FL122, FL127,
  FL128: FSM protocol verification over the port's ``core/managers.py``
  roots), :mod:`~fedml_tpu_torch.analysis.crossclass` (FL126:
  cross-class lock-order cycles and held-while-blocking chains),
  :mod:`~fedml_tpu_torch.analysis.determinism` (FL131-FL135; FL133 also
  reads torch's global stream and its constant seeding),
  :mod:`~fedml_tpu_torch.analysis.modelcheck` (FL140-FL143, bounded
  model checking of the composed FSMs; ``trace_to_fault_plan`` compiles
  a counterexample into the port's ``resilience.faults.FaultPlan``) and
  :mod:`~fedml_tpu_torch.analysis.privacy` (FL150-FL153; FL150's taint
  survives torch's copies and views, FL151 reads a constant-seeded torch
  ``Generator`` as underived).
- :mod:`fedml_tpu_torch.analysis.runtime` -- ``audit()``, which books the
  kernel libraries built and loaded in each federated round (the port's
  compile events, in place of the reference's jit retraces) and counts
  state leaves found off the run's device at the end-of-round sync
  (the transfer guard), reporting through the metrics logger; wired to
  ``--audit`` on the experiment mains. Plus ``race_audit()``
  (``--race_audit``): instrumented control-plane locks recording
  acquisition order and held-while-blocking events -- the runtime
  halves of FL124/FL125.
- :mod:`fedml_tpu_torch.analysis.locks` -- the analysis-facing re-export
  of the lock factories (``fedml_tpu_torch/core/locks.py``).
"""

from fedml_tpu_torch.analysis.concurrency import check_concurrency
from fedml_tpu_torch.analysis.crossclass import (CrossClassIndex,
                                                 check_crossclass)
from fedml_tpu_torch.analysis.dataflow import ProjectIndex
from fedml_tpu_torch.analysis.linter import (Finding, RULES, lint_paths,
                                             lint_source)
from fedml_tpu_torch.analysis.runtime import (RaceAuditor, RuntimeAuditor,
                                              audit, current_auditor,
                                              race_audit)

__all__ = ["Finding", "RULES", "lint_paths", "lint_source",
           "ProjectIndex", "check_concurrency",
           "CrossClassIndex", "check_crossclass",
           "RuntimeAuditor", "audit", "current_auditor",
           "RaceAuditor", "race_audit"]
