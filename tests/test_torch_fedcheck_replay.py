"""The reference's ``tests/test_modelcheck.py`` against the port: the
model checker's counterexamples compiled by
``modelcheck.trace_to_fault_plan`` into the port's
``resilience.faults.FaultPlan`` and replayed against the port's TCP
control plane (``run_tcp_fedavg``: the FL141 inert-report trace hangs a
real round into ``TimeoutError``, a compiled kill sheds a rank), and the
widened fault budget over the port's ``net/fanin.py`` two-tier
composition."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

from fedcheck_reference import assert_bound_to_the_port, reference_module

from fedml_tpu_torch.analysis import modelcheck
from fedml_tpu_torch.resilience import faults, integration

_ref = reference_module("test_modelcheck.py")

TestTraceCompiler = _ref.TestTraceCompiler
TestFl141Replay = _ref.TestFl141Replay
TestWidenedFaultBudget = _ref.TestWidenedFaultBudget


def test_the_bound_classes_run_the_port():
    assert _ref.mc is modelcheck
    assert _ref.FaultPlan is faults.FaultPlan
    assert _ref.run_tcp_fedavg is integration.run_tcp_fedavg
    assert_bound_to_the_port(_ref, [TestTraceCompiler, TestFl141Replay,
                                    TestWidenedFaultBudget])
