"""The reference's tests of the cross-class concurrency pass (FL126)
against the port's analyzer: ``TestCrossClass``,
``TestContainerElementTyping``, ``TestModuleFunctionCallgraph`` and
``TestNonSelfReceiverFlow`` of ``tests/test_analysis.py``, reading the
port's transports, managers and servers where they read the
reference's (``fedml_tpu_torch/core/comm/tcp.py``,
``fedml_tpu_torch/net/eventloop.py``,
``fedml_tpu_torch/resilience/integration.py``, ...). The one lock
identity the reference's acceptance fixture names by line,
``integration.py:399``, is the port's ``_advance_lock`` creation site
(``fedcheck_reference.advance_lock_site``)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

from fedcheck_reference import (PKG_SUBS, analysis_classes,
                                assert_bound_to_the_port)

_CLASSES = ["TestCrossClass", "TestContainerElementTyping",
            "TestModuleFunctionCallgraph", "TestNonSelfReceiverFlow"]
_ref = analysis_classes(
    _CLASSES, subs=PKG_SUBS + [(r'"integration\.py:399"',
                                "ADVANCE_LOCK_SITE")])

TestCrossClass = _ref.TestCrossClass
TestContainerElementTyping = _ref.TestContainerElementTyping
TestModuleFunctionCallgraph = _ref.TestModuleFunctionCallgraph
TestNonSelfReceiverFlow = _ref.TestNonSelfReceiverFlow


def test_the_bound_classes_run_the_port():
    assert_bound_to_the_port(_ref, [getattr(_ref, c) for c in _CLASSES])
