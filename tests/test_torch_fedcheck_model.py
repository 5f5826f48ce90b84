"""The reference's tests of the bounded model checker (FL140-FL143)
against the port's analyzer: ``TestModelCheck`` of
``tests/test_analysis.py``, its fixtures composed over the port's
managers and its real-topology cases over the port's
``resilience/`` and ``net/`` packages."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

from fedcheck_reference import analysis_classes, assert_bound_to_the_port

_ref = analysis_classes(["TestModelCheck"])

TestModelCheck = _ref.TestModelCheck


def test_the_bound_class_runs_the_port():
    assert_bound_to_the_port(_ref, [TestModelCheck])
