"""The reference's ``tests/test_privacy_pass.py`` against the port's
analyzer: FL150-FL153 (telemetry leaks, DP ordering, mask/codec
commutation, a declared DP leg bypassed), FL128's payload types and the
float-type inference, with its real-tree fixtures over the port's
``resilience/integration.py``, ``program/privacy.py`` and
``core/mpc.py``. The torch meanings of FL150 and FL151 are held against
the reference in ``test_torch_fedcheck_pairs.py``; the mutation
fixtures of the reference's CI script in
``test_torch_fedcheck_mutations.py``."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

from fedcheck_reference import assert_bound_to_the_port, reference_module

_ref = reference_module("test_privacy_pass.py")

_CLASSES = ["TestPrivacyCatalog", "TestFl150TelemetryLeak",
            "TestFl151DpOrdering", "TestFl152MaskCommutation",
            "TestFl153DeclaredDpBypass", "TestFl128PayloadTypes",
            "TestFloatTypeInference"]

TestPrivacyCatalog = _ref.TestPrivacyCatalog
TestFl150TelemetryLeak = _ref.TestFl150TelemetryLeak
TestFl151DpOrdering = _ref.TestFl151DpOrdering
TestFl152MaskCommutation = _ref.TestFl152MaskCommutation
TestFl153DeclaredDpBypass = _ref.TestFl153DeclaredDpBypass
TestFl128PayloadTypes = _ref.TestFl128PayloadTypes
TestFloatTypeInference = _ref.TestFloatTypeInference


def test_the_bound_classes_run_the_port():
    assert_bound_to_the_port(_ref, [getattr(_ref, c) for c in _CLASSES])
