"""The reference's tests of the determinism pass (FL131-FL135) against
the port's analyzer: ``TestDeterminism`` of ``tests/test_analysis.py``,
reading the port's program, resilience, steering, observability and
compression packages where it reads the reference's. FL133's torch
meaning is held against the reference's in
``test_torch_fedcheck_pairs.py``.

``test_fl133_constant_prngkey_flagged`` plants ``jax.random.PRNGKey(0)``,
a branch with no torch meaning; its counterpart, under the same name,
makes the same assert of the form that takes its place,
``torch.Generator().manual_seed(0)``."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

from fedcheck_reference import analysis_classes, assert_bound_to_the_port

from fedml_tpu_torch.analysis import lint_source

_ref = analysis_classes(["TestDeterminism"])



class TestDeterminism(_ref.TestDeterminism):
    def test_fl133_constant_prngkey_flagged(self):
        src = (
            "import torch\n"
            "def trace_key():\n"
            "    return torch.Generator().manual_seed(0)\n")
        found = [f for f in lint_source(src, path=self.COHORT)
                 if f.code == "FL133"]
        assert len(found) == 1


def test_the_bound_class_runs_the_port():
    assert_bound_to_the_port(_ref, [_ref.TestDeterminism])
