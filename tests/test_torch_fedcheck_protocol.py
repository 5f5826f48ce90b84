"""The reference's tests of the protocol pass (FL120-FL122, FL127,
FL128) against the port's analyzer: ``TestProtocolRules``,
``TestFsmSequencing``, ``TestPayloadSchema``,
``TestPayloadSchemaNamedKeys`` and ``TestReviewHardening`` of
``tests/test_analysis.py``, reading the port's control plane where they
read the reference's (``fedml_tpu_torch/resilience/integration.py``,
its managers, message and wire modules).

Three tests of ``TestReviewHardening`` read what the port has not: two
pin the taint fixpoint of the reference's donation inference
(``dataflow.infer_donate_argnums_from_body``; torch has no donation)
and one the wall-time budget of its ``--fix`` path (the port's CLI has
no ``--fix``). Their counterparts, under the same names, make the same
asserts of the port's taint fixpoint (the privacy pass's ``_Taint``)
and of the budget on the lint path."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import ast

from fedcheck_reference import (PKG_SUBS, analysis_classes,
                                assert_bound_to_the_port)

from fedml_tpu_torch.analysis.cli import main as fedlint_main
from fedml_tpu_torch.analysis.privacy import _Taint

_CLASSES = ["TestProtocolRules", "TestFsmSequencing", "TestPayloadSchema",
            "TestPayloadSchemaNamedKeys", "TestReviewHardening"]
_ref = analysis_classes(_CLASSES, subs=PKG_SUBS)

TestProtocolRules = _ref.TestProtocolRules
TestFsmSequencing = _ref.TestFsmSequencing
TestPayloadSchema = _ref.TestPayloadSchema
TestPayloadSchemaNamedKeys = _ref.TestPayloadSchemaNamedKeys


def _tainted_returns(src, source):
    """Whether the taint seeded at the parameter ``source`` reaches the
    function's ``return``, through the privacy pass's local fixpoint."""
    fn = ast.parse(src).body[0]
    taint = _Taint(fn, lambda node: isinstance(node, ast.Name)
                   and node.id == source)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][0]
    return taint.expr(ret.value)


class TestReviewHardening(_ref.TestReviewHardening):
    def test_taint_fixpoint_reaches_three_link_loop_chain(self):
        src = ("def round_fn(state, xs):\n"
               "    out = 0\n"
               "    acc = 0\n"
               "    tmp = 0\n"
               "    for x in xs:\n"
               "        out = [tmp]\n"
               "        tmp = (acc, x)\n"
               "        acc = state\n"
               "    return out\n")
        # state -> acc -> tmp -> out needs one pass per link
        assert _tainted_returns(src, "state")
        assert _tainted_returns(src, "xs")

    def test_taint_branch_join_unions_if_else(self):
        # state flows to the return via the if branch only; a
        # sequential walk would let the else branch overwrite it
        src = ("def round_fn(state, data):\n"
               "    if cond():\n"
               "        out = state\n"
               "    else:\n"
               "        out = data\n"
               "    return out\n")
        assert _tainted_returns(src, "state")
        assert _tainted_returns(src, "data")
        # try/except branches join the same way
        src = ("def round_fn(state, fallback):\n"
               "    try:\n"
               "        out = list(state)\n"
               "    except ValueError:\n"
               "        out = fallback\n"
               "    return out\n")
        assert _tainted_returns(src, "state")
        assert _tainted_returns(src, "fallback")

    def test_max_seconds_applies_to_fix_path(self, tmp_path, capsys):
        # the port has no --fix: the budget holds on its one path
        mod = tmp_path / "ok.py"
        mod.write_text("x = 1\n")
        assert fedlint_main([str(mod), "--max-seconds", "0"]) == 1
        assert "budget exceeded" in capsys.readouterr().err
        assert fedlint_main([str(mod), "--max-seconds", "300"]) == 0
        capsys.readouterr()


def test_the_bound_classes_run_the_port():
    assert_bound_to_the_port(_ref, [getattr(_ref, c) for c in _CLASSES])
