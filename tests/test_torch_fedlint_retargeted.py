"""The reference's framework-neutral fedlint classes, retargeted at the
port's analyzer (``fedml_tpu_torch/analysis``).

The concurrency (FL123-FL125), event-loop (FL129, FL136), metric-label
(FL115) and paradigm-bypass (FL130) rules, and the CLI's wall-time
budget, are the reference's own rules in the port: its test classes run
here unchanged against the port's ``lint_source``, ``lint_paths`` and
CLI, with every path the classes read (``fedml_tpu/net/eventloop.py``,
the control plane, the program consumers) moved to the port's file of
the same name."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import os

from reference_scenarios import retarget_defs

from fedml_tpu_torch.analysis import lint_paths, lint_source
from fedml_tpu_torch.analysis.cli import main as fedlint_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_PATH = "fedml_tpu_torch/core/fake.py"

_CLASSES = ["TestConcurrencyRules", "TestEventLoopReadiness",
            "TestEventLoopWritePath", "TestFl115MetricLabelCardinality",
            "TestParadigmBypass", "TestWallTimeBudget"]

_ref = retarget_defs(
    "test_analysis.py", _CLASSES + ["codes"],
    subs=[(r'"fedml_tpu/', '"fedml_tpu_torch/')],
    env={"lint_source": lint_source, "lint_paths": lint_paths,
         "fedlint_main": fedlint_main, "REPO_ROOT": REPO_ROOT,
         "LIB_PATH": LIB_PATH})

TestConcurrencyRules = _ref.TestConcurrencyRules
TestEventLoopReadiness = _ref.TestEventLoopReadiness
TestEventLoopWritePath = _ref.TestEventLoopWritePath
TestFl115MetricLabelCardinality = _ref.TestFl115MetricLabelCardinality
TestParadigmBypass = _ref.TestParadigmBypass
TestWallTimeBudget = _ref.TestWallTimeBudget


def test_the_retargeted_classes_run_the_port():
    """Every bound class reads the port's analyzer and the port's files:
    no reference module and no reference path is left in them."""
    assert _ref.lint_source is lint_source
    assert _ref.lint_paths is lint_paths
    assert _ref.fedlint_main is fedlint_main
    assert _ref.codes.__defaults__ == (LIB_PATH,)
    for cls in (globals()[name] for name in _CLASSES):
        for name in dir(cls):
            if not name.startswith("test_"):
                continue
            code = getattr(cls, name).__code__
            consts = [c for c in code.co_consts if isinstance(c, str)]
            assert not any(c.startswith("fedml_tpu/") for c in consts), \
                (cls.__name__, name)
            assert not any(n.startswith("fedml_tpu.") for n in
                           code.co_names), (cls.__name__, name)
