"""The port's fedlint over the port at zero findings, and the two
analyzers in agreement over ``tests/`` on the rules they share
unchanged (the packages in ``test_torch_fedlint_trees.py``)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os

from fedml_tpu.analysis.linter import lint_paths as ref_lint_paths
from fedml_tpu_torch.analysis.cli import main as fedlint_main
from fedml_tpu_torch.analysis.linter import lint_paths

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = {"FL107", "FL108", "FL115", "FL123", "FL124", "FL125", "FL129",
          "FL130", "FL136"}


def test_the_port_lints_clean_without_a_baseline(monkeypatch, capsys):
    """Every rule over ``fedml_tpu_torch/``, no baseline: 0 findings,
    inside the 60 s wall-time budget (the card's phase runs the same
    command)."""
    monkeypatch.chdir(REPO_ROOT)
    rc = fedlint_main(["fedml_tpu_torch", "--baseline", "", "--format",
                       "json", "--max-seconds", "60"])
    captured = capsys.readouterr()
    report = json.loads(captured.out)
    assert report["summary"]["total"] == 0, report["findings"][:5]
    assert "budget 60.0s" in captured.err
    assert rc == 0


def test_both_analyzers_agree_over_the_tests(monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    port = [(f.path, f.line, f.col, f.code)
            for f in lint_paths(["tests"], select=SHARED)]
    ref = [(f.path, f.line, f.col, f.code)
           for f in ref_lint_paths(["tests"], select=SHARED)]
    assert port == ref
    # the reference's own fixtures trip FL130 and FL108 (scripts in
    # tests/ print): the comparison is not of two empty lists
    assert {"FL130", "FL108"} <= {code for *_, code in port}
