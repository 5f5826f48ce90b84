"""The reference's tests of the analyzer's five project-wide passes,
bound to the port's analyzer (``fedml_tpu_torch/analysis``).

The protocol, cross-class, determinism, model-checking and privacy
passes are framework-neutral in the port but for three torch meanings
(FL133, FL150, FL151; ``test_torch_fedcheck_pairs.py``). Their
reference test classes run here against the port's ``lint_source``,
``lint_paths``, CLI and modules, with every path they read moved to the
port's file of the same name (``"fedml_tpu/..."`` ->
``"fedml_tpu_torch/..."``, the ``"fedml_tpu"`` package directory of a
planted tree -> ``"fedml_tpu_torch"``). Each ``test_torch_fedcheck_*``
file binds a share of them, so that no file runs long alone."""

import os
import types

from reference_scenarios import retarget, retarget_defs

from fedml_tpu_torch.analysis import lint_paths, lint_source
from fedml_tpu_torch.analysis.cli import main as fedlint_main
from fedml_tpu_torch.analysis.linter import RULES, rule_tags

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_PATH = "fedml_tpu_torch/core/fake.py"

#: the path rewrites every bound class needs
PATH_SUBS = [(r'"fedml_tpu/', '"fedml_tpu_torch/')]
#: ... and, for the classes that plant a package tree, its directory
PKG_SUBS = PATH_SUBS + [(r'"fedml_tpu"', '"fedml_tpu_torch"')]


def analysis_classes(names, subs=PATH_SUBS):
    """The reference's ``tests/test_analysis.py`` classes ``names`` (with
    its ``codes`` helper) run against the port's analyzer."""
    return retarget_defs(
        "test_analysis.py", list(names) + ["codes"], subs=subs,
        env={"lint_source": lint_source, "lint_paths": lint_paths,
             "fedlint_main": fedlint_main, "RULES": RULES,
             "rule_tags": rule_tags, "REPO_ROOT": REPO_ROOT,
             "LIB_PATH": LIB_PATH,
             "ADVANCE_LOCK_SITE": advance_lock_site()})


def advance_lock_site():
    """``integration.py:<line>``: the creation site of the port's
    ``ResilientFedAvgServer._advance_lock``, the lock identity FL126
    cites (the reference's test names its own file's line)."""
    path = os.path.join(REPO_ROOT, "fedml_tpu_torch", "resilience",
                        "integration.py")
    with open(path, encoding="utf-8") as fh:
        lines = [i for i, line in enumerate(fh, 1)
                 if "self._advance_lock = " in line]
    assert len(lines) == 1, lines
    return f"integration.py:{lines[0]}"


def reference_module(filename):
    """A whole reference test module (its imports all exist in the
    port) run against the port."""
    return retarget(filename, subs=PATH_SUBS)


def _strings_and_names(code):
    """Every string constant and global/attribute name of ``code`` and
    of the code objects nested in it."""
    strings, names = [], list(code.co_names)
    for const in code.co_consts:
        if isinstance(const, str):
            strings.append(const)
        elif isinstance(const, types.CodeType):
            s, n = _strings_and_names(const)
            strings += s
            names += n
    return strings, names


def _reference_refs(strings, names):
    bad = [s for s in strings
           if s == "fedml_tpu" or "fedml_tpu/" in s or "fedml_tpu." in s]
    return bad + [n for n in names
                  if n == "fedml_tpu" or n.startswith("fedml_tpu.")]


def assert_bound_to_the_port(module, classes):
    """No bound test, nor any string the module holds, keeps a
    ``fedml_tpu/`` path or a ``fedml_tpu.`` name, and the module reads
    the port's analyzer."""
    for name in ("lint_source", "lint_paths", "fedlint_main", "RULES",
                 "rule_tags"):
        if name in vars(module):
            assert getattr(module, name) is globals()[name], name
    glob = [v for v in vars(module).values() if isinstance(v, str)]
    assert not _reference_refs(glob, []), _reference_refs(glob, [])
    n_tests = 0
    for cls in classes:
        for attr, value in vars(cls).items():
            if isinstance(value, str):
                assert not _reference_refs([value], []), (cls, attr)
            code = getattr(value, "__code__", None)
            if code is None:
                continue
            n_tests += attr.startswith("test_")
            assert not _reference_refs(*_strings_and_names(code)), \
                (cls.__name__, attr, _reference_refs(
                    *_strings_and_names(code)))
    assert n_tests
