"""The port's fedlint on torch sources: counterparts, with the same
asserts, of the reference's ``tests/test_analysis.py`` classes whose
snippets are keyed on JAX (``TestSuppressions``, ``TestBaseline``,
``TestCli``, ``TestSarif``, ``TestSarifRuleMetadata``; the ``--fix``
flag of ``TestDonationFix``, refused here), FL110's torch meaning (a
CUDA-graph output read after the next replay), the torch shapes of the
traced-site rules, and the codes of the five project-wide passes, which
the CLI refused (exit 2) until the passes were ported and now takes as
it takes any other code."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import ast
import json
import os

import pytest

from fedml_tpu_torch.analysis import RULES, lint_paths, lint_source
from fedml_tpu_torch.analysis.cli import DEFAULT_BASELINE
from fedml_tpu_torch.analysis.cli import main as fedlint_main
from fedml_tpu_torch.analysis.linter import (KERNEL_ENTRY_POINTS,
                                             PASS_CODES,
                                             apply_baseline, load_baseline,
                                             render_json, render_sarif,
                                             render_text, rule_tags,
                                             write_baseline)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_PATH = "fedml_tpu_torch/core/fake.py"

#: one FL103 finding at line 3 (the reference's fixtures use FL104,
#: which has no torch meaning)
SRC = ("import torch\n"
       "@torch.compile\n"
       "def round_fn(x, n=4):\n"
       "    return x * n\n")

#: the reference's whole catalog: the per-module rules and the codes of
#: the five project-wide passes
PORTED = {"FL101", "FL102", "FL103", "FL104", "FL105", "FL106", "FL107",
          "FL108", "FL109", "FL110", "FL111", "FL112", "FL113", "FL114",
          "FL115", "FL123", "FL124", "FL125", "FL129", "FL130", "FL136",
          "FL120", "FL121", "FL122", "FL126", "FL127", "FL128",
          "FL131", "FL132", "FL133", "FL134", "FL135",
          "FL140", "FL141", "FL142", "FL143",
          "FL150", "FL151", "FL152", "FL153"}
JAX_KEYED = ("FL101", "FL102", "FL103", "FL104", "FL105", "FL109",
             "FL110", "FL111", "FL112", "FL113", "FL114", "FL133",
             "FL150", "FL151")

#: a server whose sync no client registers a handler for: one FL120
UNHANDLED_SEND = (
    "from fedml_tpu_torch.core.managers import ClientManager, ServerManager\n"
    "from fedml_tpu_torch.core.comm.base import MSG_TYPE_PEER_LOST\n"
    "from fedml_tpu_torch.core.message import Message\n"
    "class Srv(ServerManager):\n"
    "    def register_message_receive_handlers(self):\n"
    "        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,\n"
    "                                              self._on_lost)\n"
    "    def open_round(self):\n"
    "        self.send_message(Message('sync', 0, 1))\n"
    "    def _on_lost(self, msg):\n"
    "        self.finish()\n"
    "class Cli(ClientManager):\n"
    "    def register_message_receive_handlers(self):\n"
    "        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,\n"
    "                                              self._on_lost)\n"
    "    def _on_lost(self, msg):\n"
    "        self.finish()\n")


def codes(src, path=LIB_PATH):
    return [f.code for f in lint_source(src, path=path)]


def lines(src, path=LIB_PATH):
    return [(f.line, f.code) for f in lint_source(src, path=path)]


# -- the rule table -------------------------------------------------------

class TestRuleTable:
    def test_rules_hold_exactly_the_ported_codes(self):
        assert set(RULES) == PORTED
        assert len(RULES) == 40
        assert set().union(*PASS_CODES.values()) <= set(RULES)

    def test_each_jax_keyed_code_says_its_torch_meaning(self):
        for code in JAX_KEYED:
            title, rationale = RULES[code]
            text = title + " " + rationale
            assert "torch" in text or "CUDA" in text, code
            assert "jax.jit" not in text, code

    @pytest.mark.parametrize("code", ["FL104", "FL111"])
    def test_codes_with_no_torch_meaning_say_so(self, code):
        assert RULES[code][1].startswith("no torch meaning")

    def test_list_rules_prints_every_code(self, capsys):
        assert fedlint_main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for code in RULES:
            assert code in out
        # FL104 and FL111, and FL133's constant PRNGKey branch
        assert out.count("no torch meaning") == 3
        assert "`PRNGKey` literal has no torch meaning" in RULES["FL133"][1]


# -- suppressions (TestSuppressions) --------------------------------------

class TestSuppressions:
    SRC = ("import torch\n"
           "@torch.compile\n"
           "def f(x):\n"
           "    return float(x)  # fedlint: disable=FL101\n")

    def test_line_suppression(self):
        assert codes(self.SRC) == []

    def test_line_suppression_is_code_specific(self):
        assert codes(self.SRC.replace("FL101", "FL105")) == ["FL101"]

    def test_bare_disable_suppresses_all_codes(self):
        assert codes(self.SRC.replace("disable=FL101", "disable")) == []

    def test_file_level_suppression(self):
        src = ("# fedlint: disable-file=FL101\n"
               + self.SRC.replace("  # fedlint: disable=FL101", ""))
        assert codes(src) == []


# -- baseline (TestBaseline) ----------------------------------------------

class TestBaseline:
    def _findings(self, tmp_path):
        mod = tmp_path / "mod.py"
        mod.write_text(SRC)
        return lint_paths([str(mod)])

    def test_baseline_roundtrip_tolerates_known_findings(self, tmp_path):
        findings = self._findings(tmp_path)
        assert [f.code for f in findings] == ["FL103"]
        bl = tmp_path / "baseline.json"
        write_baseline(findings, str(bl))
        fresh = self._findings(tmp_path)
        new = apply_baseline(fresh, load_baseline(str(bl)))
        assert new == [] and fresh[0].baselined

    def test_new_findings_not_in_baseline_fail(self, tmp_path):
        bl = tmp_path / "baseline.json"
        write_baseline([], str(bl))
        new = apply_baseline(self._findings(tmp_path),
                             load_baseline(str(bl)))
        assert [f.code for f in new] == ["FL103"]

    def test_baseline_keys_on_text_not_line_numbers(self, tmp_path):
        findings = self._findings(tmp_path)
        bl = tmp_path / "baseline.json"
        write_baseline(findings, str(bl))
        (tmp_path / "mod.py").write_text("# a new leading comment\n" + SRC)
        new = apply_baseline(self._findings(tmp_path),
                             load_baseline(str(bl)))
        assert new == []

    def test_missing_baseline_file_is_empty(self, tmp_path):
        assert load_baseline(str(tmp_path / "nope.json")) == {}


# -- CLI (TestCli, TestDonationFix's CLI cases) ---------------------------

class TestCli:
    def _mod(self, tmp_path, src=SRC):
        mod = tmp_path / "mod.py"
        mod.write_text(src)
        return str(mod)

    def test_exit_1_on_new_findings_0_with_baseline(self, tmp_path, capsys):
        mod = self._mod(tmp_path)
        bl = tmp_path / "baseline.json"
        assert fedlint_main([mod, "--baseline", ""]) == 1
        assert fedlint_main([mod, "--baseline", str(bl),
                             "--write-baseline"]) == 0
        assert fedlint_main([mod, "--baseline", str(bl)]) == 0
        capsys.readouterr()

    def test_json_reporter(self, tmp_path, capsys):
        rc = fedlint_main([self._mod(tmp_path), "--baseline", "",
                           "--format", "json"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert out["summary"]["new"] == 1
        assert out["findings"][0]["code"] == "FL103"

    def test_select_and_ignore(self, tmp_path, capsys):
        mod = self._mod(tmp_path)
        assert fedlint_main([mod, "--baseline", "", "--select",
                             "FL101"]) == 0
        assert fedlint_main([mod, "--baseline", "", "--ignore",
                             "FL103"]) == 0
        capsys.readouterr()

    def test_reporters_render(self, tmp_path):
        findings = lint_paths([self._mod(tmp_path)])
        assert "FL103" in render_text(findings)
        assert json.loads(render_json(findings))["summary"]["total"] == 1

    def test_default_baseline_is_package_anchored(self):
        assert os.path.isabs(DEFAULT_BASELINE)
        assert os.path.exists(DEFAULT_BASELINE)
        assert os.path.dirname(DEFAULT_BASELINE) == os.path.join(
            REPO_ROOT, "fedml_tpu_torch", "analysis")

    def test_shipped_baseline_is_empty(self):
        with open(DEFAULT_BASELINE, encoding="utf-8") as fh:
            assert json.load(fh) == {"findings": [], "version": 1}

    def test_default_path_is_the_port(self, tmp_path, monkeypatch,
                                      capsys):
        # run from a directory holding only a fedml_tpu_torch/ with one
        # finding: the default path lints it
        (tmp_path / "fedml_tpu_torch").mkdir()
        (tmp_path / "fedml_tpu_torch" / "m.py").write_text(SRC)
        monkeypatch.chdir(tmp_path)
        assert fedlint_main(["--baseline", "", "--format", "json"]) == 1
        out = json.loads(capsys.readouterr().out)
        assert [f["path"] for f in out["findings"]] == [
            "fedml_tpu_torch/m.py"]

    @pytest.mark.parametrize("argv", [
        ["--select", "FL120"], ["--ignore", "FL131,FL135"],
        ["--select", "FL101,FL141"], ["--ignore", "FL126"],
        ["--select", "fl150"]])
    def test_codes_of_unported_passes_are_a_usage_error(self, tmp_path,
                                                        capsys, argv):
        """These codes were a usage error (exit 2) while their passes
        were not ported; they now filter as any code does: a clean
        module exits 0, and the passes run on a planted one."""
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        assert fedlint_main([str(clean), "--baseline", ""] + argv) == 0
        capsys.readouterr()
        planted = self._mod(tmp_path, UNHANDLED_SEND)
        assert fedlint_main([planted, "--baseline", "", "--format", "json"]
                            + argv + ["--select", "FL120"]) == 1
        out = json.loads(capsys.readouterr().out)
        assert [f["code"] for f in out["findings"]] == ["FL120"]

    def test_unknown_codes_stay_a_silent_filter(self, tmp_path, capsys):
        # as in the reference: a code no pass owns selects nothing
        assert fedlint_main([self._mod(tmp_path), "--baseline", "",
                             "--select", "FL999"]) == 0
        capsys.readouterr()


class TestFix:
    """The reference's ``--fix``/``--diff`` (its FL104 donation fixer):
    torch has no donation, so the port's CLI has no such flags and
    refuses them as usage errors, writing nothing."""

    @pytest.mark.parametrize("flags", [["--fix"], ["--diff"],
                                       ["--fix", "--diff"]])
    def test_fix_flags_are_usage_errors(self, flags, tmp_path, capsys):
        mod = tmp_path / "mod.py"
        mod.write_text(SRC)
        with pytest.raises(SystemExit) as exc:
            fedlint_main([str(mod)] + flags)
        assert exc.value.code == 2
        assert "unrecognized arguments" in capsys.readouterr().err
        assert mod.read_text() == SRC

    def test_no_donation_fixer_is_stated(self):
        assert "no donation fixer" in RULES["FL104"][1]


# -- SARIF (TestSarif, TestSarifRuleMetadata) -----------------------------

class TestSarif:
    def test_sarif_structure_and_result(self, tmp_path):
        mod = tmp_path / "mod.py"
        mod.write_text(SRC)
        doc = json.loads(render_sarif(lint_paths([str(mod)])))
        assert doc["version"] == "2.1.0"
        run = doc["runs"][0]
        assert run["tool"]["driver"]["name"] == "fedlint"
        rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
        assert {"FL103", "FL110", "FL123"} <= rule_ids
        assert rule_ids == set(RULES) | {"FL100"}
        res = run["results"][0]
        assert res["ruleId"] == "FL103"
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith("mod.py")
        assert loc["region"]["startLine"] == 3
        assert "suppressions" not in res

    def test_sarif_marks_baselined_as_suppressed(self, tmp_path):
        mod = tmp_path / "mod.py"
        mod.write_text(SRC)
        bl = tmp_path / "bl.json"
        write_baseline(lint_paths([str(mod)]), str(bl))
        fresh = lint_paths([str(mod)])
        apply_baseline(fresh, load_baseline(str(bl)))
        doc = json.loads(render_sarif(fresh))
        assert doc["runs"][0]["results"][0]["suppressions"]

    def test_cli_sarif_out_single_run_two_reports(self, tmp_path, capsys):
        mod = tmp_path / "mod.py"
        mod.write_text(SRC)
        out = tmp_path / "rep.sarif"
        rc = fedlint_main([str(mod), "--baseline", "", "--format", "json",
                           "--sarif-out", str(out)])
        json_doc = json.loads(capsys.readouterr().out)
        assert rc == 1 and json_doc["summary"]["new"] == 1
        sarif = json.loads(out.read_text())
        assert sarif["runs"][0]["results"][0]["ruleId"] == "FL103"

    def test_cli_sarif_format(self, tmp_path, capsys):
        mod = tmp_path / "mod.py"
        mod.write_text(SRC)
        rc = fedlint_main([str(mod), "--baseline", "", "--format", "sarif"])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert doc["runs"][0]["results"][0]["ruleId"] == "FL103"
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        assert fedlint_main([str(clean), "--baseline", "",
                             "--format", "sarif"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["runs"][0]["results"] == []

    def test_rules_carry_pass_tags(self):
        doc = json.loads(render_sarif([]))
        rules = {r["id"]: r for r in doc["runs"][0]["tool"]["driver"]["rules"]}
        assert rules["FL124"]["properties"]["tags"] == [
            "fedcheck-concurrency", "race-audit-crossref"]
        assert rules["FL123"]["properties"]["tags"] == [
            "fedcheck-concurrency"]
        assert rules["FL130"]["properties"]["tags"] == ["fedlint-program"]
        assert rules["FL101"]["properties"]["tags"] == ["fedlint-torch"]
        assert rule_tags("FL125") == ["fedcheck-concurrency",
                                      "race-audit-crossref"]
        assert rule_tags("FL126") == ["fedcheck-concurrency",
                                      "race-audit-crossref"]
        for tag, codes_ in (("fedcheck-protocol", PASS_CODES["protocol"]),
                            ("fedcheck-determinism",
                             PASS_CODES["determinism"]),
                            ("fedcheck-model", PASS_CODES["modelcheck"]),
                            ("fedcheck-privacy", PASS_CODES["privacy"])):
            for code in codes_:
                assert rules[code]["properties"]["tags"] == [tag], code

    def test_catalog_entries_are_whole(self):
        for code, (title, rationale) in RULES.items():
            assert code.startswith("FL") and title and rationale


# -- FL110: graph outputs read after the next replay ----------------------

GRAPHED = ("import torch\n"
           "step = torch.cuda.make_graphed_callables(model, (x,))\n")


class TestUseAfterReplay:
    def test_read_after_next_call_fires(self):
        src = GRAPHED + ("def caller(a, b):\n"
                         "    y1 = step(a)\n"
                         "    y2 = step(b)\n"
                         "    return y1 + y2\n")
        found = lint_source(src, path=LIB_PATH)
        assert [(f.line, f.code) for f in found] == [(6, "FL110")]
        assert "overwrote" in found[0].message and "`step`" in \
            found[0].message

    def test_rebind_idiom_is_clean(self):
        src = GRAPHED + ("def caller(a, b):\n"
                         "    out = step(a)\n"
                         "    out = step(b)\n"
                         "    return out\n")
        assert codes(src) == []

    def test_clone_is_clean(self):
        src = GRAPHED + ("def caller(a, b):\n"
                         "    y1 = step(a).clone()\n"
                         "    y2 = step(b)\n"
                         "    return y1 + y2\n")
        assert codes(src) == []

    def test_views_and_aliases_stay_graphed(self):
        src = GRAPHED + ("def caller(a, b):\n"
                         "    y1 = step(a)[0].detach()\n"
                         "    keep = y1\n"
                         "    y2 = step(b)\n"
                         "    return keep\n")
        assert lines(src) == [(7, "FL110")]

    def test_kept_in_a_loop_fires(self):
        src = GRAPHED + ("def caller(xs):\n"
                         "    outs = []\n"
                         "    for x in xs:\n"
                         "        outs.append(step(x))\n"
                         "    return outs\n")
        assert lines(src) == [(6, "FL110")]

    def test_loop_with_clone_or_rebind_is_clean(self):
        src = GRAPHED + ("def caller(xs):\n"
                         "    outs = []\n"
                         "    for x in xs:\n"
                         "        outs.append(step(x).clone())\n"
                         "        last = step(x)\n"
                         "        total = last.sum()\n"
                         "    return outs, last\n")
        assert codes(src) == []

    def test_mutually_exclusive_branches_do_not_cross_stale(self):
        src = GRAPHED + ("def caller(a, b, c):\n"
                         "    y = step(a)\n"
                         "    if c:\n"
                         "        z = step(b)\n"
                         "    else:\n"
                         "        z = y\n"
                         "    return z\n")
        assert codes(src) == []
        src_after = GRAPHED + ("def caller(a, b, c):\n"
                               "    y = step(a)\n"
                               "    if c:\n"
                               "        z = step(b)\n"
                               "    return y\n")
        assert lines(src_after) == [(7, "FL110")]

    def test_cuda_graph_static_output_alias(self):
        src = ("import torch\n"
               "g = torch.cuda.CUDAGraph()\n"
               "with torch.cuda.graph(g):\n"
               "    static_out = model(static_in)\n"
               "def serve():\n"
               "    g.replay()\n"
               "    first = static_out\n"
               "    g.replay()\n"
               "    fresh = static_out.sum()\n"
               "    return first, fresh\n")
        assert lines(src) == [(10, "FL110")]

    def test_reduce_overhead_compile_through_self_attr(self):
        src = ("import torch\n"
               "class Runner:\n"
               "    def __init__(self, model, mode):\n"
               "        self.fast = torch.compile(model,\n"
               "                                  mode='reduce-overhead')\n"
               "        self.plain = torch.compile(model)\n"
               "    def run(self, a, b):\n"
               "        y = self.fast(a)\n"
               "        z = self.fast(b)\n"
               "        p = self.plain(a)\n"
               "        q = self.plain(b)\n"
               "        return y, p\n")
        # the default mode replays no CUDA graph: its outputs are fresh
        assert lines(src) == [(12, "FL110")]

    def test_cross_module_builder_contract(self, tmp_path):
        (tmp_path / "mod_a.py").write_text(
            "import torch\n"
            "def make_step(model, x):\n"
            "    fn = torch.cuda.make_graphed_callables(model, (x,))\n"
            "    return fn\n")
        (tmp_path / "mod_b.py").write_text(
            "from mod_a import make_step\n"
            "def caller(model, a, b):\n"
            "    fn = make_step(model, a)\n"
            "    y1 = fn(a)\n"
            "    y2 = fn(b)\n"
            "    return y1\n")
        found = lint_paths([str(tmp_path)])
        assert [(f.code, f.line, f.path.endswith("mod_b.py"))
                for f in found] == [("FL110", 6, True)]

    def test_two_graphs_do_not_stale_each_other(self):
        src = ("import torch\n"
               "fwd, bwd = torch.cuda.make_graphed_callables((m1, m2),\n"
               "                                             ((x,), (y,)))\n"
               "def caller(a, b):\n"
               "    h = fwd(a)\n"
               "    o = bwd(b)\n"
               "    return h, o\n")
        assert codes(src) == []


# -- the traced-site rules in their torch shapes --------------------------

class TestTracedSites:
    @pytest.mark.parametrize("head", [
        "@torch.compile\n",
        "@torch.compile(mode='reduce-overhead')\n",
        "@partial(torch.compile, fullgraph=True)\n",
        "@torch.jit.script\n",
    ])
    def test_decorator_forms_are_traced_sites(self, head):
        src = ("import torch\nfrom functools import partial\n" + head
               + "def f(x):\n    return x.cpu().numpy() + x.tolist()\n")
        assert codes(src) == ["FL101", "FL101", "FL101"]

    @pytest.mark.parametrize("wrap", [
        "torch.jit.trace(f, (x,))",
        "torch.cuda.make_graphed_callables(f, (x,))",
        "torch.compile(f, mode='max-autotune')",
    ])
    def test_wrap_forms_are_traced_sites(self, wrap):
        src = ("import torch\n"
               "def f(x):\n"
               "    torch.cuda.synchronize()\n"
               "    return x\n"
               f"g = {wrap}\n")
        assert lines(src) == [(3, "FL101")]

    def test_cuda_graph_capture_block(self):
        src = ("import torch\n"
               "g = torch.cuda.CUDAGraph()\n"
               "with torch.cuda.graph(g):\n"
               "    y = model(x)\n"
               "    n = int(y.sum())\n"
               "print_after = float(y.sum())\n")
        assert lines(src) == [(5, "FL101")]

    def test_scalar_param_casts_are_not_syncs(self):
        src = ("import torch\n"
               "@torch.jit.script\n"
               "def f(x, n: int = 2):\n"
               "    if n > 1:\n"
               "        return x * float(n)\n"
               "    return x\n")
        assert codes(src) == []

    def test_fl103_dynamic_makes_ints_symbolic_not_bools(self):
        src = ("import torch\n"
               "def g(x, n=4, flag=True):\n"
               "    return x * n if flag else x\n"
               "step = torch.compile(g, dynamic=True)\n")
        found = lint_source(src, path=LIB_PATH)
        assert [f.code for f in found] == ["FL103"]
        assert "(flag)" in found[0].message

    def test_fl103_is_torch_compile_only(self):
        src = ("import torch\n"
               "@torch.jit.script\n"
               "def g(x, n: int = 4):\n"
               "    return x * n\n")
        assert codes(src) == []

    def test_fl106_torch_cat(self):
        src = ("import torch\n"
               "def f(d):\n"
               "    return torch.cat([t.reshape(-1) for t in d.values()])\n")
        assert lines(src) == [(3, "FL106")]

    def test_no_finding_for_donation_or_scan_carries(self):
        # the reference's FL104 and FL111 positives, in torch: the
        # constructs they flag do not exist, and nothing is reported
        src = ("import torch\n"
               "@torch.compile\n"
               "def round_fn(state, data):\n"
               "    return state\n"
               "def f(xs):\n"
               "    c = 0\n"
               "    for x in xs:\n"
               "        c = c + x\n"
               "    return c\n")
        assert codes(src) == []


class TestReplicatedPlacement:
    PUT = ("from fedml_tpu_torch.parallel.multihost import global_put\n"
           "from fedml_tpu_torch.parallel.mesh import (client_sharding,\n"
           "                                          replicated_sharding)\n")

    def test_replicated_sharding_and_default_spec_fire(self):
        src = self.PUT + ("def step(mesh, params, batch):\n"
                          "    p = global_put(mesh, params)\n"
                          "    b = global_put(mesh, batch,\n"
                          "                   replicated_sharding(mesh))\n"
                          "    return p, b\n")
        assert lines(src) == [(5, "FL109")]

    def test_one_split_operand_is_clean(self):
        src = self.PUT + ("def step(mesh, params, batch):\n"
                          "    p = global_put(mesh, params)\n"
                          "    b = global_put(mesh, batch,\n"
                          "                   client_sharding(mesh))\n"
                          "    return p, b\n")
        assert codes(src) == []

    def test_the_port_placements_are_clean(self, monkeypatch):
        monkeypatch.chdir(REPO_ROOT)
        assert lint_paths(["fedml_tpu_torch/parallel"],
                          select={"FL109"}) == []


def _launches_directly(fn):
    """``launches += 1`` / ``launches[name] += 1`` in ``fn``'s own body:
    the counts each kernel wrapper bumps where it launches."""
    for node in _own_nodes(fn):
        if isinstance(node, ast.AugAssign):
            target = node.target
            if isinstance(target, ast.Subscript):
                target = target.value
            if isinstance(target, ast.Name) and target.id == "launches":
                return True
    return False


def _own_nodes(fn):
    """The nodes of ``fn``'s body, nested functions and lambdas left out
    (a closure it returns is not run by calling it)."""
    todo = list(fn.body)
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.Lambda)):
                todo.append(child)


def ops_kernel_launchers():
    """The public top-level functions of ``fedml_tpu_torch/ops/`` whose
    call reaches a kernel launch: through the module's own functions,
    functions from-imported from another ops module, and ``Cls.apply``
    of an autograd Function (its ``forward`` and ``backward``)."""
    ops_dir = os.path.join(REPO_ROOT, "fedml_tpu_torch", "ops")
    funcs, callees = {}, {}
    for fname in sorted(os.listdir(ops_dir)):
        if not fname.endswith(".py"):
            continue
        mod = fname[:-3]
        tree = ast.parse(open(os.path.join(ops_dir, fname)).read())
        local, classes = {}, {}
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and (node.module or "") \
                    .startswith("fedml_tpu_torch.ops."):
                src = node.module.rsplit(".", 1)[1]
                for a in node.names:
                    local[a.asname or a.name] = (src, a.name)
            elif isinstance(node, ast.FunctionDef):
                local[node.name] = (mod, node.name)
                funcs[(mod, node.name)] = node
            elif isinstance(node, ast.ClassDef):
                classes[node.name] = node
                for m in node.body:
                    if isinstance(m, ast.FunctionDef):
                        funcs[(mod, node.name + "." + m.name)] = m
        for key, fn in list(funcs.items()):
            if key[0] != mod:
                continue
            out = set()
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id in local:
                    out.add(local[f.id])
                elif (isinstance(f, ast.Attribute) and f.attr == "apply"
                      and isinstance(f.value, ast.Name)
                      and f.value.id in classes):
                    out |= {(mod, f.value.id + ".forward"),
                            (mod, f.value.id + ".backward")}
            callees[key] = out
    launching = {k for k, fn in funcs.items() if _launches_directly(fn)}
    grew = True
    while grew:
        more = {k for k, out in callees.items() if out & launching}
        grew = not more <= launching
        launching |= more
    return {name for (_, name) in launching
            if "." not in name and not name.startswith("_")}


class TestWallclockTiming:
    HEAD = "import time\nimport torch\n"

    def test_kernel_entry_points_are_the_ops_launchers(self):
        """FL114's hand-kept set holds exactly the public functions of
        the ops package that launch a kernel, so a new entry point
        cannot escape the rule unseen."""
        assert KERNEL_ENTRY_POINTS == ops_kernel_launchers()

    def test_kernel_entry_point_through_an_ops_module(self):
        src = self.HEAD + (
            "from fedml_tpu_torch.ops import flash_attention as fa\n"
            "def measure(q, k, v):\n"
            "    t0 = time.perf_counter()\n"
            "    o = fa.flash_attention(q, k, v)\n"
            "    return time.perf_counter() - t0\n")
        assert lines(src) == [(7, "FL114")]

    def test_from_imported_kernel_entry_point(self):
        src = self.HEAD + (
            "from fedml_tpu_torch.ops.grouped_conv import grouped_conv_dw\n"
            "def measure(x, g):\n"
            "    t0 = time.time()\n"
            "    dw = grouped_conv_dw(x, g)\n"
            "    return time.time() - t0\n")
        assert lines(src) == [(7, "FL114")]

    def test_nn_module_instance_call(self):
        src = self.HEAD + (
            "import torch.nn as nn\n"
            "class Net(nn.Module):\n"
            "    pass\n"
            "model = nn.Linear(4, 4)\n"
            "net = Net()\n"
            "def measure(x):\n"
            "    t0 = time.time()\n"
            "    y = model(x)\n"
            "    dt = time.time() - t0\n"
            "    t1 = time.time()\n"
            "    z = net(x)\n"
            "    return dt, time.time() - t1\n")
        assert lines(src) == [(11, "FL114"), (14, "FL114")]

    def test_cuda_events_and_value_fetches_sync(self):
        src = self.HEAD + (
            "model = torch.nn.Linear(4, 4)\n"
            "def measure(x, start, end):\n"
            "    t0 = time.time()\n"
            "    start.record()\n"
            "    y = model(x)\n"
            "    end.record()\n"
            "    ms = start.elapsed_time(end)\n"
            "    dt = time.time() - t0\n"
            "    t1 = time.time()\n"
            "    n = model(x).tolist()\n"
            "    return dt, time.time() - t1\n")
        assert codes(src) == []

    def test_graph_replay(self):
        src = self.HEAD + (
            "g = torch.cuda.CUDAGraph()\n"
            "def measure():\n"
            "    t0 = time.time()\n"
            "    g.replay()\n"
            "    return time.time() - t0\n")
        assert lines(src) == [(7, "FL114")]

    def test_traced_builder_return_across_modules(self, tmp_path):
        (tmp_path / "builders.py").write_text(
            "import torch\n"
            "def make_step(model):\n"
            "    fn = torch.compile(model)\n"
            "    return fn\n")
        (tmp_path / "timing.py").write_text(
            "import time\n"
            "from builders import make_step\n"
            "def measure(model, x):\n"
            "    step = make_step(model)\n"
            "    t0 = time.time()\n"
            "    y = step(x)\n"
            "    return time.time() - t0\n")
        found = lint_paths([str(tmp_path)])
        assert [(f.code, f.line, f.path.endswith("timing.py"))
                for f in found] == [("FL114", 7, True)]


# -- the analyzer's cached walk --------------------------------------------

class TestAstWalk:
    def test_walk_is_ast_walk_over_every_file_of_the_port(self):
        from fedml_tpu_torch.analysis.astwalk import walk
        from fedml_tpu_torch.analysis.linter import iter_python_files
        for path in iter_python_files([os.path.join(REPO_ROOT,
                                                    "fedml_tpu_torch")]):
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            want = list(ast.walk(tree))
            assert list(walk(tree)) == want, path
            # the second walk reads the kept list: the same nodes again
            assert list(walk(tree)) == want, path
            fn = next((n for n in want if isinstance(n, ast.FunctionDef)),
                      None)
            if fn is not None:
                assert list(walk(fn)) == list(ast.walk(fn)), path

    def test_a_partial_walk_leaves_the_next_one_whole(self):
        from fedml_tpu_torch.analysis.astwalk import walk
        tree = ast.parse("def f(x):\n    return [y for y in x if y]\n")
        it = walk(tree)
        next(it)
        assert list(walk(tree)) == list(ast.walk(tree))
