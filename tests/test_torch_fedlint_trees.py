"""The port's fedlint against the reference's over small trees, one for
each rule the two share unchanged.

FL107, FL108, FL115, FL123-FL125, FL129, FL130 and FL136 are
framework-neutral: the port keeps their logic and path globs, so on the
same tree both analyzers must report the same ``(path, line, col,
code)`` list. Each tree below trips its rule, so no case compares two
empty lists; the packages themselves lint clean under both analyzers
(``test_torch_fedlint_zero.py`` holds the port at 0, and compares the
two over ``tests/``). FL106 is left out: the port adds
``torch.stack``/``torch.cat`` to its sinks."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

from fedml_tpu.analysis.linter import lint_paths as ref_lint_paths
from fedml_tpu_torch.analysis.linter import lint_paths

SHARED = {"FL107", "FL108", "FL115", "FL123", "FL124", "FL125", "FL129",
          "FL130", "FL136"}

_LOCKED = ("import threading\n"
           "class C:\n"
           "    def __init__(self, register):\n"
           "        self._lock = threading.Lock()\n"
           "        self.state = 0\n"
           "        register(self._on_msg)\n")
_LOOP = ("import selectors, time\n"
         "class Loop:\n"
         "    def start(self):\n"
         "        self._sel.register(self._wake, selectors.EVENT_READ,\n"
         "                           (self._on_event, None))\n"
         "    def _on_event(self, conn, mask):\n")

#: code -> {relative path: source}; the first file of every tree trips
#: its code, and any other is one the rule must leave alone
TREES = {
    "FL107": {
        "core/comm/link.py": ("def recv(sock):\n"
                              "    try:\n"
                              "        return sock.recv(4)\n"
                              "    except Exception:\n"
                              "        pass\n"),
        "models/cnn.py": ("def f():\n"
                          "    try:\n"
                          "        return 1\n"
                          "    except Exception:\n"
                          "        pass\n")},
    "FL108": {
        "core/lib.py": "def f(x):\n    print('x =', x)\n    return x\n",
        "experiments/main_x.py": "def main():\n    print('usage: ...')\n"},
    "FL115": {
        "core/metrics_use.py": (
            "from fedml_tpu.observability.registry import get_registry\n"
            "reg = get_registry()\n"
            "def on_report(rank):\n"
            "    reg.inc('fed_reports_total', rank=rank)\n")},
    "FL123": {
        "core/state.py": _LOCKED + (
            "    def _on_msg(self, m):\n"
            "        with self._lock:\n"
            "            self.state = m\n"
            "    def snapshot(self):\n"
            "        return self.state\n")},
    "FL124": {
        "core/order.py": ("import threading\n"
                          "class C:\n"
                          "    def __init__(self):\n"
                          "        self._a = threading.Lock()\n"
                          "        self._b = threading.Lock()\n"
                          "    def one(self):\n"
                          "        with self._a:\n"
                          "            with self._b:\n"
                          "                pass\n"
                          "    def two(self):\n"
                          "        with self._b:\n"
                          "            with self._a:\n"
                          "                pass\n")},
    "FL125": {
        "core/sender.py": ("import threading\n"
                           "class C:\n"
                           "    def __init__(self):\n"
                           "        self._lock = threading.Lock()\n"
                           "    def send(self, sock, payload):\n"
                           "        with self._lock:\n"
                           "            sock.sendall(payload)\n")},
    "FL129": {
        "net/loop_read.py": _LOOP + "        time.sleep(0.1)\n"},
    "FL130": {
        "core/bypass.py": (
            "from fedml_tpu.resilience.policy import fold_entries_fp64\n"
            "def f(entries):\n"
            "    return fold_entries_fp64(entries)\n"),
        "program/own.py": (
            "from fedml_tpu.resilience.policy import fold_entries_fp64\n"
            "def f(entries):\n"
            "    return fold_entries_fp64(entries)\n")},
    "FL136": {
        "net/loop_write.py": _LOOP + (
            "        while not self._ready:\n"
            "            pass\n"
            "        conn.rx.extend(conn.sock.recv(4096))\n")},
}


def shared_findings(lint, tree):
    return [(f.path, f.line, f.col, f.code)
            for f in lint([tree], select=SHARED)]


@pytest.mark.parametrize("code", sorted(TREES))
def test_both_analyzers_agree_on_a_tree_that_trips(code, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    for rel, src in TREES[code].items():
        path = tmp_path / "pkg" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    port = shared_findings(lint_paths, "pkg")
    assert port == shared_findings(ref_lint_paths, "pkg")
    assert code in {c for *_, c in port}, port
    assert {p for p, *_ in port} == {"pkg/" + next(iter(TREES[code]))}


def test_the_trees_cover_every_shared_rule():
    assert set(TREES) == SHARED
