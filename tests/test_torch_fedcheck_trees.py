"""The port's five project-wide passes against the reference's over small
trees, one for each of their rules the port keeps framework-neutral.

FL120-FL122, FL126-FL128, FL131, FL132, FL134, FL135, FL140-FL143,
FL152 and FL153 run in the port as the reference's code does, so on the
same tree both analyzers must report the same ``(path, line, col,
code)`` list over the 19 codes of the passes. Each tree trips its rule,
so no case compares two empty lists. FL133, FL150 and FL151 read torch
calls in the port and are held against the reference pair by pair
(``test_torch_fedcheck_pairs.py``)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

from fedml_tpu.analysis.linter import lint_paths as ref_lint_paths
from fedml_tpu_torch.analysis.linter import PASS_CODES, lint_paths

PASSES = set().union(*PASS_CODES.values())
NEUTRAL = PASSES - {"FL133", "FL150", "FL151"}

#: the healthy server x 2 clients protocol the model checker's fixtures
#: compose; each tree below breaks one thing in it
_BASE = (
    "import logging\n"
    "from fedml_tpu_torch.core.managers import ClientManager, ServerManager\n"
    "from fedml_tpu_torch.core.comm.base import MSG_TYPE_PEER_LOST\n"
    "from fedml_tpu_torch.core.message import Message\n"
    "MSG_SYNC = 'sync'\n"
    "MSG_REPORT = 'report'\n"
    "class Srv(ServerManager):\n"
    "    def register_message_receive_handlers(self):\n"
    "        self.register_message_receive_handler(MSG_REPORT,\n"
    "                                              self._on_report)\n"
    "        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,\n"
    "                                              self._on_lost)\n"
    "    def open_round(self):\n"
    "        self.send_message(Message(MSG_SYNC, 0, 1))\n"
    "    def _on_report(self, msg):\n"
    "        logging.debug('report from %s', msg.get_sender_id())\n"
    "        self.folded.add(msg.get_sender_id())\n"
    "    def _on_lost(self, msg):\n"
    "        logging.warning('rank %s lost', msg.get_sender_id())\n"
    "        self.cohort.discard(msg.get_sender_id())\n"
    "class Cli(ClientManager):\n"
    "    def register_message_receive_handlers(self):\n"
    "        self.register_message_receive_handler(MSG_SYNC,\n"
    "                                              self._on_sync)\n"
    "        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,\n"
    "                                              self._on_cli_lost)\n"
    "    def _on_sync(self, msg):\n"
    "        self.send_message(Message(MSG_REPORT, 1, 0))\n"
    "    def _on_cli_lost(self, msg):\n"
    "        self.finish()\n")

_REPORT_REG = (
    "        self.register_message_receive_handler(MSG_REPORT,\n"
    "                                              self._on_report)\n")
_LOST_REG = (
    "        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,\n"
    "                                              self._on_lost)\n")
_FOLD = "        self.folded.add(msg.get_sender_id())\n"
_SHED = "        self.cohort.discard(msg.get_sender_id())\n"


def _base(old="", new="", count=-1):
    assert not old or old in _BASE, old
    return _BASE.replace(old, new, count) if old else _BASE


#: a client that writes the 'flag' key and a server reading it
_FLAGGED = (
    "import logging\n"
    "from fedml_tpu_torch.core.managers import ClientManager, ServerManager\n"
    "from fedml_tpu_torch.core.comm.base import MSG_TYPE_PEER_LOST\n"
    "from fedml_tpu_torch.core.message import Message\n"
    "MSG_A = 'a'\n"
    "MSG_B = 'b'\n"
    "class Cli(ClientManager):\n"
    "    def register_message_receive_handlers(self):\n"
    "        self.register_message_receive_handler(MSG_A, self._on_a)\n"
    "        self.register_message_receive_handler(\n"
    "            MSG_TYPE_PEER_LOST, self._on_lost)\n"
    "    def _on_a(self, msg):\n"
    "        m = Message(MSG_B, 1, 0)\n"
    "        m.add('flag', 1)\n"
    "        self.send_message(m)\n"
    "    def _on_lost(self, msg):\n"
    "        self.finish()\n"
    "class Srv(ServerManager):\n"
    "    def register_message_receive_handlers(self):\n"
    "        self.register_message_receive_handler(MSG_B, self._on_b)\n"
    "        self.register_message_receive_handler(\n"
    "            MSG_TYPE_PEER_LOST, self._on_lost)\n"
    "    def _on_lost(self, msg):\n"
    "        self.finish()\n"
    "    def _on_b(self, msg):\n")

#: code -> {relative path: source}; the first file of every tree trips
#: its code, and any other is one the rule must leave alone
TREES = {
    "FL120": {"core/fsm.py": _base(_REPORT_REG)},
    "FL121": {"core/fsm.py": _base(_LOST_REG, "", 1)},
    "FL122": {"core/fsm.py": _base(
        "    def _on_sync(self, msg):\n",
        "        self.register_message_receive_handler('zombie',\n"
        "                                              self._on_sync)\n"
        "    def _on_sync(self, msg):\n")},
    "FL126": {
        "core/relay.py": (
            "from fedml_tpu_torch.core.locks import audited_lock\n"
            "class A:\n"
            "    def __init__(self):\n"
            "        self.b = B(self)\n"
            "    def ping(self, n):\n"
            "        self.sock.sendall(b'')\n"
            "        self.b.pong(n)\n"
            "class B:\n"
            "    def __init__(self, a):\n"
            "        self.a = a\n"
            "    def pong(self, n):\n"
            "        self.a.ping(n)\n"
            "class H:\n"
            "    def __init__(self):\n"
            "        self._lock = audited_lock()\n"
            "        self.b = B(A())\n"
            "    def handler(self, msg):\n"
            "        with self._lock:\n"
            "            self.b.pong(0)\n"),
        "core/quiet.py": (
            "from fedml_tpu_torch.core.locks import audited_lock\n"
            "class H:\n"
            "    def __init__(self):\n"
            "        self._lock = audited_lock()\n"
            "    def handler(self, msg):\n"
            "        with self._lock:\n"
            "            self.count = 1\n"
            "        self.sock.sendall(b'')\n")},
    "FL127": {"core/fsm.py": _FLAGGED + (
        "        if msg.get('flag'):\n"
        "            self.send_message(Message(MSG_A, 0, 1))\n")},
    "FL128": {"core/fsm.py": _FLAGGED.replace(
        "m.add('flag', 1)", "m.add('flagg', 1)") + (
        "        if msg.get('flag'):\n"
        "            self.send_message(Message(MSG_A, 0, 1))\n"
        "        else:\n"
        "            self.finish()\n")},
    "FL131": {
        "core/folds.py": (
            "def fold_reports(reports):\n"
            "    return sum(float(v[0]) for v in reports.values())\n"),
        "core/tally.py": (
            "def fold_counts(reports):\n"
            "    return sum(reports.values())\n")},
    "FL132": {
        "resilience/steering_law.py": (
            "import time\n"
            "class PaceLaw:\n"
            "    def decide(self, obs):\n"
            "        now = time.time()\n"
            "        if now - self._last > 30.0:\n"
            "            return self._backoff()\n"
            "        return None\n"),
        "resilience/policy.py": (
            "import time\n"
            "class Deadline:\n"
            "    def expired(self):\n"
            "        return time.monotonic() > self._deadline\n")},
    "FL134": {
        "core/agg.py": (
            "class AggServer:\n"
            "    def handle_receive_message(self, msg):\n"
            "        self._fold_in(msg)\n"
            "    def _fold_in(self, msg):\n"
            "        self.total += float(msg.get('weight'))\n"),
        "core/summary.py": (
            "class Summary:\n"
            "    def tally(self, xs):\n"
            "        for x in xs:\n"
            "            self.total += float(x)\n")},
    "FL135": {
        "observability/status_out.py": (
            "import json\n"
            "def write(path, snapshot):\n"
            "    with open(path, 'w') as f:\n"
            "        json.dump(snapshot, f, indent=2)\n"),
        "models/notes.py": (
            "import json\n"
            "def render(d):\n"
            "    return json.dumps(d)\n")},
    "FL140": {"core/fsm.py": _base(_SHED)},
    "FL141": {"core/fsm.py": _base(_FOLD)},
    "FL142": {"core/fsm.py": _base(
        "    def _on_sync(self, msg):\n"
        "        self.send_message(Message(MSG_REPORT, 1, 0))\n",
        "    def _on_sync(self, msg):\n"
        "        logging.debug('sync seen (round %s)',\n"
        "                      msg.get('round'))\n"
        "    def late_report(self):\n"
        "        self.send_message(Message(MSG_REPORT, 1, 0))\n")},
    "FL143": {"core/fsm.py": _base(
        "from fedml_tpu_torch.core.comm.base import MSG_TYPE_PEER_LOST\n",
        "from fedml_tpu_torch.core.comm.base import (MSG_TYPE_PEER_JOIN,\n"
        "                                            MSG_TYPE_PEER_LOST)\n")},
    "FL152": {
        "core/mpc_reveal.py": (
            "def reveal(partials, p, scale):\n"
            "    return reconstruct_additive(\n"
            "        [dequantize(s, scale, p) for s in partials], p)\n"),
        "core/mpc_ok.py": (
            "def reveal(partials, p, scale):\n"
            "    total_q = reconstruct_additive(partials, p)\n"
            "    return dequantize(total_q, scale, p)\n")},
    "FL153": {
        "core/dp_client.py": (
            "from fedml_tpu_torch.core.managers import ClientManager\n"
            "from fedml_tpu_torch.core.message import Message\n"
            "class Cli(ClientManager):\n"
            "    def __init__(self, comm, dp=None):\n"
            "        self.dp = dp\n"
            "    def _on_sync(self, msg):\n"
            "        out = Message('report', 1, 0)\n"
            "        out.add('params', self.train(msg))\n"
            "        self.send_message(out)\n")},
}


def pass_findings(lint, tree):
    return [(f.path, f.line, f.col, f.code)
            for f in lint([tree], select=PASSES)]


@pytest.mark.parametrize("code", sorted(TREES))
def test_both_analyzers_agree_on_a_tree_that_trips(code, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    for rel, src in TREES[code].items():
        path = tmp_path / "pkg" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    port = pass_findings(lint_paths, "pkg")
    assert port == pass_findings(ref_lint_paths, "pkg")
    assert code in {c for *_, c in port}, port
    assert {p for p, *_ in port} == {"pkg/" + next(iter(TREES[code]))}


def test_the_healthy_protocol_is_clean_under_both(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "pkg" / "core").mkdir(parents=True)
    (tmp_path / "pkg" / "core" / "fsm.py").write_text(_BASE)
    assert pass_findings(lint_paths, "pkg") == []
    assert pass_findings(ref_lint_paths, "pkg") == []


def test_the_trees_cover_every_neutral_rule():
    assert set(TREES) == NEUTRAL
    assert len(PASSES) == 19
