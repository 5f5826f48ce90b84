"""The port's distributed control plane (``fedml_tpu_torch/resilience``:
faults, policy, recovery, the resilient and buffered-async TCP FedAvg
servers) against the reference.

Two kinds of test:

- the reference's own scenarios retargeted at the port
  (``tests/test_resilience.py``'s fault plans, faulty local transport,
  send retry, round controller, TCP chaos with its exact subset
  average, kill-and-resume recovery and compressed wire, and
  ``tests/test_async_agg.py``'s TCP server cases), asserts and inputs as
  the reference has them;
- the port and the reference on the same inputs, compared: fault
  decisions, controller outcomes, whole TCP runs (plain, killed ranks,
  compressed, resumed, buffered async, the card phase's fault-and-rejoin
  plan) with ``history``, ``reporting_log`` and counters equal bit for
  bit; a tiny fp32 TransformerLM trained over TCP by each package's own
  client update (parameters within ``LM_TCP_TOL``); a client's
  ``local-train`` span stitched under the server's round span.

No comparison depends on the wall clock: the runs whose outcome a
deadline decides keep every report well inside or well past it. Every
socket test bounds itself through the drivers' ``timeout`` and
``join_timeout``."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import functools
import importlib
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_scenarios import retarget

from fedml_tpu.algorithms.specs import (
    make_seq_classification_spec as jax_seq_spec)
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.ops.attention import mha as jax_mha
from fedml_tpu.parallel import packing as jpack
from fedml_tpu.parallel.engine import ClientUpdateConfig as JaxCfg
from fedml_tpu.parallel.engine import make_client_update as jax_update
from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
from fedml_tpu_torch.data.shakespeare import synthetic_shakespeare_clients
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.observability import flightrec, tracing
from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.parallel import packing as tpack
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                             make_client_update)
from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                lm_variables_to_state)

_res = retarget("test_resilience.py")
_async = retarget("test_async_agg.py")

# -- the reference's scenarios, through the port -----------------------------
TestFaultPlan = _res.TestFaultPlan
TestFaultyLocalTransport = _res.TestFaultyLocalTransport
TestSendWithRetry = _res.TestSendWithRetry
TestRoundController = _res.TestRoundController
TestAggregateReports = _res.TestAggregateReports
TestCompressedWire = _res.TestCompressedWire
TestAsyncServer = _async.TestAsyncServer


TestTcpChaos = _res.TestTcpChaos


class TestRecovery(_res.TestRecovery):
    # the simulated path's resume is test_torch_checkpoint.py's
    test_sim_path_resume_bitwise = None


def test_the_retargeted_scenarios_run_the_port():
    for mod in (_res, _async):
        for name in ("run_tcp_fedavg", "FaultPlan", "RoundController",
                     "RoundRecovery", "send_with_retry"):
            if hasattr(mod, name):
                assert getattr(mod, name).__module__.startswith(
                    "fedml_tpu_torch."), (mod, name)
    assert _async.run_async_tcp_fedavg.__module__ == \
        "fedml_tpu_torch.resilience.async_agg"


# -- the port and the reference on the same inputs ---------------------------
def _pkg(name):
    res = importlib.import_module(f"{name}.resilience")
    return types.SimpleNamespace(
        res=res, msg=importlib.import_module(f"{name}.core.message"),
        privacy=importlib.import_module(f"{name}.program.privacy"),
        local=importlib.import_module(f"{name}.core.comm.local"),
        base=importlib.import_module(f"{name}.core.comm.base"))


PORT, REF = _pkg("fedml_tpu_torch"), _pkg("fedml_tpu")
W0 = {"w": np.zeros((4, 4), np.float32), "b": np.ones(4, np.float32)}


def _hetero_trainer(lr=0.2):
    """Per-element targets: compression errors that error feedback has
    to carry (the reference's compressed-wire trainer)."""
    def train(params, round_idx, rank):
        out = {}
        for k in sorted(params):
            w = np.asarray(params[k], np.float32)
            tgt = ((np.arange(w.size, dtype=np.float32).reshape(w.shape)
                    % 5 - 2) * np.float32(0.5 + 0.1 * rank))
            out[k] = w + np.float32(lr) * (tgt - w)
        return out, float(10 * rank)
    return train


def _assert_same_run(got, want, counters=("rounds_degraded",
                                          "rounds_abandoned",
                                          "clients_dropped",
                                          "clients_rejoined")):
    assert got.failed is None and want.failed is None
    assert len(got.history) == len(want.history) > 0
    for g, w in zip(got.history, want.history):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    for attr in ("reporting_log", "flush_log"):
        if hasattr(want, attr):
            assert getattr(got, attr) == getattr(want, attr)
    for c in counters:
        assert got.counters.get(c) == want.counters.get(c), c


def test_fault_decisions_equal_the_reference():
    rules = lambda m: (m.FaultRule("drop", p=0.3),
                       m.FaultRule("duplicate", msg_type="b", p=0.2),
                       m.FaultRule("delay", rank=2, nth=3, delay_s=0.1),
                       m.FaultRule("kill", rank=4, msg_type="a", nth=5))
    types_ = ["a", "b", "b", "a", "c"] * 8
    for rank in range(6):
        got = PORT.res.FaultPlan(seed=11, rules=rules(PORT.res)).for_rank(
            rank)
        want = REF.res.FaultPlan(seed=11, rules=rules(REF.res)).for_rank(
            rank)
        for i, t in enumerate(types_):
            assert ([r.action for r in got.decide(i, t)]
                    == [r.action for r in want.decide(i, t)])
        assert got.decisions == want.decisions


def _faulty_local(pkg):
    """Eight sends of rank 1 over the faulty local transport under drop,
    duplicate, reorder and kill rules: what rank 0's mailbox holds."""
    net = pkg.local.LocalCommNetwork(2, serialize=True)
    plan = pkg.res.FaultPlan(seed=2, rules=(
        pkg.res.FaultRule("drop", msg_type="m", nth=2),
        pkg.res.FaultRule("duplicate", msg_type="m", nth=3),
        pkg.res.FaultRule("reorder", msg_type="m", nth=4),
        pkg.res.FaultRule("kill", msg_type="m", nth=7)))
    sender = plan.wrap(net.manager(1), 1)
    for i in range(8):
        m = pkg.msg.Message("m", 1, 0)
        m.add("i", i)
        sender.send_message(m)
    box, out = net.mailboxes[0], []
    while not box.empty():
        frame = box.get()
        out.append(bytes(frame))
    return out, sender.bytes_sent


def test_faulty_local_transport_equals_the_reference():
    got, want = _faulty_local(PORT), _faulty_local(REF)
    assert got == want  # the same frames, byte for byte, in one order
    assert len(got[0]) == 7  # 0, 2, 2, 4, 3, 5, then PEER_LOST


def _controller_outcomes(pkg):
    res = pkg.res
    done = []
    ctl = res.RoundController(
        res.RoundPolicy(deadline_s=0.0, quorum=0.5),
        lambda reps, out: done.append((out, sorted(reps))),
        lambda reps: done.append((res.ROUND_ABANDONED, sorted(reps))))
    ctl.begin(0, 0, [1, 2, 3, 4], target=3)
    ctl.report(0, 0, 2, 5, "p")
    ctl.report(0, 0, 2, 5, "dup")
    ctl.report(0, 1, 3, 5, "wrong attempt")
    ctl.report(0, 0, 1, 5, "p")
    ctl.report(0, 0, 4, 5, "p")       # completes at target 3
    ctl.report(0, 0, 3, 5, "late")
    ctl.begin(1, 0, [1, 2, 3], target=3)
    assert ctl.admit(1, 0, 5) and not ctl.admit(1, 0, 5)
    ctl.report(1, 0, 5, 5, "resumed")
    ctl.peer_lost(1)
    ctl.peer_lost(2)
    ctl.peer_lost(3)                  # all outstanding dead: decided
    ctl.begin(2, 0, [1, 2], target=2)
    ctl.peer_lost(1)
    ctl.peer_lost(2)                  # nobody reported: abandoned
    return done, dict(ctl.counters)


def test_round_controller_outcomes_equal_the_reference():
    got, want = _controller_outcomes(PORT), _controller_outcomes(REF)
    assert got == want
    assert [o for o, _ in got[0]] == ["complete", "abandoned", "abandoned"]


def _retry(pkg):
    class Flaky:
        rank = 0

        def __init__(self):
            self.calls, self._observers = [], []

        def send_message(self, msg, is_resend=False):
            self.calls.append(bool(is_resend))
            if len(self.calls) <= 3:
                raise ConnectionError("transient")

    comm, sleeps, counters = Flaky(), [], {}
    used = pkg.res.send_with_retry(
        comm, pkg.msg.Message("m", 0, 1),
        pkg.res.RetryPolicy(max_retries=5, base_delay=0.05, max_delay=0.15),
        counters=counters, sleep=sleeps.append)
    return used, sleeps, counters, comm.calls


def test_send_with_retry_equals_the_reference():
    assert _retry(PORT) == _retry(REF)


KILL = lambda m: m.FaultPlan(seed=7, rules=(
    m.FaultRule("kill", rank=3, msg_type="res_report", nth=2),))

#: (label, run_tcp_fedavg keyword arguments for a package)
TCP_RUNS = [
    ("plain", lambda p: dict(round_policy=p.res.RoundPolicy())),
    ("cohort_target", lambda p: dict(
        round_policy=p.res.RoundPolicy(), cohort_target=2,
        cohort_override=lambda r, a: [[1, 3], [2, 3], [1, 2]][r])),
    # rank 3 dies before its round-1 report: degraded rounds over the
    # survivors, whether the peer-lost or the 2 s deadline decides
    ("killed", lambda p: dict(
        round_policy=p.res.RoundPolicy(deadline_s=2.0, quorum=0.3),
        fault_plan=KILL(p.res))),
    ("killed_compressed", lambda p: dict(
        round_policy=p.res.RoundPolicy(deadline_s=2.0, quorum=0.3),
        fault_plan=KILL(p.res), compressor="qsgd",
        trainer=_hetero_trainer())),
    ("qsgd", lambda p: dict(round_policy=p.res.RoundPolicy(),
                            compressor="qsgd", trainer=_hetero_trainer())),
    ("topk", lambda p: dict(round_policy=p.res.RoundPolicy(),
                            compressor="topk:0.25",
                            trainer=_hetero_trainer())),
    ("signsgd", lambda p: dict(round_policy=p.res.RoundPolicy(),
                               compressor="signsgd",
                               trainer=_hetero_trainer())),
    # the client-side DP leg (clip, then seeded noise on the delta) and
    # the server's robust folds ride the report unchanged
    ("dp", lambda p: dict(
        round_policy=p.res.RoundPolicy(), trainer=_hetero_trainer(),
        dp=p.privacy.DPPolicy(clip_norm=0.5, noise_multiplier=1.1))),
    ("dp_topk", lambda p: dict(
        round_policy=p.res.RoundPolicy(), trainer=_hetero_trainer(),
        compressor="topk:0.25", dp=p.privacy.DPPolicy(clip_norm=0.5))),
    ("robust_norm_clip", lambda p: dict(
        round_policy=p.res.RoundPolicy(), trainer=_hetero_trainer(),
        robust=p.privacy.RobustPolicy(mode="norm_clip", clip_bound=1.0))),
    # pace steering with the perf monitor off: decisions
    # from the outcomes alone, the deadline steered within its bounds
    ("pace", lambda p: dict(
        round_policy=p.res.RoundPolicy(deadline_s=2.0, quorum=0.34),
        pace_controller=p.res.PaceController(
            p.res.PaceBounds(deadline_s=(0.25, 6.0)), seed=0,
            deadline_s=2.0))),
    ("robust_trimmed_mean", lambda p: dict(
        round_policy=p.res.RoundPolicy(), trainer=_hetero_trainer(),
        robust=p.privacy.RobustPolicy(mode="trimmed_mean",
                                      trim_ratio=0.34))),
]


@pytest.mark.parametrize("label,kwargs", TCP_RUNS, ids=[r[0] for r in
                                                        TCP_RUNS])
def test_tcp_runs_equal_the_reference(label, kwargs):
    runs = []
    for pkg in (PORT, REF):
        kw = kwargs(pkg)
        runs.append(pkg.res.run_tcp_fedavg(
            4, 3, kw.pop("round_policy"), dict(W0), timeout=30.0,
            join_timeout=60.0, **kw))
    _assert_same_run(*runs)
    if label == "pace":
        got, want = (r.pace.decisions for r in runs)
        assert len(got) == len(want) == 2
        assert [vars(d) for d in got] == [vars(d) for d in want]
        assert runs[0].round_policy == runs[0]._controller.policy
    if label.startswith("killed"):
        assert runs[0].counters["clients_dropped"] == 1
        assert runs[0].reporting_log[1:] == [[1, 2], [1, 2]]


def test_resumed_server_equals_the_reference_uninterrupted(tmp_path):
    """The port's server killed after round 2 and restarted on its
    checkpoints ends bit-equal to the reference's uninterrupted run."""
    pol = lambda m: m.RoundPolicy(deadline_s=30.0, quorum=0.4)
    want = REF.res.run_tcp_fedavg(4, 4, pol(REF.res), dict(W0),
                                  trainer=_hetero_trainer(),
                                  join_timeout=60.0)
    d = str(tmp_path / "rec")
    first = PORT.res.run_tcp_fedavg(4, 2, pol(PORT.res), dict(W0),
                                    trainer=_hetero_trainer(),
                                    recovery=PORT.res.RoundRecovery(d),
                                    join_timeout=60.0)
    rec = PORT.res.RoundRecovery(d)
    assert rec.latest_round() == 2
    got = PORT.res.run_tcp_fedavg(4, 4, pol(PORT.res), dict(W0),
                                  trainer=_hetero_trainer(), recovery=rec,
                                  join_timeout=60.0)
    assert got.counters["resumes"] == 1 and rec.resumes == 1
    for g, w in zip(first.history + got.history, want.history):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("compressor", [None, "topk:0.25"])
def test_async_runs_equal_the_reference(compressor):
    """Buffered async over TCP: every flush (K 3 of 3 clients, decay 0.5)
    equal to the reference's, compressed reports folded against their
    base version."""
    runs = []
    for pkg in (PORT, REF):
        runs.append(pkg.res.run_async_tcp_fedavg(
            4, 3, pkg.res.AsyncAggPolicy(buffer_k=3, staleness_decay=0.5),
            dict(W0), trainer=_hetero_trainer(), compressor=compressor,
            timeout=30.0, join_timeout=60.0))
    _assert_same_run(*runs, counters=("reports", "late_reports",
                                      "stale_base_reports"))
    assert runs[0].flush_log == [(1, 2, 3)] * 3


def _rejoin_plan_run(pkg):
    """The card phase's fault plan on the CPU: rank 2 killed at its
    round-0 report and re-dialed 2 s into the run, while rank 4's round-0
    report stalls 3 s -- so rank 2 is never round 0's last report and
    round 0 waits for its 6 s deadline, closing degraded over ranks 1, 3
    and 4 after the rejoin; round 1's cohort has rank 2 back."""
    res = pkg.res
    plan = res.FaultPlan(seed=0, rules=(
        res.FaultRule("kill", rank=2, msg_type="res_report", nth=1),
        res.FaultRule("stall", rank=4, msg_type="res_report", nth=1,
                      delay_s=3.0)))
    return res.run_tcp_fedavg(
        5, 2, res.RoundPolicy(deadline_s=6.0, quorum=0.5), dict(W0),
        fault_plan=plan, late_clients=[(2, 2.0)], compressor="topk:0.25",
        trainer=_hetero_trainer(), timeout=30.0, join_timeout=60.0)


def test_fault_and_rejoin_plan_equals_the_reference():
    got, want = _rejoin_plan_run(PORT), _rejoin_plan_run(REF)
    _assert_same_run(got, want, counters=(
        "rounds_degraded", "rounds_abandoned", "clients_dropped",
        "clients_rejoined", "clients_resumed"))
    assert got.reporting_log == [[1, 3, 4], [1, 2, 3, 4]]
    assert (got.counters["rounds_degraded"], got.counters["clients_dropped"],
            got.counters["clients_rejoined"]) == (1, 1, 1)


@pytest.mark.parametrize("driver", ["run_tcp_fedavg", "run_async_tcp_fedavg"])
def test_eventloop_transport_equals_tcp(driver):
    """Both drivers over the selector event loop (with its parallel
    decode stage) and over the threaded hub: the same run, bit for bit."""
    policy = (PORT.res.RoundPolicy() if driver == "run_tcp_fedavg"
              else PORT.res.AsyncAggPolicy(buffer_k=2))
    got, want = (getattr(PORT.res, driver)(
        3, 2, policy, dict(W0), trainer=_hetero_trainer(),
        transport=transport, decode_workers=2, join_timeout=60.0)
        for transport in ("eventloop", "tcp"))
    _assert_same_run(got, want)
    assert type(got.com_manager).__name__ == "EventLoopCommManager"
    assert got.com_manager.ingest_stats()["workers"] == 2


# -- tracing across ranks ----------------------------------------------------
def test_client_spans_stitch_under_the_server_round(tmp_path):
    """A killed rank and a 1 s deadline, as the reference's cross-rank
    tracing scenario: every client ``local-train`` span hangs under a
    server ``round`` span of the same trace, every ``report-recv`` under
    the client's ``report`` span, and the killed peer's loss dumps the
    flight recorder."""
    tracer = tracing.Tracer()
    recorder = flightrec.FlightRecorder(str(tmp_path))
    prev_t = tracing.set_tracer(tracer)
    prev_r = flightrec.set_flight_recorder(recorder)
    try:
        srv = PORT.res.run_tcp_fedavg(
            4, 3, PORT.res.RoundPolicy(deadline_s=1.0, quorum=0.3),
            dict(W0), fault_plan=KILL(PORT.res), join_timeout=60.0)
    finally:
        tracing.set_tracer(prev_t)
        flightrec.set_flight_recorder(prev_r)
    assert srv.failed is None and len(srv.history) == 3
    spans = tracer.finished_spans()
    rounds = {s.span_id: s for s in spans if s.name == "round"}
    assert len(rounds) == 3
    assert all(s.parent_id is None for s in rounds.values())
    local = [s for s in spans if s.name == "local-train"]
    assert len(local) >= 8
    for s in local:
        assert s.parent_id in rounds
        assert s.trace_id == rounds[s.parent_id].trace_id
    by_id = {s.span_id: s for s in spans}
    recvs = [s for s in spans if s.name == "report-recv"]
    assert recvs and all(by_id[s.parent_id].name == "report" for s in recvs)
    assert any("peer_lost" in p for p in recorder.dumps)


# -- the attention launch counters under threads ------------------------------
def test_launch_counts_are_exact_under_threads():
    """More counting threads than cores, switching every microsecond: an
    unguarded ``+=`` loses increments here."""
    import os
    import sys

    before = dict(fa.launches)
    n_threads = 2 * (os.cpu_count() or 4)

    def hammer():
        for _ in range(2000):
            for name in ("fwd", "dq", "dkv"):
                fa._count(name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
        counted = {k: fa.launches[k] - before[k] for k in before}
        fa.launches.update(before)
    assert not any(t.is_alive() for t in threads)
    assert counted == {k: 2000 * n_threads for k in before}


# -- a tiny TransformerLM trained over TCP by each package --------------------
T, V, LM_LR, LM_ROUNDS, LM_CLIENTS = 16, 90, 0.1, 2, 3
#: fp32 on both sides; SGD sums in another order differ in the last bits
LM_TCP_TOL = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(tree[k])
    return out


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _shards():
    data = synthetic_shakespeare_clients(LM_CLIENTS, T, V, seed=3)[5]
    return {r: {"x": data[r - 1]["x"][:6], "y": data[r - 1]["y"][:6]}
            for r in range(1, LM_CLIENTS + 1)}


def _batches(pack, shard, round_idx, rank):
    return pack.pack_cohort([shard], 4, 1, step_bucket=1, native=False,
                            rng=np.random.default_rng((round_idx, rank)))


def _jax_trainer(shards):
    model = JaxLM(vocab_size=V, n_layers=2, n_heads=2, d_model=32,
                  max_len=T, dtype=jnp.float32,
                  attention_fn=functools.partial(jax_mha, causal=True))
    spec = jax_seq_spec(model, jnp.zeros((1, T), jnp.int32), name="lm")
    update = jax.jit(jax_update(spec, JaxCfg(optimizer="sgd", lr=LM_LR)))
    lock = threading.Lock()

    def train(params, round_idx, rank):
        data = _batches(jpack, shards[rank], round_idx, rank)
        data = {k: jnp.asarray(v[0]) for k, v in data.items()}
        with lock:  # one jit trace, shared
            local, aux, _ = update(_unflat(params), data,
                                   jax.random.PRNGKey(rank))
        return _flat(jax.tree.map(np.asarray, local)), float(aux["n"])

    return spec, train


def _port_trainer(shards):
    model = TransformerLM(V, n_layers=2, n_heads=2, d_model=32, max_len=T)
    update = make_client_update(make_seq_classification_spec(model),
                                ClientUpdateConfig(optimizer="sgd",
                                                   lr=LM_LR))

    def train(params, round_idx, rank):
        data = _batches(tpack, shards[rank], round_idx, rank)
        data = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
        data["y"] = data["y"].long()
        state = {"params": {k: torch.from_numpy(np.array(v))
                            for k, v in params.items()}}
        local, aux, _ = update(state, data, np.array([rank]))
        return ({k: v[0].detach().numpy()
                 for k, v in local["params"].items()},
                float(aux["n"][0]))

    return train


@pytest.fixture(scope="module")
def lm_runs():
    shards = _shards()
    spec, jtrain = _jax_trainer(shards)
    init = jax.tree.map(np.asarray, spec.init_fn(jax.random.PRNGKey(0)))
    ref = REF.res.run_tcp_fedavg(
        LM_CLIENTS + 1, LM_ROUNDS, REF.res.RoundPolicy(), _flat(init),
        trainer=jtrain, timeout=60.0, join_timeout=120.0)
    port_init = {k: v.numpy() for k, v in
                 lm_variables_to_state(init)["params"].items()}
    got = PORT.res.run_tcp_fedavg(
        LM_CLIENTS + 1, LM_ROUNDS, PORT.res.RoundPolicy(), port_init,
        trainer=_port_trainer(shards), timeout=60.0, join_timeout=120.0)
    return init, ref, got


def test_tiny_lm_over_tcp_agrees_with_the_reference(lm_runs):
    init, ref, got = lm_runs
    assert ref.failed is None and got.failed is None
    assert got.reporting_log == ref.reporting_log == [[1, 2, 3]] * LM_ROUNDS
    moved = 0.0
    for g, w in zip(got.history, ref.history):
        carried = _flat(lm_state_to_variables(
            {"params": {k: torch.from_numpy(v) for k, v in g.items()}}))
        assert carried.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(carried[k], w[k], rtol=0,
                                       atol=LM_TCP_TOL, err_msg=k)
    flat0 = _flat(init)
    moved = max(float(np.abs(ref.history[-1][k] - flat0[k]).max())
                for k in flat0)
    assert moved > 100 * LM_TCP_TOL  # the clients trained
