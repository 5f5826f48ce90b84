"""The port's massive-connection control plane (``fedml_tpu_torch/net``:
the selector event-loop transport with its decode stage, the fan-in
tier, the soak harness) against the reference.

Three kinds of test:

- the reference's own scenarios (``tests/test_net.py``) retargeted at the
  port: star protocol, backpressure shedding, transport equivalence, the
  decode stage, batched dispatch, the two-tier fan-in fold, the soak
  smoke with its ``status.json``, registry quantiles, rejoin-storm rate
  limiting and the compressed soak;
- the port and the reference on the same inputs over the event loop:
  whole sync and async runs, and fan-in runs plain, with edges of edges
  and with a compressed upstream, ``history``, logs and counters equal
  bit for bit; a tiny fp32 TransformerLM trained over the event loop by
  each package's own client update (parameters within ``LM_TCP_TOL``);
- the port alone: the reference's chaos scenario over the event loop
  without its race audit (the reference's, with it, runs above through
  the port), and every process the soak
  spawns is a process of this package.

Every socket test bounds itself through the drivers' ``timeout`` and
``join_timeout``."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import tempfile

import numpy as np
import pytest
import torch

from reference_scenarios import retarget
from test_torch_control_plane import (LM_CLIENTS, LM_TCP_TOL, PORT, REF, T,
                                      V, W0, _assert_same_run, _flat,
                                      _hetero_trainer, _jax_trainer,
                                      _port_trainer, _shards)

from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.net import soak as tsoak
from fedml_tpu_torch.utils.torch_import import lm_state_to_variables

_net = retarget("test_net.py")

# -- the reference's scenarios, through the port -----------------------------
TestEventLoopTransport = _net.TestEventLoopTransport
TestBackpressure = _net.TestBackpressure
TestFanIn = _net.TestFanIn
TestRegistryQuantile = _net.TestRegistryQuantile
TestRejoinRateLimit = _net.TestRejoinRateLimit
TestCompressedSoak = _net.TestCompressedSoak


TestTransportEquivalence = _net.TestTransportEquivalence


class TestSoak(_net.TestSoak):
    # the 10k-connection headline soak is the slow tier's
    test_soak_10k = None


def test_the_retargeted_scenarios_run_the_port():
    assert _net.EventLoopCommManager.__module__ == \
        "fedml_tpu_torch.net.eventloop"
    assert _net.Message.__module__ == "fedml_tpu_torch.core.message"


# -- the port and the reference on the same inputs ---------------------------
def _evl(pkg, driver, *args, **kw):
    return getattr(pkg.res, driver)(*args, transport="eventloop",
                                    timeout=30.0, join_timeout=60.0, **kw)


@pytest.mark.parametrize("compressor", [None, "qsgd"])
def test_sync_eventloop_runs_equal_the_reference(compressor):
    runs = [_evl(pkg, "run_tcp_fedavg", 4, 3, pkg.res.RoundPolicy(),
                 dict(W0), trainer=_hetero_trainer(), compressor=compressor,
                 decode_workers=2)
            for pkg in (PORT, REF)]
    _assert_same_run(*runs, counters=("rounds_degraded", "rounds_abandoned",
                                      "clients_dropped", "clients_rejoined",
                                      "reports"))
    assert runs[0].reporting_log == [[1, 2, 3]] * 3
    assert (runs[0].com_manager.bytes_received
            == runs[1].com_manager.bytes_received)


@pytest.mark.parametrize("compressor", [None, "topk:0.25"])
def test_async_eventloop_runs_equal_the_reference(compressor):
    runs = [_evl(pkg, "run_async_tcp_fedavg", 4, 3,
                 pkg.res.AsyncAggPolicy(buffer_k=3, staleness_decay=0.5),
                 dict(W0), trainer=_hetero_trainer(), compressor=compressor)
            for pkg in (PORT, REF)]
    _assert_same_run(*runs, counters=("reports", "late_reports",
                                      "stale_base_reports"))
    assert runs[0].flush_log == [(1, 2, 3)] * 3
    assert runs[0].com_manager.ingest_stats()["frames"] >= 9


def _fanin(pkg_name, **kw):
    import importlib
    fanin = importlib.import_module(f"{pkg_name}.net.fanin")
    agg = importlib.import_module(f"{pkg_name}.resilience.async_agg")
    w0 = {"w": np.arange(8, dtype=np.float32).reshape(2, 4),
          "b": np.zeros(4, np.float32)}
    return fanin.run_fanin_fedavg(
        2, 2, 2, agg.AsyncAggPolicy(buffer_k=10 ** 9, staleness_decay=0.0),
        w0, transport="eventloop", timeout=30.0, join_timeout=90.0, **kw)


@pytest.mark.parametrize("kw", [{}, {"sub_edges": 2},
                                {"compressor": "qsgd"}],
                         ids=["plain", "sub_edges", "qsgd"])
def test_fanin_runs_equal_the_reference(kw):
    (got, got_edges), (want, want_edges) = (_fanin("fedml_tpu_torch", **kw),
                                            _fanin("fedml_tpu", **kw))
    _assert_same_run(got, want, counters=("reports", "stale_base_reports"))
    assert sorted(e.rounds_forwarded for e in got_edges) == sorted(
        e.rounds_forwarded for e in want_edges)
    assert len(got_edges) == len(want_edges) == 2 + 4 * bool(
        kw.get("sub_edges"))


def test_the_swarm_step_equals_the_reference():
    from fedml_tpu.net.soak import _quadratic_step as ref_step
    params = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
              "b": np.ones(4, np.float32)}
    for gid in (1, 7, 4096):
        got, want = tsoak._quadratic_step(params, gid), ref_step(params, gid)
        assert got[1] == want[1]
        for k in params:
            np.testing.assert_array_equal(got[0][k], want[0][k])


# -- a tiny TransformerLM over the event loop ---------------------------------
def test_tiny_lm_over_the_event_loop_agrees_with_the_reference():
    """The port's initial weights carried to the reference's layout (the
    port initialises in milliseconds, the Flax init takes seconds)."""
    shards = _shards()
    _spec, jtrain = _jax_trainer(shards)
    model = TransformerLM(V, n_layers=2, n_heads=2, d_model=32, max_len=T)
    state = make_seq_classification_spec(model).init_fn(0, "cpu")
    init = lm_state_to_variables(state)
    ref = REF.res.run_tcp_fedavg(
        LM_CLIENTS + 1, 2, REF.res.RoundPolicy(), _flat(init),
        trainer=jtrain, transport="eventloop", timeout=60.0,
        join_timeout=120.0)
    port_init = {k: v.detach().numpy() for k, v in state["params"].items()}
    got = PORT.res.run_tcp_fedavg(
        LM_CLIENTS + 1, 2, PORT.res.RoundPolicy(), port_init,
        trainer=_port_trainer(shards), transport="eventloop",
        decode_workers=2, timeout=60.0, join_timeout=120.0)
    assert ref.failed is None and got.failed is None
    assert got.reporting_log == ref.reporting_log == [[1, 2, 3]] * 2
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


# -- the port alone -----------------------------------------------------------
def test_chaos_over_the_event_loop_stitches_and_dumps():
    """The reference's event-loop chaos scenario (a kill and a 3 s stall
    under a 1 s deadline) without its race audit: the run completes
    degraded, client ``local-train`` spans stitch under the server's
    round spans through the event loop's envelope, the kill dumps the
    flight recorder once with the event loop's peer-lost and send
    events, and the registry holds its wire series."""
    from fedml_tpu_torch.observability import enable
    res = PORT.res
    plan = res.FaultPlan(seed=7, rules=(
        res.FaultRule("kill", rank=3, msg_type="res_report", nth=2),
        res.FaultRule("stall", rank=2, msg_type="res_report", nth=1,
                      delay_s=3.0)))
    d = tempfile.mkdtemp(prefix="evl_chaos_")
    with enable(trace=True, trace_dir=d, flightrec=True, flightrec_dir=d,
                compile_events=False) as obs:
        srv = res.run_tcp_fedavg(
            4, 3, res.RoundPolicy(deadline_s=1.0, quorum=0.3),
            {"w": np.zeros((4, 4), np.float32)}, fault_plan=plan,
            join_timeout=90, transport="eventloop")
        spans = obs.tracer.finished_spans()
    assert srv.failed is None and len(srv.history) == 3
    assert srv.counters["rounds_degraded"] >= 1
    rounds = {s.span_id: s for s in spans if s.name == "round"}
    lts = [s for s in spans if s.name == "local-train"]
    assert lts and all(
        s.parent_id in rounds
        and s.trace_id == rounds[s.parent_id].trace_id for s in lts)
    kill_dumps = []
    for p in obs.recorder.dumps:
        events = [json.loads(line) for line in open(p)]
        info = [e for e in events if e["kind"] == "dump_info"]
        if info and info[-1].get("peer") == 3:
            kill_dumps.append(events)
    assert len(kill_dumps) == 1
    assert any(e["kind"] == "peer_lost" and e.get("peer") == 3
               and e.get("transport") == "eventloop" for e in kill_dumps[0])
    assert any(e["kind"] == "send" and e.get("transport") == "eventloop"
               for e in kill_dumps[0])
    for direction in ("sent", "received"):
        assert obs.registry.get("comm_bytes_total", transport="eventloop",
                                direction=direction) > 0


def test_run_soak_spawns_the_ports_swarm(monkeypatch):
    """The soak's child is ``python -m fedml_tpu_torch.net.soak``, never
    a module of the JAX package."""
    seen = []

    class Spawned(Exception):
        pass

    def fake_popen(cmd, **kw):
        seen.append(list(cmd))
        raise Spawned

    monkeypatch.setattr(tsoak.subprocess, "Popen", fake_popen)
    with pytest.raises(Spawned):
        tsoak.run_soak(3, compressor="qsgd", trace_path="t.json")
    (cmd,) = seen
    mods = [cmd[i + 1] for i, a in enumerate(cmd) if a == "-m"]
    assert mods == ["fedml_tpu_torch.net.soak"]
    assert not any("fedml_tpu." in a for a in cmd)
    assert tsoak._main.__module__ == "fedml_tpu_torch.net.soak"


def test_swarm_cli_refuses_without_the_swarm_role():
    with pytest.raises(SystemExit):
        tsoak._main(["--port", "1", "--clients", "1", "--world", "2"])
