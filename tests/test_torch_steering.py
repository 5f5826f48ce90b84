"""Pace steering, the metrics registry and the diurnal load traces in
the port against the JAX package: one observation stream (a
``MetricsRegistry`` filled with the same histograms, and one sequence of
round outcomes) through both packages' ``PaceController`` gives the same
``PaceDecision`` sequence bit for bit, including the hold on an empty
window, the abandon back-off and the clamps to the bounds; both
registries end equal. ``DiurnalTrace`` and ``TraceLoadGen`` decide alike
on a grid. ``FedAvgAPI`` under ``--pace_steering`` (LR, 12 clients, 6 a
round, over-selection 0.3, straggler rate 0.25, quorum 0.34) carries the
reference's ``res/*`` and ``pace/*`` records exactly over 5 rounds from
the reference's initial weights, with the parameters within 1e-4; and
the reference's behaviour tests of the steered simulation hold on the
port."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.data import load_synthetic_federated
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.observability import registry as jregistry
from fedml_tpu.resilience import faults as jfaults
from fedml_tpu.resilience import steering as jsteering
from fedml_tpu_torch import bench as tbench
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.observability import registry
from fedml_tpu_torch.resilience import faults, steering
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _numpy_packing():
    """Both packages pack schedules with numpy, byte-equal."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    yield
    mp.undo()


def _decision(d):
    return (d.index, d.buffer_k, d.flush_deadline_s, d.deadline_s,
            d.overselect, d.reason, d.inputs)


def _stream(n=40, seed=7):
    """One observation script: latency observations to histogram before
    each decision (an empty window now and then) and the decide()
    arguments, covering every rule of the law."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lat = ([] if i % 7 in (0, 3)
               else list(np.round(rng.lognormal(-1.0, 1.2,
                                                rng.integers(1, 9)), 4)))
        outcome = ("complete", "degraded", "abandoned", None)[
            rng.integers(0, 4)]
        selected = int(rng.integers(0, 9)) if i % 5 else None
        reporting = (None if selected is None
                     else int(rng.integers(0, selected + 1)))
        rate = (None if i % 3 else float(np.round(rng.uniform(0, 80), 3)))
        out.append((lat, dict(outcome=outcome, selected=selected,
                              reporting=reporting, arrival_rate=rate,
                              flush_reason="deadline" if rate else None,
                              flush_clients=selected)))
    return out


def _drive(mod, regmod, bounds_kw, **ctl_kw):
    reg = regmod.MetricsRegistry()
    prev = regmod.set_registry(reg)
    try:
        ctl = mod.PaceController(mod.PaceBounds(**bounds_kw), **ctl_kw)
        decisions = [_decision(ctl.decide())]  # round 0: nothing observed
        for lat, kw in _stream():
            for v in lat:
                reg.observe("fed_report_latency_seconds", float(v))
                reg.observe("fed_staleness_levels", float(v) * 3,
                            buckets=(0, 1, 2, 4, 8))
            reg.set_gauge("fed_rounds_per_hour", 100.0 + len(lat))
            obs = ctl.observe_registry()
            decisions.append(_decision(ctl.decide(obs=obs, **kw)))
        return (decisions, ctl.status_fields(), ctl.record(),
                reg.collect(), reg.render_prometheus())
    finally:
        regmod.set_registry(prev)


@pytest.mark.parametrize("bounds_kw,ctl_kw", [
    ({}, {}),
    # tight bounds: every knob pinned against a clamp at some point
    ({"buffer_k": (4, 16), "flush_deadline_s": (0.2, 0.5),
      "deadline_s": (0.3, 2.0), "overselect": (0.05, 0.4)},
     {"buffer_k": 200, "deadline_s": 9.0, "overselect": 0.9}),
    ({"deadline_s": (0.05, 4.0)},
     {"abandon_backoff": 5.0, "step_up": 1.5, "step_down": 2.0,
      "overselect_max_delta": 0.1, "latency_margin": 2.0}),
])
def test_pace_decisions_equal_the_reference_bitwise(bounds_kw, ctl_kw):
    got = _drive(steering, registry, bounds_kw, **ctl_kw)
    want = _drive(jsteering, jregistry, bounds_kw, **ctl_kw)
    assert got == want
    decisions = got[0]
    reasons = {r for d in decisions for r in d[5].split(",")}
    assert decisions[0][5] == "hold"
    assert {"hold", "abandon-backoff", "track-tail", "track-loss",
            "track-arrival"} <= reasons
    lo, hi = steering.PaceBounds(**bounds_kw).deadline_s
    assert all(lo <= d[3] <= hi for d in decisions)


def test_pace_controller_from_args_matches_the_reference():
    ns = types.SimpleNamespace(
        pace_steering=1, pace_k_bounds="2,64", pace_flush_bounds="0.1,9",
        pace_deadline_bounds="0.5,30", pace_overselect_bounds="0,0.6",
        seed=3, buffer_k=100, flush_deadline=0.0, deadline=12.0,
        overselect=0.3)
    got = steering.PaceController.from_args(ns)
    want = jsteering.PaceController.from_args(ns)
    assert got.bounds.__dict__ == want.bounds.__dict__
    assert got.status_fields() == want.status_fields()
    assert got.record() == want.record() == {"pace/decision": -1}
    ns.pace_steering = 0
    assert steering.PaceController.from_args(ns) is None
    with pytest.raises(ValueError, match="min exceeds max"):
        steering.PaceController.from_args(types.SimpleNamespace(
            pace_steering=1, pace_overselect_bounds="0.5,0.1"))


def test_registry_matches_the_reference():
    got, want = registry.MetricsRegistry(), jregistry.MetricsRegistry()
    for reg in (got, want):
        reg.inc("fed_bytes_total", 3, direction="up")
        reg.inc("fed_bytes_total", 4, direction="up")
        reg.set_gauge("fed_pace_overselect", 0.25)
        for v in (0.003, 0.2, 7.0, 100.0):
            reg.observe("fed_report_latency_seconds", v)
        reg.declare_histogram("fed_buffer_depth_levels", buckets=(1, 2))
    assert got.collect() == want.collect()
    for q in (0.0, 0.5, 0.9, 1.0):
        assert (got.histogram_quantile("fed_report_latency_seconds", q)
                == want.histogram_quantile("fed_report_latency_seconds", q))
    assert (got.histogram_buckets("fed_report_latency_seconds")
            == want.histogram_buckets("fed_report_latency_seconds"))
    rec_g, rec_w = got.snapshot_into({}), want.snapshot_into({})
    assert rec_g.keys() == rec_w.keys()
    assert got.snapshot_into({}) == want.snapshot_into({}) == {}
    for reg in (got, want):
        reg.set_gauge("weird", float("nan"), label='a"b\nc')
        reg.set_gauge("fed_flag", True)
    assert got.render_prometheus() == want.render_prometheus()
    with pytest.raises(ValueError):
        got.inc("bad name")
    with pytest.raises(ValueError):
        got.inc("fed_bytes_total", -1)
    assert registry.get_registry() is None  # off unless set


def _trace_pair(mod, **kw):
    return mod.DiurnalTrace([
        mod.LoadPhase(dur_s=0.5, delay_s=0.02, jitter=0.5, name="day"),
        mod.LoadPhase(dur_s=1.0, delay_s=0.3, jitter=0.3, dropout_p=0.5,
                      name="night")], repeat=True, seed=3, **kw)


def test_diurnal_trace_matches_the_reference(tmp_path):
    for args in ((), (2.0, 0.3, 5)):
        got = faults.DiurnalTrace.example(*args)
        want = jfaults.DiurnalTrace.example(*args)
        assert got.to_dict() == want.to_dict()
        assert got.total_s == want.total_s
        for t in np.linspace(-1.0, 3 * got.total_s, 97):
            g, w = got.locate(t), want.locate(t)
            assert g[:2] == w[:2] and g[2].name == w[2].name
    once = faults.DiurnalTrace.example(seed=1).to_dict()
    once["repeat"] = False
    got = faults.DiurnalTrace.from_dict(once)
    want = jfaults.DiurnalTrace.from_dict(once)
    assert got.to_dict() == want.to_dict() == once
    for t in (0.0, 6.5, 21.7, 100.0):
        assert got.locate(t)[:2] == want.locate(t)[:2]
    path = got.to_file(str(tmp_path / "trace.json"))
    assert (faults.DiurnalTrace.from_file(path).to_dict()
            == jfaults.DiurnalTrace.from_file(path).to_dict())
    with pytest.raises(ValueError):
        faults.LoadPhase(dur_s=0.0)
    with pytest.raises(ValueError):
        faults.LoadPhase(dur_s=1.0, dropout_p=1.5)
    with pytest.raises(ValueError):
        faults.DiurnalTrace([])


@pytest.mark.parametrize("population", [None, range(8), range(1, 13)])
def test_trace_load_gen_matches_the_reference(population):
    got = faults.TraceLoadGen(_trace_pair(faults), seed=4,
                              population=population)
    want = jfaults.TraceLoadGen(_trace_pair(jfaults), seed=4,
                                population=population)
    miss_g, miss_w = got.sim_miss_fn(round_s=0.25), want.sim_miss_fn(0.25)
    grid = [[miss_g(r, a, c) for c in range(12)]
            for r in range(16) for a in (0, 1)]
    assert grid == [[miss_w(r, a, c) for c in range(12)]
                    for r in range(16) for a in (0, 1)]
    assert any(map(any, grid)) and not all(map(all, grid))
    for p in (0.0, 0.3, 0.5, 1.0):
        assert ([got.dark(c, i, r, p) for c in range(3) for i in range(2)
                 for r in range(12)]
                == [want.dark(c, i, r, p) for c in range(3)
                    for i in range(2) for r in range(12)])
    for t in (0.1, 0.7, 1.2, 2.9):
        for rank in range(4):
            g, w = got.decide(rank, 5, t), want.decide(rank, 5, t)
            assert g[0] == w[0] and g[1:-1] == w[1:-1]
    night = got.trace.phases[1]
    assert ([got.reply_delay(3, i, night) for i in range(6)]
            == [want.reply_delay(3, i, want.trace.phases[1])
                for i in range(6)])


class _Sink:
    """A transport that records what reaches it."""

    def __init__(self):
        self.sent = []

    def send_message(self, msg, **kw):
        self.sent.append((msg.get_type(), msg.get("i")))


def _shaped_sends(mod, message_cls):
    """Twelve sends (reports and syncs) of rank 3 through ``mod``'s trace
    shaper on a stepped clock, with the delayed ones delivered by a timer
    stand-in at once: ``(delivered, delays, dropped)``."""
    clock = iter(np.arange(0.0, 30.0, 0.45))
    gen = mod.TraceLoadGen(_trace_pair(mod), seed=4,
                           clock=lambda: next(clock))
    delays = []

    class Timer:
        def __init__(self, delay, fn, args):
            delays.append(round(delay, 12))
            self.fn, self.args = fn, args

        def start(self):
            self.fn(*self.args)

    sink = _Sink()
    shaper = mod.TraceShapedCommManager(sink, gen, 3, timer_factory=Timer)
    for i in range(12):
        m = message_cls("res_report" if i % 3 else "res_sync", 3, 0)
        m.add("i", i)
        shaper.send_message(m)
    return sink.sent, delays, shaper.dropped


def test_transport_shaping_waits_for_the_control_plane():
    """The send-side trace shaper the control plane (ROADMAP A13)
    brought: ``TraceLoadGen.wrap`` shapes a transport's reports with the
    reference's decisions -- the same sends delivered, delayed by the
    same seconds and dropped, syncs untouched."""
    from fedml_tpu.core.message import Message as JMessage
    from fedml_tpu_torch.core.message import Message

    gen = faults.TraceLoadGen(_trace_pair(faults))
    assert isinstance(gen.wrap(_Sink(), 1), faults.TraceShapedCommManager)
    got = _shaped_sends(faults, Message)
    want = _shaped_sends(jfaults, JMessage)
    assert got == want
    assert got[2] > 0 and got[1]


#: a fixed sweep entry's keys, by outcome
_RUN_KEYS = {"wall_s", "rounds_completed", "degraded", "abandoned",
             "config"}


def _run_keys(run):
    return set(run) - ({"rph", "quality_rel"} if "rph" in run
                       else {"failed"})


def test_bench_steering_record_and_pass_rule_equal_the_reference(capsys):
    """``--steering`` at a cut scale against the reference's
    ``run_steering_bench`` at the same arguments: the same record keys,
    the same seeded trace and sweep, and each record's ``pass`` is the
    reference's rule applied to that record (the timings, and so the
    verdicts, are the wall clock's and are not compared)."""
    from test_torch_bench import _last_json, _steering_pass

    argv = ["--steering", "--steering_rounds", "2", "--steering_scale",
            "0.05"]
    got = tbench.main(argv + ["--ledger", ""])
    assert _last_json(capsys) == got
    args = tbench._parser().parse_args(argv + ["--ledger", ""])
    rc = bench.run_steering_bench(args)
    want = _last_json(capsys)
    assert rc == (0 if want["pass"] else 1)
    assert sorted(got) == sorted(want)
    assert sorted(got["steered"]) == sorted(want["steered"])
    assert got["trace"] == want["trace"]
    assert [r["config"] for r in got["fixed_sweep"]] == \
        [r["config"] for r in want["fixed_sweep"]]
    for run in got["fixed_sweep"] + want["fixed_sweep"]:
        assert _run_keys(run) == _RUN_KEYS, run
    for record in (got, want):
        assert record["pass"] == _steering_pass(record)
        assert (record["speedup_threshold"], record["quality_tol"],
                record["rounds"]) == (1.10, 0.5, 2)


# -- the steered simulation (the reference's tests/test_steering.py) --------

def _sim_args(**kw):
    base = dict(client_num_in_total=12, client_num_per_round=6,
                comm_round=6, epochs=1, batch_size=16, lr=0.1, wd=0.0,
                client_optimizer="sgd", frequency_of_the_test=10 ** 9,
                seed=0, ci=0, overselect=0.3, straggler_p=0.25,
                quorum=0.34)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def sim_dataset():
    return load_synthetic_federated(client_num=12, n_train=240, n_test=48,
                                    feature_dim=8, class_num=4, seed=0)


@pytest.fixture(scope="module")
def jax_init(sim_dataset):
    spec = jax_spec(JaxLR(num_classes=4, apply_sigmoid=False),
                    jnp.zeros((1, 8)))
    api = JaxFedAvgAPI(sim_dataset, spec, _sim_args())
    return jax.tree.map(np.array, api.global_state), spec


def _run_port(dataset, init, args, rounds=5):
    spec = make_classification_spec(LogisticRegression(
        8, 4, apply_sigmoid=False))
    api = FedAvgAPI(dataset, spec, args, device="cpu")
    api.global_state = cv_variables_to_state(init)
    records = [api.train_one_round() for _ in range(rounds)]
    return cv_state_to_variables(api.global_state), records, api


def _run_jax(dataset, spec, args, rounds=5):
    api = JaxFedAvgAPI(dataset, spec, args)
    records = [api.train_one_round() for _ in range(rounds)]
    return jax.tree.map(np.array, api.global_state), records, api


def _res_pace(records):
    return [{k: v for k, v in r.items() if k.startswith(("res/", "pace/"))}
            for r in records]


@pytest.fixture(scope="module")
def steered(sim_dataset, jax_init):
    init, jspec = jax_init
    args = _sim_args(pace_steering=1)
    return (_run_port(sim_dataset, init, args),
            _run_jax(sim_dataset, jspec, args))


def test_steered_fedavg_matches_the_reference(steered):
    (state, records, api), (jstate, jrecords, japi) = steered
    assert _res_pace(records) == _res_pace(jrecords)
    assert records[0]["pace/decision"] == -1
    assert all("pace/overselect" in r for r in records[1:])
    assert ([_decision(d) for d in api.pace.decisions]
            == [_decision(d) for d in japi.pace.decisions])
    assert len(api.pace.decisions) == 4  # rounds 1..4 steer
    assert api.program.cohort.overselect == japi.program.cohort.overselect
    for r, jr in zip(records, jrecords):
        np.testing.assert_allclose(r["Train/Loss"], jr["Train/Loss"],
                                   atol=TOL)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate):
        got = dict(jax.tree_util.tree_leaves_with_path(state))[path]
        np.testing.assert_allclose(got, leaf, atol=TOL)


def test_steered_sim_is_bitwise_deterministic(sim_dataset, jax_init,
                                              steered):
    state, records, api = _run_port(sim_dataset, jax_init[0],
                                    _sim_args(pace_steering=1))
    (state0, records0, api0), _ = steered
    assert ([_decision(d) for d in api.pace.decisions]
            == [_decision(d) for d in api0.pace.decisions])
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state0)):
        assert (a == b).all()
    assert _res_pace(records) == _res_pace(records0)


def test_flag_off_is_bitwise_identical_to_no_flag(sim_dataset, jax_init):
    s_off, r_off, api_off = _run_port(sim_dataset, jax_init[0],
                                      _sim_args(pace_steering=0))
    ns = _sim_args()
    assert not hasattr(ns, "pace_steering")
    s_none, r_none, api_none = _run_port(sim_dataset, jax_init[0], ns)
    assert api_off.pace is None and api_none.pace is None
    for a, b in zip(jax.tree.leaves(s_off), jax.tree.leaves(s_none)):
        assert (a == b).all()
    assert _res_pace(r_off) == _res_pace(r_none)
    assert not any(k.startswith("pace/") for r in r_off for k in r)


def test_steering_moves_overselect_within_bounds(sim_dataset, jax_init):
    _, records, api = _run_port(sim_dataset, jax_init[0], _sim_args(
        pace_steering=1, pace_overselect_bounds="0,0.45"))
    eps = [d.overselect for d in api.pace.decisions]
    assert all(0.0 <= e <= 0.45 for e in eps)
    # a 25% straggler rate must pull over-selection up off the floor
    assert eps[-1] > 0.0
    assert [r["pace/overselect"] for r in records[1:]] == eps


def test_steering_without_resilience_warns_off(sim_dataset, jax_init,
                                               caplog):
    _, records, api = _run_port(sim_dataset, jax_init[0], _sim_args(
        pace_steering=1, overselect=0.0, straggler_p=0.0), rounds=1)
    assert api.pace is None and api.resilience is None
    assert "ignoring the flag" in caplog.text
    assert not any(k.startswith(("res/", "pace/")) for k in records[0])


def test_pace_record_holds_its_starting_deadline_from_the_flag(
        sim_dataset, jax_init):
    """``--deadline`` seeds the simulation's controller only: the sim has
    no wall clock, so the deadline knob never moves."""
    _, records, api = _run_port(sim_dataset, jax_init[0], _sim_args(
        pace_steering=1, deadline=7.5), rounds=3)
    assert [r["pace/deadline_s"] for r in records[1:]] == [7.5, 7.5]
    assert records[0]["pace/decision"] == -1
    assert math.isclose(api.pace.flush_deadline_s, 1.0)
