"""The port's observability switchboard (``fedml_tpu_torch/observability``:
``enable`` with its crash hooks, ``PerfMonitor`` with its ``--xprof_round``
window and ``StatusWriter``, the compile watcher, the cost model, the
tracer, registry, flight recorder and ledger it arms) against the
reference.

- The reference's own scenarios (``tests/test_observability.py``)
  retargeted at the port, ``jax.profiler``'s capture calls read as the
  port's (``utils/profiling.py`` ``start_trace``/``stop_trace``);
  the reference's cost-model cases compile XLA programs, and have
  counterparts here with the same asserts.
- Every piece ``enable`` arms is set on its scope and reports on exit.
- With everything armed, a TCP run is bit-equal to an unobserved one,
  and the status file's fields equal the reference's."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from reference_scenarios import retarget

import fedml_tpu.observability as ref_obs
import fedml_tpu.resilience as ref_res
import fedml_tpu_torch.observability as port_obs
import fedml_tpu_torch.resilience as port_res
from fedml_tpu_torch.observability import (CostModel, PerfMonitor, enable,
                                           get_cost_model, get_registry,
                                           set_cost_model)
from fedml_tpu_torch.utils import profiling

_obs = retarget("test_observability.py",
                subs=((r"\bjax\.profiler\.", "_port_profiling."),),
                env={"_port_profiling": profiling})

# -- the reference's scenarios, through the port -----------------------------
TestTracer = _obs.TestTracer
TestFlightRecorder = _obs.TestFlightRecorder
TestHistogramRendering = _obs.TestHistogramRendering
TestRegistry = _obs.TestRegistry
TestPerfMonitor = _obs.TestPerfMonitor
TestCrossRankTracing = _obs.TestCrossRankTracing


class TestLedger(_obs.TestLedger):
    # drives the reference's bench.py; the port's bench CLI has its own
    # case in test_torch_bench.py
    test_bench_check_regress_cli_both_ways = None


def test_the_retargeted_scenarios_run_the_port():
    assert _obs.enable.__module__ == "fedml_tpu_torch.observability"
    assert _obs.PerfMonitor.__module__ == \
        "fedml_tpu_torch.observability.perfmon"


# -- every piece enable() arms -----------------------------------------------
@pytest.mark.parametrize("kw,attr", [
    (dict(trace=True), "compile_watcher"),  # compile_events follows trace
    (dict(compile_events=True), "compile_watcher"),
    (dict(perfmon=True, xprof_round=1), "monitor"),
    (dict(cost_model=True), "cost_model")])
def test_enable_arms_each_piece_and_reports_it(tmp_path, kw, attr):
    """Each piece is set on the scope while it is open, its report goes to
    the metrics sink on exit (the watcher's always, the cost model's and
    the monitor's once they hold something) and the globals are restored."""
    records = []
    with enable(trace_dir=str(tmp_path), metrics_logger=records.append,
                **kw) as obs:
        piece = getattr(obs, attr)
        assert piece is not None
        if attr == "monitor":
            assert piece.xprof_round == 1
            assert piece.xprof_dir == str(tmp_path)
            piece.observe_round(0.1)
        if attr == "cost_model":
            assert get_cost_model() is piece
            piece.note("probe", None)
    keys = {k for r in records for k in r}
    want = {"compile_watcher": "compile/cache_misses",
            "monitor": "perf/rounds_observed",
            "cost_model": "cost/programs"}[attr]
    assert want in keys
    assert get_registry() is None and get_cost_model() is None


def test_perf_monitor_xprof_window_captures_its_round_once(tmp_path):
    """The window is a real ``torch.profiler`` capture (host activity on
    the CPU) of exactly its round, written to
    ``<xprof_dir>/xprof_round_<N>/trace.json``, taken once."""
    mon = PerfMonitor(xprof_dir=str(tmp_path), xprof_round=1)
    for r in (0, 1, 1):
        with mon.xprof(r):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.listdir(tmp_path) == ["xprof_round_1"]
    doc = json.load(open(mon.xprof_path))
    assert mon.xprof_path == str(tmp_path / "xprof_round_1" / "trace.json")
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


# -- the port with everything armed -------------------------------------------
def _tcp(pkg_res, **kw):
    w0 = {"w": np.zeros((4, 4), np.float32), "b": np.ones(4, np.float32)}
    return pkg_res.run_tcp_fedavg(
        4, 3, pkg_res.RoundPolicy(deadline_s=30.0, quorum=0.3), w0,
        join_timeout=90, **kw)


def test_observed_run_is_bit_equal_to_an_unobserved_one(tmp_path):
    """The reference's disabled-path scenario with every piece the port
    has armed (tracer, flight recorder, registry, perf monitor and
    ``status.json``): the protocol's arithmetic is untouched."""
    plain = _tcp(port_res)
    with enable(trace=True, flightrec=True, flightrec_dir=str(tmp_path),
                compile_events=False, perfmon=True,
                status_path=str(tmp_path / "status.json")):
        observed = _tcp(port_res)
    assert plain.reporting_log == observed.reporting_log
    for a, b in zip(plain.history, observed.history):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    doc = json.load(open(tmp_path / "status.json"))
    assert doc["final"] is True and doc["round"] == 3


def test_status_files_carry_the_reference_fields(tmp_path):
    """The same TCP run under ``enable(perfmon=True)`` in each package:
    the status documents hold the same keys and the same run-determined
    values (times and rates aside)."""
    docs = []
    for obs, res, name in ((ref_obs, ref_res, "ref"),
                           (port_obs, port_res, "port")):
        path = str(tmp_path / f"{name}.json")
        with obs.enable(perfmon=True, status_path=path,
                        compile_events=False):
            _tcp(res)
        docs.append(json.load(open(path)))
    want, got = docs
    assert sorted(got) == sorted(want)
    timing = {"updated_at", "rounds_per_hour", "last_round_s"}
    for k in want:
        if k not in timing:
            assert got[k] == want[k], k


# -- the cost model (counterparts of the reference's TestCostModel) ----------
class TestCostModel:
    def test_program_flops_counts_matmul_flops_exactly(self):
        from fedml_tpu_torch.observability.costmodel import program_flops

        flops = program_flops(lambda a, b: a @ b, torch.zeros(8, 64),
                              torch.zeros(64, 32))
        assert flops == 2 * 8 * 64 * 32  # one MAC = 2 flops
        # the flop counter counts no bytes: the catalog has none
        cm = CostModel()
        cm.note("mm", flops)
        assert cm.record() == {"cost/programs": 1,
                               "cost/mm_flops": 2 * 8 * 64 * 32}

    def test_train_step_flops_unknown_optimizer_raises(self):
        """The reference's cost probe degrades to None for an optimizer it
        cannot build; the port builds its optimizer eagerly and refuses
        the name (nothing falls back quietly)."""
        from fedml_tpu_torch.algorithms.specs import make_classification_spec
        from fedml_tpu_torch.models.linear import LogisticRegression
        from fedml_tpu_torch.observability.costmodel import train_step_flops
        from fedml_tpu_torch.parallel.engine import ClientUpdateConfig

        spec = make_classification_spec(LogisticRegression(4, 2))
        with pytest.raises(ValueError, match="nope"):
            train_step_flops(
                spec, ClientUpdateConfig(optimizer="nope"),
                {"x": ((2, 4), torch.float32), "y": ((2,), torch.int64),
                 "mask": ((2,), torch.float32)})

    def test_bucket_runner_attributes_per_bucket_flops(self):
        """Cost model armed: per-bucket FLOPs and FLOP-weighted waste ride
        the round record; the same run with it off carries no FLOP fields
        and bit-equal parameters."""
        from fedml_tpu_torch import bench as tbench
        from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
        from fedml_tpu_torch.algorithms.specs import make_classification_spec
        from fedml_tpu_torch.models.linear import LogisticRegression

        C = 300
        dataset = tbench._ragged_lr_clients(C)
        spec = make_classification_spec(
            LogisticRegression(16, 4, apply_sigmoid=False))
        run_args = types.SimpleNamespace(
            client_num_in_total=C, client_num_per_round=C,
            comm_round=10 ** 9, epochs=1, batch_size=8, lr=0.05, wd=0.0,
            client_optimizer="sgd", frequency_of_the_test=10 ** 9, seed=0,
            client_chunk=64, bucket_edges="geometric", device_resident="0")

        api_off = FedAvgAPI(dataset, spec, run_args, device="cpu")
        m_off = api_off.train_one_round()
        assert "bucket/executed_flops" not in m_off

        cm = CostModel()
        prev = set_cost_model(cm)
        try:
            api_on = FedAvgAPI(dataset, spec, run_args, device="cpu")
            m_on = api_on.train_one_round()
        finally:
            set_cost_model(prev)
        assert get_cost_model() is prev
        for k, v in api_off.global_state["params"].items():
            assert torch.equal(v, api_on.global_state["params"][k]), k

        assert m_on["bucket/executed_flops"] > m_on["bucket/true_flops"] > 0
        assert 0.0 <= m_on["bucket/flops_waste_frac"] < 1.0
        info = api_on._last_bucket_info["bucket"]
        assert info["flops_source"] == "torch-flop-counter"
        used = [b for b in info["per_bucket"] if not b["skipped"]]
        assert used and all("flops_per_step" in b and
                            b["executed_flops"] >= b["true_flops"]
                            for b in used)
        assert math.isclose(sum(b["executed_flops"] for b in used),
                            info["executed_flops"], rel_tol=1e-9)
        # one step of LR 16 -> 4 on 8 samples: the forward product and the
        # weight gradient's (the data takes no gradient)
        assert used[0]["flops_per_step"] == 2 * (2 * 16 * 4 * 8)
        assert cm.record()["cost/programs"] == len(used)
