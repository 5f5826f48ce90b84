"""The port's observability switchboard (``fedml_tpu_torch/observability``:
``enable`` with its crash hooks, ``PerfMonitor`` and ``StatusWriter``,
the tracer, registry, flight recorder and ledger it arms) against the
reference.

- The reference's own scenarios (``tests/test_observability.py``)
  retargeted at the port, without the pieces that wait for ROADMAP A16:
  the xprof capture, the cost model and the metrics logger's registry
  snapshots.
- The A16 pieces refuse naming their ROADMAP item when asked for.
- With everything the port has armed, a TCP run is bit-equal to an
  unobserved one, and the status file's fields equal the reference's."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json

import numpy as np
import pytest

from reference_scenarios import retarget

import fedml_tpu.observability as ref_obs
import fedml_tpu.resilience as ref_res
import fedml_tpu_torch.observability as port_obs
import fedml_tpu_torch.resilience as port_res
from fedml_tpu_torch.observability import PerfMonitor, enable, get_registry

_obs = retarget("test_observability.py",
                drop=("CostModel", "get_cost_model", "set_cost_model"))

# -- the reference's scenarios, through the port -----------------------------
TestTracer = _obs.TestTracer
TestFlightRecorder = _obs.TestFlightRecorder
TestHistogramRendering = _obs.TestHistogramRendering


class TestRegistry(_obs.TestRegistry):
    # the mains' metrics logger with a registry is ROADMAP A16's --trace
    test_metrics_logger_snapshots_registry_per_record = None


class TestPerfMonitor(_obs.TestPerfMonitor):
    # the per-round profiler capture is ROADMAP A16's (torch.profiler)
    test_xprof_fires_only_on_its_round_and_once = None
    test_xprof_noops_cleanly_when_profiler_unavailable = None


class TestCrossRankTracing(_obs.TestCrossRankTracing):
    # arms the cost model (ROADMAP A16): the port's version without it
    # is test_observed_run_is_bit_equal_to_an_unobserved_one below
    test_disabled_path_is_bitwise_identical = None


class TestLedger(_obs.TestLedger):
    # drives the reference's bench.py; the port's bench CLI has its own
    # case in test_torch_bench.py
    test_bench_check_regress_cli_both_ways = None


def test_the_retargeted_scenarios_run_the_port():
    assert _obs.enable.__module__ == "fedml_tpu_torch.observability"
    assert _obs.PerfMonitor.__module__ == \
        "fedml_tpu_torch.observability.perfmon"


# -- the pieces that wait for ROADMAP A16 -------------------------------------
@pytest.mark.parametrize("kw", [dict(trace=True), dict(compile_events=True),
                                dict(perfmon=True, xprof_round=1),
                                dict(cost_model=True)])
def test_enable_refuses_the_a16_pieces(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        with enable(**kw):
            pass
    assert get_registry() is None  # nothing was installed


def test_perf_monitor_refuses_the_xprof_window():
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        PerfMonitor(xprof_round=0)


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
