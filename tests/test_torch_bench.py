"""The port's bench (``fedml_tpu_torch/bench.py``) and what its record
reads, against ``bench.py`` and the JAX package: the copied constants,
the LM population byte for byte, the perf-regression ledger's verdicts
on the same files, the FLOP count of a local step against the analytic
constants within ``FLOPS_XCHECK_TOL`` (as the reference's cost model is
held), the CPU smoke of both recipes through ``main`` (one JSON line
with the reference's record keys, null device metrics), the
control-plane soaks (``--soak``, ``--tree_soak``) with the reference's
record keys on the host, the kernel-build flags (``--warmup``,
``--compile_cache_dir``) and the pace-steering bench (``--steering``)
against the reference's ``run_steering_bench``, the refusal of a flag
the reference bench lacks, and the failure without a card."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from fedml_tpu.observability import perfmon as jperfmon
from fedml_tpu_torch import bench as tbench
from fedml_tpu_torch.algorithms.specs import (make_classification_spec,
                                              make_seq_classification_spec)
from fedml_tpu_torch.data.augment import make_cifar_augment
from fedml_tpu_torch.models import resnet56
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.observability import perfmon
from fedml_tpu_torch.observability.costmodel import train_step_flops
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.parallel.engine import ClientUpdateConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the record keys of bench.py's ResNet main and of its run_lm_bench
RESNET_KEYS = (
    "metric", "value", "unit", "vs_baseline", "round_time_s", "compile_s",
    "compile_count", "compile_seconds", "samples_per_round",
    "ms_per_step_batch", "model_train_flops_per_sample", "flops_source",
    "analytic_flops_per_sample", "flops_vs_analytic", "achieved_tflops",
    "mfu", "assumed_peak_tflops", "device", "phase_timings_s", "exec_mode")
LM_KEYS = (
    "metric", "value", "unit", "lm_rounds_per_hour", "round_s",
    "rounds_measured", "tokens_per_round", "tokens_per_s", "achieved_tflops",
    "mfu", "flops_source", "analytic_flops_per_token", "assumed_peak_tflops",
    "compile_s", "warmup_compiles", "warmup_compile_s", "warmup_cache_hits",
    "warmup_cache_misses", "steady_compiles", "bucket_shapes",
    "bucket_waste_frac", "train_loss", "n_params", "device",
    "train_flops_per_token_step_cost", "step_cost_vs_analytic")


def test_constants_are_bench_pys():
    for name in ("BASELINE_ROUNDS_PER_HOUR", "FLAGSHIP_EPOCHS",
                 "RESNET56_MACS_PER_SAMPLE", "TRAIN_FLOPS_PER_SAMPLE",
                 "FLOPS_XCHECK_TOL"):
        assert getattr(tbench, name) == getattr(bench, name), name


@pytest.mark.parametrize("d,layers,seq,vocab", [
    (512, 4, 80, 90), (64, 2, 32, 90), (256, 6, 128, 10004)])
def test_lm_analytic_flops_are_bench_pys(d, layers, seq, vocab):
    assert (tbench._lm_analytic_flops_per_token(d, layers, seq, vocab)
            == bench._lm_analytic_flops_per_token(d, layers, seq, vocab))


@pytest.mark.parametrize("clients,seq_len,seed", [(32, 80, 0), (8, 32, 0),
                                                  (5, 16, 3)])
def test_synthetic_shakespeare_clients_is_byte_equal(clients, seq_len, seed):
    got = tbench._synthetic_shakespeare_clients(clients, seq_len, 90, seed)
    want = bench._synthetic_shakespeare_clients(clients, seq_len, 90, seed)
    for i in (0, 1, 4, 7):
        assert got[i] == want[i]
    for a, b in ((got[2], want[2]), (got[3], want[3])):
        for key in ("x", "y"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    for c in range(clients):
        for part in (5, 6):
            for key in ("x", "y"):
                assert got[part][c][key].dtype == want[part][c][key].dtype
                np.testing.assert_array_equal(got[part][c][key],
                                              want[part][c][key])


@pytest.mark.parametrize("name,tflops", [
    ("NVIDIA H100 80GB HBM3", 989.4), ("NVIDIA H100 SXM5 80GB", 989.4),
    ("NVIDIA H100 PCIe", 756.0), ("NVIDIA H100 NVL", 835.0),
    ("NVIDIA A100-SXM4-80GB", 989.4)])
def test_peak_flops_by_card_name(name, tflops):
    assert tbench.peak_flops(name) == tflops * 1e12


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------
_M1, _M2 = "FedAvg rounds/hour (a)", "federated-LM rounds/hour (b)"
LEDGERS = {
    "fresh": None,
    "empty": [],
    "one_record": [{"metric": _M1, "value": 100.0}],
    "pass": [{"metric": _M1, "value": v} for v in (100.0, 104.0, 98.0, 99.0)],
    "regress": [{"metric": _M1, "value": v} for v in (100.0, 102.0, 50.0)],
    "several_metrics": ([{"metric": _M1, "value": v} for v in (10.0, 11.0)]
                        + [{"metric": _M2, "value": v}
                           for v in (5.0, 5.2, 2.0)]
                        + [{"metric": _M1, "value": 10.5}]),
    "non_numeric_latest": [{"metric": _M1, "value": 10.0},
                           {"metric": _M1, "value": None}],
    "unparseable_line": [{"metric": _M1, "value": 10.0}, "{not json",
                         {"metric": _M1, "value": 9.9}],
}


def _write_ledger(path, rows):
    if rows is None:
        return
    with open(path, "w") as f:
        for r in rows:
            f.write((r if isinstance(r, str) else json.dumps(r)) + "\n")


@pytest.mark.parametrize("band", [perfmon.DEFAULT_REGRESS_BAND, 0.6])
@pytest.mark.parametrize("case", sorted(LEDGERS))
def test_check_regression_matches_the_reference(tmp_path, case, band):
    path = str(tmp_path / "ledger.jsonl")
    _write_ledger(path, LEDGERS[case])
    got = perfmon.check_regression(path, band=band)
    assert got == jperfmon.check_regression(path, band=band)
    assert perfmon.ledger_records(path) == jperfmon.ledger_records(path)


def test_append_ledger_is_read_back_by_both(tmp_path):
    assert perfmon.DEFAULT_REGRESS_BAND == jperfmon.DEFAULT_REGRESS_BAND
    path = str(tmp_path / "sub" / "ledger.jsonl")
    perfmon.append_ledger({"metric": _M1, "value": 1.0}, path)
    perfmon.append_ledger({"metric": _M1, "value": 2.0}, path)
    rows = perfmon.ledger_records(path)
    assert rows == jperfmon.ledger_records(path)
    assert [r["value"] for r in rows] == [1.0, 2.0]
    assert all("ledger_ts" in r for r in rows)


def test_check_regress_flag_reports_the_reference_verdict(tmp_path, capsys):
    path = str(tmp_path / "ledger.jsonl")
    _write_ledger(path, LEDGERS["regress"])
    detail = tbench.main(["--check-regress", "--ledger", path])
    ok, want = jperfmon.check_regression(path)
    assert detail == want and not ok
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == want
    assert tbench._exit_code(detail) == 1


# ---------------------------------------------------------------------------
# the FLOP count
# ---------------------------------------------------------------------------
def test_resnet56_step_flops_cross_check_the_analytic_constant():
    """The recipe's single-client step (bf16 ResNet-56, augmentation,
    SGD) at 32x32, per sample, against ``TRAIN_FLOPS_PER_SAMPLE``."""
    bs = 2
    spec = make_classification_spec(
        resnet56(class_num=10, dtype=torch.bfloat16),
        augment_fn=make_cifar_augment(pad=4, cutout_length=16))
    cfg = ClientUpdateConfig(optimizer="sgd", lr=0.001, weight_decay=0.001)
    flops = train_step_flops(spec, cfg, {
        "x": ((bs, 32, 32, 3), torch.float32), "y": ((bs,), torch.int64),
        "mask": ((bs,), torch.float32)})
    ratio = flops / bs / bench.TRAIN_FLOPS_PER_SAMPLE
    assert abs(ratio - 1.0) <= bench.FLOPS_XCHECK_TOL, ratio


def test_lm_step_flops_cross_check_the_analytic_count():
    """The LM flagship's single-client step (d 512, 4 layers, T 80, V 90,
    AMSGrad), per token, against ``_lm_analytic_flops_per_token``."""
    d, layers, T, V, bs = 512, 4, 80, 90, 4
    model = TransformerLM(vocab_size=V, n_layers=layers, n_heads=d // 128,
                          d_model=d, max_len=T, dtype=torch.bfloat16)
    spec = make_seq_classification_spec(model, name="lm")
    cfg = ClientUpdateConfig(optimizer="adam", lr=3e-4)
    flops = train_step_flops(spec, cfg, {
        "x": ((bs, T), torch.int32), "y": ((bs, T), torch.int64),
        "mask": ((bs,), torch.float32)})
    ratio = flops / (bs * T) / bench._lm_analytic_flops_per_token(
        d, layers, T, V)
    assert abs(ratio - 1.0) <= bench.FLOPS_XCHECK_TOL, ratio


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("recipe", ["resnet", "lm"])
def test_cpu_smoke_prints_one_record_with_the_reference_keys(
        tmp_path, capsys, recipe):
    ledger = str(tmp_path / "ledger.jsonl")
    argv = (["--smoke", "--platform", "cpu", "--clients", "8"]
            if recipe == "resnet" else ["--lm", "--smoke", "--platform", "cpu"])
    record = tbench.main(argv + ["--ledger", ledger])
    printed = _last_json(capsys)
    assert printed == record and "error" not in record
    keys = RESNET_KEYS if recipe == "resnet" else LM_KEYS
    assert [k for k in keys if k not in record] == []
    assert record["mfu"] is None and record["achieved_tflops"] is None
    assert record["device"] == "cpu" and record["power_limit_w"] is None
    assert record["host_cpus"] >= 1
    assert "device_busy_s" not in record  # no --profile_dir
    assert record["metric"].endswith("[SMOKE -- not baseline-comparable]")
    assert record["flops_source"] == "torch-flop-counter"
    assert record["value"] > 0
    phases = record["phase_timings_s"]
    inner = "lanes" if recipe == "resnet" else "bucket-chunk"
    assert {"round", "cohort-select", "local-train", inner, "aggregate",
            "report"} <= set(phases)
    totals = record["phase_totals_s"]
    assert set(totals) == set(phases)
    assert totals["round"] == phases["round"]  # one round span a round
    assert totals[inner] <= totals["local-train"] <= totals["round"]
    if recipe == "resnet":
        assert "broadcast" in phases
        assert abs(record["flops_vs_analytic"] - 1) <= bench.FLOPS_XCHECK_TOL
        assert record["samples_per_round"] == 128.0
        assert record["vs_baseline"] == 0.0
    else:
        assert record["executed_flops"] > 0
    assert perfmon.ledger_records(ledger)[-1]["value"] == record["value"]


@pytest.mark.parametrize("argv,mode,inner", [
    (["--mode", "0"], "flat", None), (["--flat"], "flat", None),
    (["--mode", "1"], "waves", "wave"), (["--mode", "2"], "lanes", "lanes")])
def test_cpu_smoke_of_each_round_mode(capsys, argv, mode, inner):
    """The ResNet recipe's CPU smoke through the flat, wave and vmap-lane
    runners: one record, the mode named, the runner's spans timed. Batch
    16, the smoke's shard size: the flat round runs its whole padded
    schedule, eight steps of full batches."""
    record = tbench.main(argv + ["--smoke", "--platform", "cpu", "--clients",
                                 "8", "--batch_size", "16", "--ledger", ""])
    assert _last_json(capsys) == record and "error" not in record
    assert record["exec_mode"] == mode and record["value"] > 0
    assert record["samples_per_round"] == 128.0
    phases = record["phase_timings_s"]
    assert {"round", "cohort-select", "broadcast", "local-train",
            "aggregate", "report"} <= set(phases)
    if inner is not None:
        assert inner in phases
    if mode == "waves":
        assert "server-update" in phases and record["wave_steps_per_round"]
    if mode == "lanes":
        assert record["lane_steps_per_round"] > 0


def test_algo_fedopt_builds_the_server_adam_line():
    """``--algo fedopt``: the reference bench's second line, the same
    recipe with server Adam (lr 0.001) on the pseudo-gradient."""
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, ServerAdam
    args = tbench._parser().parse_args(["--algo", "fedopt", "--smoke",
                                        "--clients", "8"])
    api, _ = tbench.build_api(args, torch.device("cpu"))
    assert isinstance(api, FedOptAPI)
    assert isinstance(api.server_tx, ServerAdam) and api.server_tx.lr == 0.001
    assert api.server_state["count"] == 0


def _steering_pass(record):
    """The steering bench's pass rule, read off its own record: the
    steered final model within the quality tolerance, and its rounds/hour
    at least the threshold times the best qualifying fixed
    configuration's."""
    tol = record["quality_tol"]
    qualified = [r for r in record["fixed_sweep"]
                 if "rph" in r and r["quality_rel"] <= tol]
    best = max(qualified, key=lambda r: r["rph"]) if qualified else None
    assert record["best_fixed_rph"] == (best["rph"] if best else None)
    return bool(record["steered"]["quality_rel"] <= tol and best is not None
                and record["speedup_vs_best_fixed"] is not None
                and record["speedup_vs_best_fixed"]
                >= record["speedup_threshold"])


def _warmed(record, d):
    # on the CPU the wrappers run their plain versions: nothing to build
    assert record["warmup_programs"] == record["compile_count"] == 0
    assert "error" not in record


def _cached(record, d):
    assert record["compile_cache_dir"] == d and os.path.isdir(d)
    assert _build.build_dir() != d  # the bench restores the default


def _steered(record, d):
    assert record["rounds"] == 2 and record["unit"] == "rounds/hour"
    assert record["pass"] == _steering_pass(record)


def _compressor_refused(record, d):
    assert "--compressor applies to" in record["error"]
    assert tbench._exit_code(record) == 1


@pytest.mark.parametrize("argv,check", [
    (["--warmup", "1", "--clients", "8"], _warmed),
    (["--compile_cache_dir", "{d}", "--lm"], _cached),
    (["--steering", "--steering_rounds", "2", "--steering_scale", "0.05"],
     _steered),
    (["--steering", "--compressor", "signsgd"], _compressor_refused),
    (["--compile_cache_dir", "{d}", "--check"], _cached),
])
def test_tooling_flag_runs_and_records(tmp_path, capsys, argv, check):
    """``--warmup``, ``--compile_cache_dir`` and ``--steering`` (the flags
    that waited for ROADMAP A16) run and leave their record keys."""
    d = str(tmp_path / "cache")
    argv = [a.replace("{d}", d) for a in argv]
    record = tbench.main(argv + ["--platform", "cpu", "--smoke",
                                 "--ledger", ""])
    assert _last_json(capsys) == record
    check(record, d)


@pytest.mark.parametrize("argv", [["--soak_rounds", "2"],
                                  ["--tree", "--compressor", "topk:0.1"]])
def test_a_flag_the_reference_bench_lacks_fails(capsys, argv):
    record = tbench.main(argv + ["--platform", "cpu", "--smoke"])
    assert _last_json(capsys) == record
    assert "not a flag of the port's bench" in record["error"]
    assert tbench._exit_code(record) == 1


# ---------------------------------------------------------------------------
# the control-plane soaks (host only)
# ---------------------------------------------------------------------------
#: the record keys of bench.py's run_soak_bench and run_tree_soak_bench
SOAK_KEYS = (
    "metric", "value", "unit", "compressor", "soak_params",
    "report_frame_bytes", "raw_report_frame_bytes",
    "measured_bytes_per_report", "wire_reduction", "connections",
    "connections_per_sec", "updates", "reports", "wall_s",
    "report_latency_p50_s", "report_latency_p90_s", "report_latency_p99_s",
    "sheds", "status_outcome", "transport", "jitter_model",
    "swarm_dropped", "decode_workers", "ingest_frames", "ingest_decode_s",
    "decode_s_per_report")
TREE_KEYS = (
    "metric", "value", "unit", "leaves", "fanout", "transport",
    "compressor", "jitter_model", "steering", "updates", "reports",
    "statuses", "program_cores_match", "respawned", "killed", "zombies",
    "clients_dropped", "clients_rejoined", "wall_s")
QUICK = ["--soak_jitter", "0", "--soak_updates", "2"]


@pytest.mark.parametrize("argv", [
    ["--soak", "10", "--compressor", "qsgd"],
    ["--soak", "20", "--soak_params", "1000", "--soak_decode_workers", "2"],
    ["--soak", "100"],
], ids=["qsgd", "params_workers", "n100"])
def test_soak_runs_with_the_reference_record(tmp_path, capsys, argv):
    """``--soak N`` drives N swarm connections through the buffered async
    server over the event loop on the host (``--platform cpu`` is
    accepted and moves nothing: the soak touches no device)."""
    ledger = str(tmp_path / "ledger.jsonl")
    record = tbench.main(argv + QUICK + ["--platform", "cpu",
                                         "--ledger", ledger])
    assert _last_json(capsys) == record
    assert tuple(record) == SOAK_KEYS, record.get("error")
    n = int(argv[1])
    assert record["connections"] == n and record["updates"] == 2
    assert record["reports"] == 2 * n and record["sheds"] == 0
    assert record["status_outcome"] == "complete"
    assert record["ingest_frames"] >= 2 * n
    assert record["decode_workers"] == int(
        argv[argv.index("--soak_decode_workers") + 1]
        if "--soak_decode_workers" in argv else 1)
    comp = "--compressor" in argv
    assert (record["compressor"] == "qsgd:2") == comp
    assert (record["wire_reduction"] >= 8.0) == comp
    rows = [json.loads(line) for line in open(ledger)]
    assert [r["unit"] for r in rows] == (
        ["frames/decode-sec"] + ["x-vs-plain-frames"] * comp
        + ["reports/sec"])
    assert tbench._exit_code(record) == 0


@pytest.mark.parametrize("argv", [
    ["--tree_soak", "8"],
    ["--tree_soak", "8", "--tree_transport", "tcp", "--compressor",
     "topk:0.1"],
], ids=["eventloop", "tcp_topk"])
def test_tree_soak_runs_with_the_reference_record(tmp_path, capsys, argv):
    """``--tree_soak N``: a real tree of 2 edge processes with a swarm
    each; every tier's status file is final and on one program core,
    nothing is killed and nothing is left behind."""
    ledger = str(tmp_path / "ledger.jsonl")
    record = tbench.main(argv + QUICK + ["--ledger", ledger])
    assert _last_json(capsys) == record
    assert tuple(record) == TREE_KEYS, record.get("error")
    assert record["leaves"] == 8 and record["reports"] == 16
    assert record["statuses"] == 3 and record["program_cores_match"]
    assert (record["killed"], record["zombies"], record["respawned"]) == (
        0, 0, 0)
    assert record["transport"] == ("tcp" if "--tree_transport" in argv
                                   else "eventloop")
    rows = [json.loads(line) for line in open(ledger)]
    assert sorted(r["bench"] for r in rows) == ["tree-edge", "tree-edge",
                                                "tree-soak"]


# ---------------------------------------------------------------------------
# the massive cohort
# ---------------------------------------------------------------------------
MASSIVE_N = 300
#: (port argv, reference flags): sync at the defaults (chunk 128, one
#: drain-free synchronous fold), async with chunks of 16 and buffer_k 64
#: so flushes land inside the window
MASSIVE_CASES = {
    "sync": ([], dict(massive_async=0, massive_chunk=128, buffer_k=2048)),
    "async": (["--massive_async", "1", "--massive_chunk", "16",
               "--buffer_k", "64"],
              dict(massive_async=1, massive_chunk=16, buffer_k=64)),
}


def test_ragged_lr_clients_is_byte_equal():
    got = tbench._ragged_lr_clients(500, seed=3)
    want = bench._ragged_lr_clients(500, seed=3)
    for i in (0, 1, 4, 7):
        assert got[i] == want[i]
    for c in (0, 7, 499):
        for key in ("x", "y"):
            assert got[5][c][key].dtype == want[5][c][key].dtype
            np.testing.assert_array_equal(got[5][c][key], want[5][c][key])
    np.testing.assert_array_equal(got[3]["x"], want[3]["x"])


@pytest.fixture(scope="module", params=sorted(MASSIVE_CASES))
def massive(request):
    """The reference's ``run_massive_cohort`` and the port's at N 300 on
    the CPU, the port from the reference's initial weights, numpy
    packing in both: (case, reference record, port record)."""
    import types

    import jax

    import fedml_tpu.algorithms.fedavg as jfedavg
    import fedml_tpu_torch.algorithms.fedavg as tfedavg
    from fedml_tpu_torch.utils.torch_import import cv_variables_to_state

    argv, flags = MASSIVE_CASES[request.param]
    mp = pytest.MonkeyPatch()
    inits = []

    class JaxAPI(jfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append(jax.tree.map(np.array, self.global_state))

    class PortAPI(tfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.global_state = cv_variables_to_state(inits[0])

    mp.setenv("FEDML_TPU_PACKING", "python")
    mp.setattr(jfedavg, "FedAvgAPI", JaxAPI)
    mp.setattr(tfedavg, "FedAvgAPI", PortAPI)
    out = {}
    mp.setattr(bench, "print", lambda line, **kw: out.setdefault(
        "ref", json.loads(line)), raising=False)
    try:
        assert bench.run_massive_cohort(types.SimpleNamespace(
            massive_cohort=MASSIVE_N, staleness_decay=0.5, rounds=1,
            compressor=None, ledger="", **flags)) == 0
        record = tbench.main(["--massive_cohort", str(MASSIVE_N),
                              "--platform", "cpu", "--rounds", "1",
                              "--ledger", ""] + argv)
    finally:
        mp.undo()
    return request.param, out["ref"], record


def test_massive_cohort_matches_the_reference_bench(massive):
    case, ref, got = massive
    assert "error" not in got
    for key in ("clients_per_round", "rounds_measured", "bucket_shapes",
                "true_steps", "executed_steps", "bucket_waste_frac",
                "flops_waste_frac", "unit", "compressor"):
        assert got[key] == ref[key], key
    assert ([{k: b[k] for k in ("edge", "clients", "chunks",
                                "executed_steps", "true_steps")}
             for b in got["per_bucket"]]
            == [{k: b[k] for k in ("edge", "clients", "chunks",
                                   "executed_steps", "true_steps")}
                for b in ref["per_bucket"]])
    assert got["chunks"] == sum(b["chunks"] for b in ref["per_bucket"])
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"],
                               atol=1e-4)
    assert got["metric"].startswith(ref["metric"])
    if case == "async":
        assert got["async"] == ref["async"]
        assert got["async"]["max_staleness"] > 0
    else:
        assert "async" not in got and "async" not in ref


def test_massive_record_names_device_backend_and_flops(massive):
    _, _, got = massive
    assert got["device"] == "cpu" and got["power_limit_w"] is None
    assert got["packing_backend"] == "python"
    assert got["flops_source"] == "torch-flop-counter"
    assert got["executed_flops"] >= got["true_flops"] > 0
    assert got["value"] > 0 and got["steady_compiles"] == 0
    assert {"round", "local-train", "bucket-chunk"} <= set(
        got["phase_timings_s"])


@pytest.mark.parametrize("name,want", [
    ("Intel(R) Xeon(R) Platinum 8480+", "Intel(R) Xeon(R) Platinum 8480+"),
    ("unknown", "GenuineIntel family 6 model 207"),
])
def test_host_fields_name_the_cpu(tmp_path, name, want):
    path = tmp_path / "cpuinfo"
    block = ("processor\t: {}\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
             "model\t\t: 207\nmodel name\t: " + name + "\n\n")
    path.write_text(block.format(0) + block.format(1))
    fields = tbench._host_fields(str(path))
    assert fields["host_cpu"] == want and fields["host_cpus"] >= 1


@pytest.mark.parametrize("recipe", [[], ["--lm"]])
def test_zero_measured_rounds_is_refused(capsys, recipe):
    record = tbench.main(recipe + ["--rounds", "0", "--platform", "cpu"])
    assert _last_json(capsys) == record
    assert "--rounds 0" in record["error"] and tbench._exit_code(record) == 1


@pytest.mark.parametrize("recipe", [[], ["--lm"]])
def test_without_a_card_the_bench_fails(monkeypatch, capsys, recipe):
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "run_resnet_bench",
                        lambda *a: ran.append(a))
    monkeypatch.setattr(tbench, "run_lm_bench", lambda *a: ran.append(a))
    record = tbench.main(recipe + ["--ledger", ""])
    assert _last_json(capsys) == record
    assert "no CUDA device" in record["error"] and ran == []


def test_module_exits_non_zero_without_a_card():
    # the card, if the machine has one, is hidden: with it the command
    # would run the uncut flagship
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.bench", "--rounds", "1",
         "--ledger", ""], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["value"] == 0.0 and "no CUDA device" in last["error"]
