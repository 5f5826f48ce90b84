"""The port's experiment entry point against the reference's:
``fedml_tpu_torch.experiments.main_fedavg.main`` and
``fedml_tpu.experiments.main_fedavg.main`` on the same argv (plus
``--platform cpu``), the port starting from the reference's initial
weights carried over, both packing schedules with numpy. LR on
``synthetic`` with the reference's defaults for 2 rounds, and a small CNN
on 8x8 ``synthetic_images``: the histories agree at 1e-4, ``--run_dir``
gets the reference's files with the same keys, and ``evaluate_local``
(with and without ``--ci``) agrees at 1e-4. Also: the flag set and its
defaults equal the reference's, each unported flag refuses naming its
ROADMAP item, each run-time tooling flag runs and writes its artifact or
record, and without a card and without ``--platform cpu`` the command
exits non-zero."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import argparse
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from fedml_tpu.experiments import common as jcommon
from fedml_tpu.experiments import main_fedavg as jmain
from fedml_tpu_torch.experiments import common
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.utils.torch_import import cv_variables_to_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "lr": ["--comm_round", "2"],
    "cnn": ["--model", "cnn", "--dataset", "synthetic_images",
            "--image_size", "8", "--n_train", "160", "--n_test", "32",
            "--client_num_in_total", "4", "--client_num_per_round", "4",
            "--batch_size", "16", "--comm_round", "2",
            "--frequency_of_the_test", "1"],
}


def _run_both(tmp_path, monkeypatch, argv):
    import fedml_tpu.algorithms.fedavg as jfedavg
    import fedml_tpu_torch.algorithms.fedavg as tfedavg

    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    inits = []

    class JaxAPI(jfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append(jax.tree.map(np.array, self.global_state))

    class PortAPI(tfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.global_state = cv_variables_to_state(inits[0])

    monkeypatch.setattr(jfedavg, "FedAvgAPI", JaxAPI)
    monkeypatch.setattr(tfedavg, "FedAvgAPI", PortAPI)
    ref_dir, got_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    japi, _ = jmain.main(argv + ["--platform", "cpu", "--run_dir", ref_dir])
    api, _ = main_fedavg.main(argv + ["--platform", "cpu",
                                      "--run_dir", got_dir])
    return japi, api, ref_dir, got_dir


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        name = request.param
        return (name,) + _run_both(tmp_path_factory.mktemp(name), mp,
                                   CASES[name])
    finally:
        mp.undo()


def test_histories_match_the_reference_main(runs):
    name, japi, api, _, _ = runs
    assert len(api.history) == len(japi.history) == 2
    for rm, gm in zip(japi.history, api.history):
        assert sorted(gm) == sorted(rm)
        assert gm["round"] == rm["round"]
        for key in rm:
            if key not in ("round", "round_time_s"):
                np.testing.assert_allclose(gm[key], rm[key], atol=1e-4,
                                           err_msg=f"{name} {key}")


def test_run_dir_holds_the_reference_files(runs):
    _, _, _, ref_dir, got_dir = runs
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(ref_dir)) == [
        "config.json", "metrics.jsonl", "summary.json"]
    for fname in ("config.json", "summary.json"):
        with open(os.path.join(ref_dir, fname)) as f:
            want = json.load(f)
        with open(os.path.join(got_dir, fname)) as f:
            got = json.load(f)
        assert sorted(got) == sorted(want), fname
    lines = {}
    for d in (ref_dir, got_dir):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            lines[d] = [sorted(json.loads(line)) for line in f]
    assert lines[got_dir] == lines[ref_dir]


@pytest.mark.parametrize("ci", [0, 1])
def test_evaluate_local_matches_the_reference(runs, ci):
    _, japi, api, _, _ = runs
    japi.args.ci = api.args.ci = ci
    try:
        want, got = japi.evaluate_local(), api.evaluate_local()
    finally:
        japi.args.ci = api.args.ci = 0
    assert sorted(got) == sorted(want) == ["Test/Acc", "Test/Loss"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4)


def test_flags_and_defaults_are_the_reference_ones():
    ref = jcommon.add_base_args(argparse.ArgumentParser())
    port = common.add_base_args(argparse.ArgumentParser())
    assert vars(port.parse_args([])) == vars(ref.parse_args([]))


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "2"], "A15"),
    (["--mesh", "2", "--compressor", "qsgd:4"], "A15"),
    (["--mesh", "4"], "A15"),
    # the CV zoo and its file-backed sets run (test_torch_zoo_round.py);
    # the segmentation sets (A14c) train through main_fedseg, and the
    # classification mains refuse them, whatever the model
    (["--dataset", "synthetic_segmentation", "--model", "vgg11"], "A14"),
    (["--dataset", "coco_seg", "--model", "resnet18_gn"], "A14"),
    (["--dataset", "pascal_voc", "--model", "mobilenet"], "A14"),
    (["--dataset", "coco_seg"], "A14"),
    (["--dataset", "pascal_voc"], "A14"),
    (["--dataset", "synthetic_segmentation"], "A14"),
])
def test_unported_flag_refuses_naming_its_item(argv, item):
    argv = argv + ["--platform", "cpu", "--comm_round", "1",
                   "--client_num_in_total", "2", "--client_num_per_round",
                   "2"]
    if set(argv) & {"synthetic_segmentation", "pascal_voc", "coco_seg"}:
        with pytest.raises(ValueError, match="main_fedseg"):
            main_fedavg.main(argv)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        main_fedavg.main(argv)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _merged(run_dir):
    out = {}
    for r in _records(run_dir):
        out.update(r)
    return out


def _check_race(run, d):
    m = _merged(run)
    assert m["race/lock_order_cycles"] == [] and "race/locks_created" in m


def _check_race_compressed(run, d):
    _check_race(run, d)
    assert all("bytes_on_wire" in r for r in _records(run) if "round" in r
               and "Train/Loss" in r)


def _check_xprof_dir(run, d):
    assert os.listdir(d) == ["xprof_round_0"]
    assert os.path.exists(os.path.join(d, "xprof_round_0", "trace.json"))


def _check_warmup(run, d):
    m = _merged(run)
    # on the CPU the wrappers run their plain versions: nothing to build
    assert m["warmup/programs"] == 0 and m["warmup/cache_misses"] == 0


def _check_cache_dir(run, d):
    from fedml_tpu_torch.ops import _build
    # the run built in ``d``; the main restores the default after it
    assert os.path.isdir(d) and _build.build_dir() == _build._BUILD_DIR


def _check_trace(run, d):
    for name in ("trace.json", "spans.jsonl"):
        assert os.path.exists(os.path.join(run, name))
    m = _merged(run)
    assert m["compile/rounds"] == 2 and m["compile/cache_misses"] == 0


def _check_flightrec(run, d):
    assert os.path.exists(os.path.join(run, "metrics.prom"))


def _check_perfmon(run, d):
    status = json.load(open(os.path.join(run, "status.json")))
    assert status["final"] is True
    assert _merged(run)["perf/rounds_observed"] == 2


def _check_costmodel(run, d):
    m = _merged(run)
    assert m["bucket/executed_flops"] >= m["bucket/true_flops"] > 0
    assert m["cost/programs"] >= 1


def _check_audit(run, d):
    m = _merged(run)
    assert m["audit/rounds"] == 2
    assert m["audit/steady_state_retraces"] == 0
    assert m["audit/transfer_guard_violations"] == 0


def _check_wandb(run, d):
    # wandb is not installed here: the JSONL stays the sink
    assert len([r for r in _records(run) if "Train/Loss" in r]) == 2


def _check_status_path(run, d):
    assert json.load(open(d))["final"] is True


def _check_xprof_round(run, d):
    assert os.path.exists(os.path.join(run, "xprof_round_1", "trace.json"))
    assert not os.path.exists(os.path.join(run, "xprof_round_0"))


def _check_trace_dir(run, d):
    assert os.path.exists(os.path.join(d, "trace.json"))
    assert not os.path.exists(os.path.join(run, "trace.json"))


@pytest.mark.parametrize("argv,check", [
    (["--race_audit", "1", "--compressor", "topk:0.1"],
     _check_race_compressed),
    (["--perfmon", "1", "--xprof_round", "0", "--xprof_dir", "{d}"],
     _check_xprof_dir),
    (["--warmup", "1"], _check_warmup),
    (["--compile_cache_dir", "{d}"], _check_cache_dir),
    (["--trace", "1"], _check_trace),
    (["--flightrec", "1"], _check_flightrec),
    (["--perfmon", "1"], _check_perfmon),
    (["--costmodel", "1", "--bucket_edges", "geometric"], _check_costmodel),
    (["--audit", "1"], _check_audit),
    (["--race_audit", "1"], _check_race),
    (["--enable_wandb", "1"], _check_wandb),
    (["--perfmon", "1", "--status_path", "{d}"], _check_status_path),
    (["--perfmon", "1", "--xprof_round", "1"], _check_xprof_round),
    (["--trace", "1", "--trace_dir", "{d}"], _check_trace_dir),
])
def test_tooling_flag_runs_and_writes_its_artifact(tmp_path, argv, check):
    """Each run-time tooling flag (the ones that waited for ROADMAP A16)
    runs through the main and leaves its artifact or record key."""
    run, d = str(tmp_path / "run"), str(tmp_path / "out")
    if check is _check_status_path:
        d = str(tmp_path / "status.json")
    argv = [a.replace("{d}", d) for a in argv] + [
        "--platform", "cpu", "--comm_round", "2", "--client_num_in_total",
        "2", "--client_num_per_round", "2", "--run_dir", run]
    main_fedavg.main(argv)
    check(run, d)


def test_transport_eventloop_configures_as_in_the_reference(tmp_path,
                                                            monkeypatch):
    """``--transport eventloop`` parses and, as in the reference main, only
    configures (the rounds are simulated): the history equals the
    reference main's on the same argv."""
    argv = ["--comm_round", "1", "--transport", "eventloop"]
    japi, api, _, _ = _run_both(tmp_path, monkeypatch, argv)
    assert api.args.transport == japi.args.transport == "eventloop"
    assert len(api.history) == len(japi.history) == 1
    for key, want in japi.history[0].items():
        if key not in ("round", "round_time_s"):
            np.testing.assert_allclose(api.history[0][key], want, atol=1e-4,
                                       err_msg=key)


def test_compressor_none_runs():
    api, _ = main_fedavg.main(["--platform", "cpu", "--compressor", "none",
                               "--comm_round", "1"])
    assert api.round_idx == 1


def test_without_a_card_the_main_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.experiments.main_fedavg",
         "--comm_round", "2"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_cpu_main_runs_the_reference_defaults():
    api, state = main_fedavg.main(["--platform", "cpu", "--comm_round", "2"])
    assert api.device.type == "cpu" and api.round_idx == 2
    assert api.wave_runner is not None and api.device_data is not None
    assert all(np.isfinite(m["Train/Loss"]) for m in api.history)
    assert "Test/Loss" in api.history[-1]
