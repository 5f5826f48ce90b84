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
ROADMAP item, and without a card and without ``--platform cpu`` the
command exits non-zero."""

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
from fedml_tpu_torch.utils.torch_import import zoo_variables_to_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "lr": ["--comm_round", "2"],
    "cnn": ["--model", "cnn", "--dataset", "synthetic_images",
            "--image_size", "8", "--n_train", "160", "--n_test", "32",
            "--client_num_in_total", "4", "--client_num_per_round", "4",
            "--batch_size", "16", "--comm_round", "2",
            "--frequency_of_the_test", "1"],
}


def _run_both(tmp_path, monkeypatch, argv, convs):
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
            self.global_state = zoo_variables_to_state(inits[0], convs)

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
        convs = ("conv1", "conv2") if name == "cnn" else ()
        return (name,) + _run_both(tmp_path_factory.mktemp(name), mp,
                                   CASES[name], convs)
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
    (["--race_audit", "1", "--compressor", "topk:0.1"], "A16"),
    (["--mesh", "2", "--compressor", "qsgd:4"], "A15"),
    (["--xprof_dir", "/nonexistent"], "A16"),
    (["--warmup", "1"], "A16"),
    (["--compile_cache_dir", "/nonexistent"], "A16"),
    (["--trace", "1"], "A16"),
    (["--flightrec", "1"], "A16"),
    (["--perfmon", "1"], "A16"),
    (["--costmodel", "1"], "A16"),
    (["--audit", "1"], "A16"),
    (["--race_audit", "1"], "A16"),
    (["--enable_wandb", "1"], "A16"),
    (["--mesh", "4"], "A15"),
    (["--status_path", "/nonexistent"], "A16"),
    (["--xprof_round", "1"], "A16"),
    (["--trace_dir", "/nonexistent"], "A16"),
    (["--model", "vgg11"], "A14"),
    (["--model", "resnet18_gn"], "A14"),
    (["--transport", "eventloop"], "A13"),
    (["--model", "mobilenet"], "A14"),
    (["--dataset", "fed_cifar100"], "A14"),
    (["--dataset", "pascal_voc"], "A14"),
    (["--dataset", "femnist"], "A14"),
])
def test_unported_flag_refuses_naming_its_item(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        main_fedavg.main(argv + ["--platform", "cpu", "--comm_round", "1",
                                 "--client_num_in_total", "2",
                                 "--client_num_per_round", "2"])


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
