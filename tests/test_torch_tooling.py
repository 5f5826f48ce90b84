"""The port's kernel warmup and build cache (``fedml_tpu_torch/compile``,
``utils/compile_cache.py``), the metrics sink's wandb mirror, and the
run-time tooling's contract that it changes no computed value.

- Counterparts of the reference's ``tests/test_compile.py``: the
  enumeration names what each round path launches on a card (the
  reference names jitted programs; here they are kernel libraries), the
  warmup touches no state and no random stream, and a warm restart over
  a built directory builds nothing (0 misses), through ``_build.py``'s
  own path with the stand-in compiler of ``test_torch_analysis.py``.
- ``FEDML_TPU_COMPILE_CACHE``'s semantics.
- The wandb mirror: its not-installed branch and, with a stub module in
  ``sys.modules``, its installed branch.
- On the CPU a 2-round FedAvg main with every tooling flag on is bit
  for bit the same run with none, and a warmed run is a cold one."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import functools
import json
import logging
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_analysis import stand_in  # noqa: F401  (the fixture)

from fedml_tpu_torch import bench as tbench
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import (make_classification_spec,
                                              make_seq_classification_spec)
from fedml_tpu_torch.compile import (RoundProgram, enumerate_round_programs,
                                     round_kernel_libraries, warm_restart,
                                     warmup_api, warmup_programs)
from fedml_tpu_torch.data.synthetic import load_synthetic_images
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models import resnet56
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.resilience.recovery import RoundRecovery
from fedml_tpu_torch.utils import compile_cache
from fedml_tpu_torch.utils.metrics import MetricsLogger

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the stand-in compiler calls g++")


def _images():
    return load_synthetic_images(client_num=4, n_train=64, n_test=32,
                                 image_size=8, partition="hetero",
                                 partition_alpha=0.5, seed=0)


def _args(**kw):
    base = dict(client_num_in_total=4, client_num_per_round=4,
                comm_round=10 ** 9, epochs=1, batch_size=8, lr=0.05,
                wd=0.0, client_optimizer="sgd",
                frequency_of_the_test=10 ** 9, seed=0, client_chunk=2,
                wave_mode=1, device_resident="auto",
                device_data_cap_gb=2.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _lr_spec():
    return make_classification_spec(
        LogisticRegression(8 * 8 * 3, 10, apply_sigmoid=False))


@pytest.fixture(scope="module")
def lm_dataset():
    return tbench._synthetic_shakespeare_clients(4, 16, 90)


def _lm_spec():
    return make_seq_classification_spec(
        TransformerLM(vocab_size=90, n_layers=1, n_heads=1, d_model=16,
                      max_len=16), name="lm")


def _on_card(api):
    """The enumeration reads the device's type only: name the API's
    device a card to enumerate what the same run launches there."""
    api.device = torch.device("cuda", 0)
    return enumerate_round_programs(api)


# -- enumeration (counterparts of the reference's TestEnumeration) -----------
class TestEnumeration:
    def test_bucket_path_programs(self, lm_dataset):
        api = FedAvgAPI(lm_dataset, _lm_spec(),
                        _args(device_resident="0", bucket_edges="geometric",
                              batch_size=4), device="cpu")
        assert enumerate_round_programs(api) == []  # the CPU launches none
        progs = _on_card(api)
        assert [p.name for p in progs] == ["flash_attention"]
        assert progs[0].library is _build_library("flash_attention")
        # the chunk's clients at once, and the evaluation's batch
        assert progs[0].shapes == ((api.bucket_runner.client_chunk, 4, 16),
                                   (4, 16))

    @pytest.mark.parametrize("mode,lowering,expect", [
        (3, "pallas", ["grouped_conv_dw"]), (3, None, []),
        (1, "pallas", []), (2, "pallas", []), (0, "pallas", [])])
    def test_device_resident_programs(self, mode, lowering, expect):
        spec = make_classification_spec(resnet56(class_num=10),
                                        lane_lowering=lowering)
        api = FedAvgAPI(_images(), spec, _args(wave_mode=mode),
                        device="cpu")
        assert round_kernel_libraries(api) == expect
        assert [p.name for p in _on_card(api)] == expect

    def test_packed_sim_path(self, lm_dataset):
        api = FedAvgAPI(lm_dataset, _lm_spec(),
                        _args(device_resident="0", batch_size=4),
                        device="cpu")
        progs = _on_card(api)
        assert [p.name for p in progs] == ["flash_attention"]
        assert progs[0].shapes[0] == (4, 4, 16)

    def test_centralized_trainer_programs(self, lm_dataset):
        """The centralized trainer (``main_centralized`` warms through
        the same ``run_fedavg_family``) trains the pooled set as one
        client."""
        from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
        api = CentralizedTrainer(lm_dataset, _lm_spec(),
                                 _args(batch_size=4), device="cpu")
        progs = _on_card(api)
        assert [p.name for p in progs] == ["flash_attention"]
        assert progs[0].shapes == ((1, 4, 16), (4, 16))

    def test_warmup_never_touches_state_or_random_streams(self, lm_dataset):
        api = FedAvgAPI(lm_dataset, _lm_spec(),
                        _args(device_resident="0", bucket_edges="geometric",
                              batch_size=4), device="cpu")
        before = {k: v.clone() for k, v in api.global_state["params"].items()}
        rng = (torch.get_rng_state(), np.random.get_state()[1].copy(),
               api._data_rng.bit_generator.state)
        report = warmup_api(api)
        assert report["warmup/programs"] == 0
        for k, v in api.global_state["params"].items():
            assert torch.equal(v, before[k])
        assert torch.equal(torch.get_rng_state(), rng[0])
        assert (np.random.get_state()[1] == rng[1]).all()
        assert api._data_rng.bit_generator.state == rng[2]


def _build_library(name):
    from fedml_tpu_torch.compile.warmup import library
    return library(name)


# -- warm restart (counterparts of the reference's TestWarmRestart) ----------
@needs_gxx
class TestWarmRestart:
    def test_restart_over_a_built_directory_builds_nothing(self, stand_in,
                                                           tmp_path):
        """A first generation builds into the cache directory (misses);
        a restarted one, a fresh library object as a fresh process
        holds, loads from it: 0 misses, every program a hit."""
        cache = str(tmp_path / "cache")
        prev = _build.build_dir()
        try:
            compile_cache.enable_compilation_cache(cache)
            cold = warmup_programs([RoundProgram("kern", stand_in("kern"),
                                                 ())])
            warm = warmup_programs([RoundProgram("kern", stand_in("kern"),
                                                 ())])
        finally:
            _build.set_build_dir(prev)
        assert cold["warmup/cache_misses"] == cold["warmup/programs"] == 1
        assert cold["warmup/compile_count"] == 1
        assert cold["warmup/cache_hits"] == 0
        assert warm["warmup/cache_misses"] == 0
        assert warm["warmup/cache_hits"] >= warm["warmup/programs"]
        assert warm["warmup/compile_count"] == 0
        assert set(cold["warmup/per_program_s"]) == {"kern"}

    def test_recovery_hook_runs_the_warm_restart(self, tmp_path):
        api = FedAvgAPI(_images(), _lr_spec(), _args(), device="cpu")
        cache = str(tmp_path / "cache")
        prev = _build.build_dir()
        try:
            rec = RoundRecovery(str(tmp_path / "ckpt"),
                                warmup_fn=functools.partial(
                                    warm_restart, api, cache))
            rec.maybe_save(1, api.global_state,
                           server_state=api.server_state)
            saved = rec.restore_latest()
            assert saved is not None and rec.resumes == 1
            assert _build.build_dir() == cache
        finally:
            _build.set_build_dir(prev)
        assert rec.last_warmup["warmup/cache_dir"] == cache
        assert rec.last_warmup["warmup/cache_misses"] == 0
        rec.close()


def test_warm_restart_returns_report_without_hook(tmp_path):
    rec = RoundRecovery(str(tmp_path / "nohook"))
    assert rec.warm_restart() is None
    rec.close()


# -- the build cache's environment --------------------------------------------
@pytest.mark.parametrize("env,arg,want", [
    (None, None, "default"), ("0", None, None), ("{d}", None, "{d}"),
    ("{d}", "{a}", "{a}"), ("0", "{a}", "{a}")])
def test_compile_cache_env_semantics(tmp_path, monkeypatch, env, arg, want):
    """``FEDML_TPU_COMPILE_CACHE``: a path names the directory, ``0`` opts
    out (nothing is redirected; the kernels still build into
    ``build/``), and an explicit argument beats either."""
    d, a = str(tmp_path / "env"), str(tmp_path / "arg")
    fill = lambda v: None if v is None else v.replace("{d}", d).replace(
        "{a}", a)
    if env is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV, fill(env))
    prev = _build.build_dir()
    try:
        used = compile_cache.enable_compilation_cache(fill(arg))
        now = _build.build_dir()
    finally:
        _build.set_build_dir(prev)
    if want == "default":
        assert used == now == _build._BUILD_DIR
    elif want is None:
        assert used is None and now == _build._BUILD_DIR
    else:
        assert used == now == fill(want) and os.path.isdir(now)


# -- the wandb mirror ---------------------------------------------------------
def test_wandb_not_installed_keeps_the_jsonl(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    with caplog.at_level(logging.INFO):
        logger = MetricsLogger(run_dir=str(tmp_path), enable_wandb=True)
    assert "wandb not installed" in caplog.text
    logger({"round": 0, "Train/Loss": 1.0})
    logger.close()
    rec = json.loads(open(tmp_path / "metrics.jsonl").readline())
    assert rec["Train/Loss"] == 1.0


def test_wandb_installed_mirrors_every_record(tmp_path, monkeypatch):
    calls = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls.append(("init", kw))
    stub.log = lambda record: calls.append(("log", dict(record)))
    stub.finish = lambda: calls.append(("finish",))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    args = types.SimpleNamespace(lr=0.1)
    logger = MetricsLogger(run_dir=str(tmp_path), enable_wandb=True,
                           run_name="r", config=args)
    logger({"round": 0, "Train/Loss": 1.0})
    logger.close()
    assert calls[0] == ("init", {"project": "fedml_tpu", "name": "r",
                                 "config": {"lr": 0.1}})
    assert calls[1] == ("log", {"round": 0, "Train/Loss": 1.0})
    assert calls[2] == ("finish",)
    assert os.path.exists(tmp_path / "metrics.jsonl")
    # off, the module is never touched
    calls.clear()
    MetricsLogger(run_dir=str(tmp_path / "off"))({"round": 0})
    assert calls == []


# -- the tooling computes nothing different -----------------------------------
BASE = ["--platform", "cpu", "--comm_round", "2", "--client_num_in_total",
        "4", "--client_num_per_round", "4", "--bucket_edges", "geometric",
        "--frequency_of_the_test", "1"]


def _run(argv):
    return main_fedavg.main(argv)


def _assert_same(a, b):
    (api_a, sa), (api_b, sb) = a, b
    for group in sa:
        for k, v in sa[group].items():
            assert torch.equal(v, sb[group][k]), (group, k)
    for ra, rb in zip(api_a.history, api_b.history):
        for k in ("Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc"):
            assert ra[k] == rb[k], k


def test_every_tooling_flag_on_is_bit_equal_to_none(tmp_path):
    d = str(tmp_path)
    flags = ["--trace", "1", "--trace_dir", d + "/trace", "--flightrec", "1",
             "--perfmon", "1", "--xprof_round", "1", "--costmodel", "1",
             "--audit", "1", "--race_audit", "1", "--warmup", "1",
             "--checkpoint_dir", d + "/ckpt", "--compile_cache_dir",
             d + "/cache", "--run_dir", d + "/run"]
    plain = _run(BASE)
    tooled = _run(BASE + flags)
    _assert_same(plain, tooled)
    merged = {}
    for line in open(os.path.join(d, "run", "metrics.jsonl")):
        merged.update(json.loads(line))
    assert merged["audit/rounds"] == 2 and "bucket/executed_flops" in merged
    # one watcher booked the rounds for the audit and the trace scope
    assert merged["audit/retraces_per_round"] == \
        merged["compile/traces_per_round"]
    assert _build.build_dir() == _build._BUILD_DIR  # restored after the run
    assert os.path.exists(os.path.join(d, "run", "xprof_round_1",
                                       "trace.json"))


def test_warmed_run_is_bit_equal_to_a_cold_one():
    _assert_same(_run(BASE), _run(BASE + ["--warmup", "1"]))


def test_bucket_flops_are_the_step_count_times_executed_steps(lm_dataset):
    """The cost model's bucket attribution is a single client's counted
    step (``train_step_flops``) times the executed client-steps: the
    check ``chip_smoke.py``'s tooling phase makes at full width."""
    from fedml_tpu_torch.observability import CostModel, set_cost_model
    from fedml_tpu_torch.observability.costmodel import train_step_flops

    api = FedAvgAPI(lm_dataset, _lm_spec(),
                    _args(device_resident="0", bucket_edges="geometric",
                          batch_size=4, client_optimizer="adam"),
                    device="cpu")
    prev = set_cost_model(CostModel())
    try:
        m = api.train_one_round()
    finally:
        set_cost_model(prev)
    step = train_step_flops(api.spec, api.cfg,
                            {"x": ((4, 16), torch.int64),
                             "y": ((4, 16), torch.int64),
                             "mask": ((4,), torch.float32)})
    assert step > 0
    assert m["bucket/executed_flops"] == step * m["bucket/executed_steps"]
    assert m["bucket/true_flops"] == step * m["bucket/true_steps"]
