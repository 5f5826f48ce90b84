"""Checkpoint and resume in the port: ``utils/checkpoint.py``'s
``Checkpointer`` (round trip, server state, retention, best metric,
config snapshot, the batch-shuffle stream) and the experiment mains'
``--checkpoint_dir``/``--resume``: a ``main_fedopt`` (FedAdam) run saved
after round 1 and resumed for round 2 is bitwise equal on the CPU to an
uninterrupted 2-round run, and within 1e-4 of the JAX package's 2
rounds (the port from the reference's initial weights carried over, both
sides packing schedules with numpy); every FedAvg-family main and the
centralized main save and resume."""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.experiments import main_fedopt as jmain_fedopt
from fedml_tpu_torch.algorithms import fedopt
from fedml_tpu_torch.experiments import (main_centralized, main_fedavg,
                                         main_fedavg_robust, main_fednova,
                                         main_fedopt, main_hierarchical)
from fedml_tpu_torch.utils.checkpoint import Checkpointer
from fedml_tpu_torch.utils.torch_import import zoo_state_to_variables

FEDADAM = ["--server_optimizer", "adam", "--comm_round", "2",
           "--frequency_of_the_test", "1", "--platform", "cpu"]


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "b": torch.zeros(3)}}


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_roundtrip_and_latest(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.restore() is None and ckpt.latest_round() is None
    s0, s5 = _state(0), _state(5)
    ckpt.save(0, s0, server_state=(), rng=3)
    ckpt.save(5, s5, server_state=(), rng=3)
    assert ckpt.latest_round() == 5
    out = ckpt.restore()
    assert out["round_idx"] == 5 and int(out["rng"]) == 3
    assert _equal(out["global_state"], s5) and out["server_state"] == ()
    assert out["data_rng"] is None
    assert _equal(ckpt.restore(0)["global_state"], s0)


def test_server_state_roundtrip_and_template(tmp_path):
    """A FedAdam server state (count, mu, nu) restores exactly; a
    template of another structure is refused."""
    tx = fedopt.get_server_optimizer("adam", 0.1)
    params = _state()["params"]
    server = tx.init(params)
    server = tx.update({k: torch.ones_like(v) for k, v in params.items()},
                       server, params)[1]
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"params": params}, server_state=server)
    out = ckpt.restore(server_state_template=tx.init(params))
    assert _equal(out["server_state"], server)
    assert out["server_state"]["count"].dtype == torch.int32
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(server_state_template=fedopt.get_server_optimizer(
            "sgd", 0.1).init(params))
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(server_state_template=())


def test_retention_keeps_the_latest_three(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    for r in range(6):
        ckpt.save(r, _state(r))
    assert sorted(os.listdir(tmp_path)) == ["round_3.pt", "round_4.pt",
                                            "round_5.pt"]
    assert ckpt.best_round() == 5


def test_best_metric_tracking(tmp_path):
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2, best_mode="max")
    for r, m in enumerate((0.4, 0.9, 0.6, 0.2)):
        ckpt.save(r, _state(), metric=m)
    with open(os.path.join(ckpt.directory, "best_pred.txt")) as f:
        assert json.loads(f.read()) == {"metric": 0.9, "round": 1}
    assert ckpt.best_round() == 1
    assert ckpt.latest_round() == 2  # 0.2 and 0.4 fell out
    low = Checkpointer(str(tmp_path / "low"), best_mode="min")
    for r, m in enumerate((0.4, 0.1, 0.6)):
        low.save(r, _state(), metric=m)
    assert low.best_round() == 1
    with pytest.raises(ValueError):
        Checkpointer(str(tmp_path / "bad"), best_mode="median")


def test_config_snapshot(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save_config(types.SimpleNamespace(model="resnet56", lr=0.001,
                                           comm_round=100, data_dir=None))
    with open(os.path.join(ckpt.directory, "parameters.json")) as f:
        params = json.load(f)
    assert params == {"model": "resnet56", "lr": 0.001, "comm_round": 100,
                      "data_dir": None}


def test_data_rng_continues_its_stream(tmp_path):
    rng = np.random.default_rng(7)
    rng.integers(0, 100, 13)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(2, _state(), data_rng=rng)
    restored = ckpt.restore()["data_rng"]
    assert np.array_equal(restored.integers(0, 2 ** 62, 50),
                          rng.integers(0, 2 ** 62, 50))


@pytest.fixture(scope="module")
def fedadam_runs(tmp_path_factory):
    """The reference main's 2 rounds, the port's uninterrupted 2 rounds,
    and the port's run cut after round 1 and resumed."""
    import fedml_tpu.algorithms.fedopt as jfedopt

    tmp = tmp_path_factory.mktemp("fedadam")
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    inits = []

    class JaxAPI(jfedopt.FedOptAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append(jax.tree.map(np.array, self.global_state))

    class PortAPI(fedopt.FedOptAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            from fedml_tpu_torch.utils.torch_import import (
                zoo_variables_to_state)
            self.global_state = zoo_variables_to_state(inits[0])

    try:
        mp.setattr(jfedopt, "FedOptAPI", JaxAPI)
        mp.setattr(fedopt, "FedOptAPI", PortAPI)
        japi, _ = jmain_fedopt.main(FEDADAM)
        full, _ = main_fedopt.main(FEDADAM)
        ckpt = ["--checkpoint_dir", str(tmp / "ckpt")]
        part, _ = main_fedopt.main(FEDADAM[:2] + ["--comm_round", "1"]
                                   + FEDADAM[4:] + ckpt)
        resumed, _ = main_fedopt.main(FEDADAM + ckpt + [
            "--resume", "1", "--run_dir", str(tmp / "run")])
    finally:
        mp.undo()
    return japi, full, part, resumed, tmp


def test_resumed_fedadam_equals_the_uninterrupted_run(fedadam_runs):
    _, full, part, resumed, tmp = fedadam_runs
    assert part.round_idx == 1 and resumed.round_idx == 2
    assert [m["round"] for m in resumed.history] == [1]
    assert _equal(resumed.global_state, full.global_state)
    assert _equal(resumed.server_state, full.server_state)
    assert int(resumed.server_state["count"]) == 2
    assert resumed.history[0] == {**full.history[1], "round_time_s":
                                  resumed.history[0]["round_time_s"]}
    with open(tmp / "run" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert any(line.get("res/resumes") == 1 and line["round"] == 1
               for line in lines)
    assert sorted(os.listdir(tmp / "ckpt")) == [
        "best_pred.txt", "parameters.json", "round_1.pt", "round_2.pt"]


def test_fedadam_run_matches_the_reference_main(fedadam_runs):
    japi, full, _, _, _ = fedadam_runs
    got = zoo_state_to_variables(full.global_state)
    want = jax.tree.map(np.asarray, japi.global_state)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=str(path))
    for gm, rm in zip(full.history, japi.history):
        for key in ("Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc"):
            np.testing.assert_allclose(gm[key], rm[key], atol=1e-4)


IMAGES = ["--dataset", "synthetic_images", "--model", "cnn", "--image_size",
          "8", "--n_train", "96", "--n_test", "16", "--client_num_in_total",
          "4", "--client_num_per_round", "4", "--batch_size", "16"]


@pytest.mark.parametrize("module,argv", [
    (main_fedavg, []), (main_fednova, []), (main_hierarchical, []),
    (main_centralized, []), (main_fedavg_robust, IMAGES),
    (main_fedopt, ["--server_optimizer", "yogi"])],
    ids=["fedavg", "fednova", "hierarchical", "centralized",
         "fedavg_robust", "fedopt"])
def test_every_main_saves_and_resumes(module, argv, tmp_path):
    """Saved every round with ``--save_frequency 1``; a resumed run
    starts from the saved round and state."""
    base = argv + ["--platform", "cpu", "--checkpoint_dir", str(tmp_path),
                   "--save_frequency", "1"]
    first, _ = module.main(base + ["--comm_round", "1"])
    assert Checkpointer(str(tmp_path)).latest_round() == 1
    saved = Checkpointer(str(tmp_path)).restore()
    assert _equal(saved["global_state"], first.global_state)
    second, _ = module.main(base + ["--comm_round", "2", "--resume", "1"])
    assert second.round_idx == 2 and len(second.history) == 1
    assert Checkpointer(str(tmp_path)).latest_round() == 2
