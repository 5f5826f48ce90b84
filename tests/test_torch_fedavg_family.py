"""The rest of the simulated FedAvg family in the port against the JAX
package: the server optimizers against optax, FedOpt (FedAdam), FedNova
over every round path, robust FedAvg, hierarchical FL and the
centralized trainer against their JAX APIs, the poisoning helpers, and
the five new experiment mains.

Models and data as ``test_torch_rounds.py``: LR on LEAF synthetic (60
features) and ``CNNOriginalFedAvg`` on 8x8x3 images, 4 clients, batch 16,
the port starting from the reference's initial weights carried over,
both sides packing schedules with numpy. Tolerances: the server
optimizers 1e-6 relative (and 1e-7 absolute, for entries near zero) over
5 steps; every round comparison 1e-4 absolute on the global state and
the round metrics; the FedAdam server state 1e-4 absolute and
relative."""

import argparse
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fedopt as jfedopt
from fedml_tpu.algorithms.centralized import (CentralizedTrainer as
                                              JaxCentralized)
from fedml_tpu.algorithms.fedavg_robust import FedAvgRobustAPI as JaxRobust
from fedml_tpu.algorithms.fednova import FedNovaAPI as JaxFedNova
from fedml_tpu.algorithms.hierarchical import (HierarchicalFedAvgAPI as
                                               JaxHierarchical)
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.data import poison as jpoison
from fedml_tpu.data.synthetic import (load_synthetic_federated as
                                      jax_load_federated)
from fedml_tpu.data.synthetic import load_synthetic_images
from fedml_tpu.experiments import common as jcommon
from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNN
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch.algorithms import fedopt
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobustAPI,
                                                      make_robust_hooks)
from fedml_tpu_torch.algorithms.fednova import FedNovaAPI
from fedml_tpu_torch.algorithms.hierarchical import (HierarchicalFedAvgAPI,
                                                     round_robin_groups)
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.data import poison
from fedml_tpu_torch.experiments import (main_centralized,
                                         main_fedavg_robust, main_fednova,
                                         main_fedopt, main_hierarchical)
from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.utils.torch_import import (server_state_from_optax,
                                                server_state_to_optax,
                                                zoo_state_to_variables,
                                                zoo_variables_to_state)
from test_torch_rounds import H, _args, check_rounds

TOL = 1e-4
CONVS = ("conv1", "conv2")
OPTIMIZERS = ("sgd", "adam", "adagrad", "yogi")


@pytest.fixture(autouse=True)
def _numpy_packing(monkeypatch):
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")


def _np(tree):
    return jax.tree.map(np.array, tree)


def _family(name):
    """(dataset, jax spec, port spec, to_state, to_vars): LR on a
    heterogeneous (LDA) LEAF split or the CNN on hetero 8x8 images, so
    the clients run different step counts."""
    if name == "lr":
        ds = jax_load_federated(client_num=4, n_train=150, n_test=40,
                                partition="hetero", seed=0)
        return (ds, jax_spec(JaxLR(num_classes=10), jnp.zeros((1, 60))),
                make_classification_spec(LogisticRegression(60, 10)),
                zoo_variables_to_state, zoo_state_to_variables)
    ds = load_synthetic_images(client_num=4, n_train=150, n_test=40,
                               image_size=H, partition="hetero",
                               partition_alpha=0.5, seed=0)
    return (ds, jax_spec(JaxCNN(), jnp.zeros((1, H, H, 3))),
            make_classification_spec(CNNOriginalFedAvg(input_shape=(H, H,
                                                                    3))),
            lambda v: zoo_variables_to_state(v, CONVS),
            lambda s: zoo_state_to_variables(s, CONVS))


def _pair(jcls, tcls, name, args, jkw=None, tkw=None, ds=None):
    """The JAX API and the port's on the same arguments, the port from
    the reference's initial weights."""
    fam_ds, jspec, tspec, to_state, to_vars = _family(name)
    ds = fam_ds if ds is None else ds
    japi = jcls(ds, jspec, args, **(jkw or {}))
    api = tcls(ds, tspec, args, device="cpu", **(tkw or {}))
    init = _np(japi.global_state)
    api.global_state = to_state(init)
    return japi, api, init, to_vars


def _train_both(japi, api, init, to_vars):
    ref, got = [], []
    japi.train(on_round=lambda a, m: ref.append((dict(m),
                                                 _np(a.global_state))))
    api.train(on_round=lambda a, m: got.append((dict(m),
                                                to_vars(a.global_state))))
    return ref, got, init, api


def _assert_trees(got, want, rtol=0.0):
    want_l = jax.tree_util.tree_leaves_with_path(want)
    have = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_l) == len(have)
    for path, leaf in want_l:
        np.testing.assert_allclose(np.asarray(have[path]), np.asarray(leaf),
                                   atol=TOL, rtol=rtol, err_msg=str(path))


# -- server optimizers ------------------------------------------------------

@pytest.mark.parametrize("name", OPTIMIZERS)
def test_server_optimizer_matches_optax(name):
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jtx = jfedopt.get_server_optimizer(name, 0.1, momentum=0.9)
    tx = fedopt.get_server_optimizer(name, 0.1, momentum=0.9)
    jp, jstate = params, jtx.init(params)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    tstate = tx.init(tp)
    for _ in range(5):
        # sign changes and zeros exercise yogi's sign and adagrad's where
        g = rng.normal(size=(6, 5)).astype(np.float32)
        g[0] = 0.0
        grads = {"w": g, "b": rng.normal(size=(5,)).astype(np.float32)}
        upd, jstate = jtx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = tx.update({k: torch.as_tensor(v)
                                for k, v in grads.items()}, tstate, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    flat = dict(jax.tree_util.tree_leaves_with_path(_np(jstate[0])))
    for path, leaf in flat.items():
        field = path[0].name
        got = (tstate[field] if field == "count"
               else tstate[field][path[1].key])
        np.testing.assert_allclose(np.asarray(got), leaf, rtol=1e-6,
                                   atol=1e-7)


def test_server_optimizer_names_and_defaults():
    assert isinstance(fedopt.get_server_optimizer("FedAvgM", 1.0),
                      fedopt.ServerSGD)
    adam = fedopt.get_server_optimizer("fedadam", 1.0)
    assert (adam.b1, adam.b2, adam.eps) == (0.9, 0.99, 1e-3)
    assert fedopt.get_server_optimizer("adagrad", 1.0).eps == 1e-3
    yogi = fedopt.get_server_optimizer("fedyogi", 1.0)
    assert (yogi.b2, yogi.eps, yogi.init_value) == (0.999, 1e-3, 1e-6)
    with pytest.raises(ValueError, match="unknown server optimizer"):
        fedopt.get_server_optimizer("lamb", 1.0)


# -- FedOpt -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["lr"])
def test_fedadam_rounds_match_jax_from_carried_state(name):
    """Round 1 from the same start, then round 2 from the reference's
    state after round 1 (global and server optimizer state carried
    over): the global state within 1e-4 after each, the server state
    within 1e-4 absolute and relative (its second moment is the squared
    pseudo-gradient: 1e-4 absolute alone would hold its large entries,
    about 15 on the CNN's dense layer, to 7e-6 relative)."""
    args = _args(1, "auto")
    args.server_optimizer, args.server_lr = "adam", 0.1
    japi, api, _, to_vars = _pair(jfedopt.FedOptAPI, fedopt.FedOptAPI,
                                  name, args)
    _, _, _, to_state, _ = _family(name)
    template = _np(japi.server_state)
    for rnd in range(2):
        if rnd:
            api.global_state = to_state(_np(japi.global_state))
            api.server_state = server_state_from_optax(
                _np(japi.server_state), to_state)
        japi.train_one_round()
        api.train_one_round()
        _assert_trees(to_vars(api.global_state), _np(japi.global_state))
        _assert_trees(server_state_to_optax(api.server_state, to_vars,
                                            template),
                      _np(japi.server_state), rtol=TOL)
    assert int(api.server_state["count"]) == 2


@pytest.mark.parametrize("client_opt,lr", [("sgd", 0.05), ("adam", 3e-4)])
def test_fedadam_lm_matches_jax_from_carried_init(client_opt, lr):
    """FedAdam (server lr 0.1, the reference main's default) on the tiny
    LM of ``test_torch_rounds_lm.py`` (d_model 32, 2 layers, 6 clients
    in waves of 4, T 20), SGD and Adam clients, 2 free rounds from the
    reference's initial weights: train losses within 1e-6 and the global
    parameters within 1.06e-4 (Adam clients: an Adam step moves an
    element whose gradient sits near 0 by up to its lr either way when
    the frameworks' fp32 sums differ in the last bit, and the server's
    Adam step carries that on)."""
    from fedml_tpu.algorithms.specs import (
        make_seq_classification_spec as jax_seq_spec)
    from fedml_tpu.data.synthetic import load_synthetic_sequences
    from fedml_tpu.models.transformer import TransformerLM as JaxLM
    from fedml_tpu_torch.algorithms.specs import (
        make_seq_classification_spec)
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                    lm_variables_to_state)
    T, V = 20, 90
    args = types.SimpleNamespace(
        client_num_in_total=6, client_num_per_round=6, comm_round=2,
        epochs=1, batch_size=4, lr=lr, wd=0.0, client_optimizer=client_opt,
        frequency_of_the_test=1, seed=0, client_chunk=4, wave_mode=1,
        device_resident="auto", device_data_cap_gb=1.0, device_dtype=None,
        server_optimizer="adam", server_lr=0.1)
    ds = load_synthetic_sequences(client_num=6, n_train=60, n_test=12,
                                  seq_len=T, vocab_size=V, seed=0)
    japi = jfedopt.FedOptAPI(ds, jax_seq_spec(
        JaxLM(vocab_size=V, n_layers=2, n_heads=2, d_model=32, max_len=T),
        jnp.zeros((1, T), jnp.int32)), args)
    api = fedopt.FedOptAPI(ds, make_seq_classification_spec(
        TransformerLM(V, n_layers=2, n_heads=2, d_model=32, max_len=T)),
        args, device="cpu")
    init = _np(japi.global_state)
    api.global_state = lm_variables_to_state(init)
    ref, got, _, _ = _train_both(japi, api, init, lm_state_to_variables)
    for (rm, rs), (gm, gs) in zip(ref, got):
        np.testing.assert_allclose(gm["Train/Loss"], rm["Train/Loss"],
                                   atol=1e-6)
        have = dict(jax.tree_util.tree_leaves_with_path(gs))
        for path, leaf in jax.tree_util.tree_leaves_with_path(rs):
            np.testing.assert_allclose(have[path], leaf, atol=1.06e-4,
                                       err_msg=str(path))
    assert int(api.server_state["count"]) == 2


# -- FedNova ----------------------------------------------------------------

# (model, wave_mode, device_resident): flat, waves, vmap lanes, packed
# lanes (the CNN has a packed lowering), the host-packed round and
# bucketed streaming (its fp64 host fold)
NOVA_PATHS = [("lr", 0, "auto"), ("lr", 1, "auto"), ("lr", 2, "auto"),
              ("cnn", 3, "auto"), ("cnn", 1, "0"), ("lr", 1, "bucketed")]


@pytest.mark.parametrize("name,mode,resident", NOVA_PATHS)
def test_fednova_matches_jax_on_every_round_path(name, mode, resident):
    args = _args(mode, resident)
    if resident == "bucketed":
        args.bucket_edges, args.device_resident = "geometric", "auto"
    japi, api, init, to_vars = _pair(JaxFedNova, FedNovaAPI, name, args)
    if mode == 3:
        assert api.packed_lane_runner is not None
    if resident == "0":
        assert api.device_data is None
    if resident == "bucketed":
        assert api.bucket_runner is not None
    ns = [len(d["y"]) for d in api.train_data_local_dict.values()]
    steps = {math.ceil(n / args.batch_size) for n in ns}
    assert len(steps) > 1  # heterogeneous step counts
    check_rounds(_train_both(japi, api, init, to_vars))


def test_payload_template_probes_on_the_state_device():
    """The runners' dtype probe hands ``payload_fn`` its aux on the
    global state's device (FedNova broadcasts ``steps`` over each leaf;
    on a card a CPU aux would not mix with the params)."""
    from fedml_tpu_torch.algorithms.fednova import fednova_payload
    from fedml_tpu_torch.parallel.engine import payload_dtype_template
    state = {"params": {"w": torch.zeros(3, 2, device="meta")},
             "batch_stats": {"m": torch.zeros(2, device="meta")}}
    seen = []

    def probe(local, glob, aux):
        seen.extend(v.device for v in aux.values())
        return fednova_payload(local, glob, aux)

    dtypes = payload_dtype_template(probe, state)
    assert {d.type for d in seen} == {"meta"}
    assert dtypes == {"d": {"w": torch.float32}, "tau": torch.float32,
                      "rest": {"batch_stats": {"m": torch.float32}}}


def test_fednova_payload_folds_in_the_fp64_host_fold():
    """The nested payload (a 0-d ``tau`` a client) through
    ``fold_entries_fp64``: bitwise the reference's fold."""
    from fedml_tpu.program.aggregation import fold_entries_fp64 as jfold
    from fedml_tpu_torch.algorithms.fednova import fednova_payload
    from fedml_tpu_torch.program.aggregation import fold_entries_fp64
    rng = np.random.default_rng(0)
    g = {"params": {"w": torch.as_tensor(rng.normal(size=(3, 2))
                                         .astype(np.float32))}}
    entries = []
    for k, steps in enumerate((3, 7, 1)):
        lo = {"params": {"w": g["params"]["w"] + k + 0.5}}
        pay = fednova_payload(lo, g, {"steps": torch.tensor(steps)})
        pay = jax.tree.map(lambda t: t.numpy(), pay)
        entries.append((k, float(10 + k), pay, float(10 + k)))
    got, gt = fold_entries_fp64(entries)
    want, wt = jfold(entries)
    assert gt == wt
    for k in ("tau",):
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
    assert got["d"]["w"].tobytes() == np.asarray(want["d"]["w"]).tobytes()


# -- robust FedAvg ----------------------------------------------------------

def test_robust_fedavg_without_noise_matches_jax():
    """Clip radius 0.05 (it binds: the CNN's updates are longer),
    stddev 0, the first client poisoned; rounds and the backdoor
    accuracy within 1e-4."""
    args = _args(1, "auto")
    args.norm_bound, args.stddev = 0.05, 0.0
    ds, _, _, _, _ = _family("cnn")
    ds, ptest = poison.poison_federated_dataset(ds, [0], 0.5, 0, seed=0)
    japi, api, init, to_vars = _pair(
        JaxRobust, FedAvgRobustAPI, "cnn", args,
        jkw={"poisoned_test_data": ptest}, tkw={"poisoned_test_data": ptest},
        ds=ds)
    run = _train_both(japi, api, init, to_vars)
    check_rounds(run)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(run[1][0][1]), jax.tree.leaves(init)))
    np.testing.assert_allclose(api.evaluate_backdoor()["Backdoor/Acc"],
                               japi.evaluate_backdoor()["Backdoor/Acc"],
                               atol=TOL)
    assert moved <= 0.05 + 1e-6  # the clip bounds every coordinate's move


def test_robust_noise_has_its_stated_distribution():
    """The port alone (JAX's noise stream cannot be reproduced): the
    server hook's noise on a 0-state has mean 0 and std ``stddev`` within
    3 standard errors, skips ``batch_stats``, and repeats per seed."""
    stddev, n = 0.025, 200_000
    state = {"params": {"a": torch.zeros(n // 2), "b": torch.zeros(n // 2)},
             "batch_stats": {"m": torch.zeros(8)}}
    _, server_fn = make_robust_hooks(30.0, stddev)
    out, _ = server_fn(state, state, (), 1234)
    x = torch.cat([out["params"]["a"], out["params"]["b"]]).double()
    se_mean, se_std = stddev / math.sqrt(n), stddev / math.sqrt(2 * n)
    assert abs(float(x.mean())) <= 3 * se_mean
    assert abs(float(x.std()) - stddev) <= 3 * se_std
    assert torch.equal(out["batch_stats"]["m"], state["batch_stats"]["m"])
    again, _ = server_fn(state, state, (), 1234)
    assert torch.equal(again["params"]["a"], out["params"]["a"])
    assert not torch.equal(out["params"]["a"], out["params"]["b"])


def test_poison_federated_dataset_is_byte_equal():
    ds = load_synthetic_images(client_num=4, n_train=120, n_test=30,
                               image_size=H, seed=1)
    for pattern in ("corner", "cross"):
        got, gtest = poison.poison_federated_dataset(ds, [0, 2], 0.5, 3,
                                                     pattern=pattern,
                                                     seed=5)
        want, wtest = jpoison.poison_federated_dataset(ds, [0, 2], 0.5, 3,
                                                       pattern=pattern,
                                                       seed=5)
        for c in range(4):
            for k in ("x", "y"):
                assert got[5][c][k].tobytes() == want[5][c][k].tobytes()
                assert got[5][c][k].dtype == want[5][c][k].dtype
        for k in ("x", "y"):
            assert gtest[k].tobytes() == wtest[k].tobytes()
    assert poison.poison_client_data(ds[5][1], 0.0, 3) is ds[5][1]


# -- hierarchical -----------------------------------------------------------

@pytest.mark.parametrize("groups", [2, 3])
def test_hierarchical_matches_jax(groups):
    """Two groups of two, and three uneven groups ([0, 3], [1], [2]:
    padded with empty clients), two sub-rounds a round."""
    args = _args(1, "auto")
    args.group_num, args.group_comm_round = groups, 2
    assert (max(map(len, round_robin_groups(range(4), groups)))
            != min(map(len, round_robin_groups(range(4), groups)))) \
        == (groups == 3)
    japi, api, init, to_vars = _pair(JaxHierarchical, HierarchicalFedAvgAPI,
                                     "lr", args)
    check_rounds(_train_both(japi, api, init, to_vars))


# -- centralized ------------------------------------------------------------

def test_centralized_matches_jax():
    args = _args(1, "auto")
    ds, jspec, tspec, to_state, to_vars = _family("lr")
    jtr = JaxCentralized(ds, jspec, args)
    tr = CentralizedTrainer(ds, tspec, args, device="cpu")
    init = _np(jtr.global_state)
    tr.global_state = to_state(init)
    check_rounds(_train_both(jtr, tr, init, to_vars))


def test_full_batch_fedavg_equals_centralized():
    """Full batch, one epoch, every client: FedAvg's weighted mean of
    the clients' steps is the pooled step (3 rounds, 1e-4)."""
    ds = jax_load_federated(client_num=8, partition="homo", seed=0)
    spec = make_classification_spec(LogisticRegression(60, 10))
    args = types.SimpleNamespace(
        client_num_in_total=8, client_num_per_round=8, comm_round=3,
        epochs=1, batch_size=-1, lr=0.5, client_optimizer="sgd", wd=0.0,
        frequency_of_the_test=100, ci=0, seed=0)
    fed = FedAvgAPI(ds, spec, args, device="cpu")
    fed.train()
    cen = CentralizedTrainer(ds, spec, args, device="cpu")
    cen.train()
    for k, v in fed.global_state["params"].items():
        np.testing.assert_allclose(v.numpy(),
                                   cen.global_state["params"][k].numpy(),
                                   atol=TOL)
    assert abs(fed.evaluate_global()["Test/Acc"]
               - cen.evaluate_global()["Test/Acc"]) < 1e-3


# -- the experiment mains ---------------------------------------------------

IMAGES = ["--dataset", "synthetic_images", "--model", "cnn", "--image_size",
          "8", "--n_train", "160", "--n_test", "32", "--client_num_in_total",
          "4", "--client_num_per_round", "4", "--batch_size", "16"]
MAINS = {"fedopt": (main_fedopt, []),
         "fednova": (main_fednova, []),
         "fedavg_robust": (main_fedavg_robust, IMAGES),
         "hierarchical": (main_hierarchical, []),
         "centralized": (main_centralized, [])}


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_parser_defaults_are_the_reference_ones(name, monkeypatch):
    import importlib
    jmain = importlib.import_module(f"fedml_tpu.experiments.main_{name}")

    def stop(args, run_name=None):
        raise _Parsed(args)

    monkeypatch.setattr(jcommon, "setup", stop)
    with pytest.raises(_Parsed) as parsed:
        jmain.main([])
    want = vars(parsed.value.args[0])
    got = vars(MAINS[name][0].parser().parse_args([]))
    assert got == want


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_one_round_on_the_cpu(name):
    module, argv = MAINS[name]
    api, state = module.main(argv + ["--platform", "cpu", "--comm_round",
                                     "1"])
    assert api.device.type == "cpu" and api.round_idx == 1
    assert all(math.isfinite(m["Train/Loss"]) for m in api.history)
    assert "Test/Loss" in api.history[-1]
    if name == "fedavg_robust":
        assert 0.0 <= api.evaluate_backdoor()["Backdoor/Acc"] <= 1.0


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_quick_start_runs_each_server_optimizer(opt):
    api, _ = main_fedopt.main(["--dataset", "synthetic", "--model", "lr",
                               "--platform", "cpu", "--comm_round", "1",
                               "--server_optimizer", opt])
    assert isinstance(api.server_tx, type(
        fedopt.get_server_optimizer(opt, 0.1)))
    assert math.isfinite(api.history[-1]["Train/Loss"])


@pytest.mark.parametrize("name", sorted(MAINS))
@pytest.mark.parametrize("flag,value,item", [
    ("--race_audit", "1", "A16"), ("--transport", "eventloop", "A13")])
def test_main_refuses_resilience_flags(name, flag, value, item):
    """The resilience group's flags whose paths are still unported (the
    race audit, the distributed transports) refuse on every main;
    ``--overselect``, ``--straggler_p``, ``--quorum``, ``--deadline`` and
    ``--pace_*`` run (``test_torch_resilience.py``), as does
    ``--async_agg`` (``test_torch_async_agg.py``)."""
    module, argv = MAINS[name]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        module.main(argv + ["--platform", "cpu", flag, value])


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = MAINS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv + ["--comm_round", "1"])


def test_parsers_differ_only_by_their_algorithm_flags():
    base = set(vars(jcommon.add_base_args(argparse.ArgumentParser())
                    .parse_args([])))
    extra = {name: set(vars(m.parser().parse_args([]))) - base
             for name, (m, _) in MAINS.items()}
    assert extra == {
        "fedopt": {"server_optimizer", "server_lr", "server_momentum"},
        "fednova": set(), "centralized": set(),
        "fedavg_robust": {"norm_bound", "stddev", "poison_type",
                          "poison_frac", "target_label", "adversary_num"},
        "hierarchical": {"group_num", "group_comm_round"}}
