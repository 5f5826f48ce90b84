"""The port's gossip algorithms against the JAX package's, on the CPU.

- The topology managers: ``W`` bit-equal (and the neighbor lists equal)
  for n in {4, 6, 8}, neighbor_num in {2, 3} and seeds {0, 7}, for both
  managers.
- ``mix_states`` within 1e-6.
- ``DecentralizedFedAPI``: DSGD and PushSum on LR over 6 nodes, 2 rounds
  from the reference's initial weights carried over, both sides packing
  with numpy: node states and ``pushsum_w`` within 1e-5, the round
  records within 1e-5; compressed gossip (``topk:0.25``) the same, with
  ``bytes_on_wire`` and ``compression_ratio`` equal.
- ``DecentralizedOnlineAPI``: DSGD and PushSum at T 200, time-varying,
  with the reference's ``jax.random`` permutations handed in: ``w``
  within 1e-5, the average loss, accuracy and regret within 1e-6
  relative, and the final consensus (a difference of node models that
  agree to 1e-5) within 1e-7.
- The reference's scenarios: ``test_decentralized_online.py`` retargeted
  at the port (run on the CPU through ``args.device``) where its
  imports allow, and counterparts with the same asserts of its two
  JAX-bound cases, of ``test_algorithms.py::TestDecentralized`` and of
  ``test_compression.py``'s ``test_decentralized_compressed_round``.
- ``main_decentralized``'s command line of ``test_experiments.py`` and
  the online one, through the port with ``--platform cpu``.
"""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_scenarios import retarget

from fedml_tpu import models as jmodels
from fedml_tpu.algorithms.decentralized import (
    DecentralizedFedAPI as JaxDecentralizedFedAPI)
from fedml_tpu.algorithms.decentralized import mix_states as jax_mix_states
from fedml_tpu.algorithms.decentralized_online import (
    DecentralizedOnlineAPI as JaxOnlineAPI)
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.core import topology as jtopology
from fedml_tpu.data import load_synthetic_federated
from fedml_tpu_torch.algorithms.decentralized import (DecentralizedFedAPI,
                                                      mix_states)
from fedml_tpu_torch.algorithms.decentralized_online import (
    DecentralizedOnlineAPI)
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.core import topology
from fedml_tpu_torch.data import uci
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

TOL = 1e-5

# -- the reference's own online cases, through the port ----------------------
_online = retarget("test_decentralized_online.py")
_ref_args = _online._args
# the port's APIs run on the card unless asked: the scenarios ask for the CPU
_online._args = lambda **kw: _ref_args(device="cpu", **kw)
test_dsgd_learns_separable_stream = _online.test_dsgd_learns_separable_stream
test_regret_matches_cal_regret_normalization = \
    _online.test_regret_matches_cal_regret_normalization
test_dsgd_push_mixing_is_column_application = \
    _online.test_dsgd_push_mixing_is_column_application
test_pushsum_directed_reaches_consensus = \
    _online.test_pushsum_directed_reaches_consensus
test_time_varying_topology_runs = _online.test_time_varying_topology_runs


def test_the_retargeted_scenarios_run_the_port():
    assert _online.DecentralizedOnlineAPI is DecentralizedOnlineAPI
    assert _online.uci is uci


def _oargs(**kw):
    base = dict(lr=0.3, seed=0, topology_neighbors=2, time_varying=False,
                device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_second_half_beats_first_half():
    """The reference's regret sanity case: the online loss falls over
    the horizon."""
    streams = uci.load_synthetic_stream(client_num=4, T=400, d=8, seed=1)
    api = DecentralizedOnlineAPI(streams, _oargs(), algorithm="dsgd")
    _, _, losses, _ = api.run(torch.zeros(api.n_nodes, api.d),
                              torch.ones(api.n_nodes))
    losses = losses.numpy()
    T = losses.shape[0]
    assert losses[T // 2:].mean() < losses[:T // 2].mean()


def test_online_cli():
    from fedml_tpu_torch.experiments import main_decentralized
    api, w = main_decentralized.main(
        ["--online", "1", "--algorithm", "pushsum", "--lr", "0.2",
         "--client_num_in_total", "4", "--stream_length", "100",
         "--dataset", "susy", "--platform", "cpu"])
    assert np.isfinite(w).all()
    assert "Online/Regret" in api.history


# -- topology ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("neighbor_num", [2, 3])
@pytest.mark.parametrize("n", [4, 6, 8])
@pytest.mark.parametrize("kind", ["Symmetric", "Asymmetric"])
def test_topology_is_the_reference(kind, n, neighbor_num, seed):
    name = f"{kind}TopologyManager"
    got = getattr(topology, name)(n, neighbor_num=neighbor_num, seed=seed)
    want = getattr(jtopology, name)(n, neighbor_num=neighbor_num, seed=seed)
    W = got.generate_topology()
    assert W.dtype == want.generate_topology().dtype
    np.testing.assert_array_equal(W, want.topology)
    for i in range(n):
        assert got.get_in_neighbor_idx_list(i) == \
            want.get_in_neighbor_idx_list(i)
        assert got.get_out_neighbor_idx_list(i) == \
            want.get_out_neighbor_idx_list(i)
        assert got.get_out_neighbor_weights(i) == \
            want.get_out_neighbor_weights(i)


def test_core_exports_the_managers():
    import fedml_tpu_torch.core as core
    assert core.SymmetricTopologyManager is topology.SymmetricTopologyManager
    assert core.AsymmetricTopologyManager is \
        topology.AsymmetricTopologyManager
    with pytest.raises(NotImplementedError):
        core.BaseTopologyManager().generate_topology()


def test_mix_states_is_the_reference():
    W = topology.AsymmetricTopologyManager(8, neighbor_num=3,
                                           seed=0).generate_topology()
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(8, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}
    want = jax_mix_states(tree, W)
    got = mix_states({k: torch.as_tensor(v) for k, v in tree.items()},
                     torch.as_tensor(W, dtype=torch.float32))
    for k in tree:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)


# -- DecentralizedFedAPI against the reference ---------------------------------

def _fed_args(**kw):
    base = dict(client_num_per_round=6, comm_round=2, epochs=1,
                batch_size=16, lr=0.3, client_optimizer="sgd", wd=0.0,
                frequency_of_the_test=100, ci=0, seed=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _dataset(clients=6, n=600):
    return load_synthetic_federated(client_num=clients, n_train=n,
                                    n_test=n // 4, alpha=0.0, beta=0.0,
                                    seed=0)


def _spec():
    return make_classification_spec(LogisticRegression(60, 10,
                                                       apply_sigmoid=False))


def _jax_spec():
    return jax_spec(jmodels.LogisticRegression(num_classes=10,
                                               apply_sigmoid=False),
                    jnp.zeros((1, 60)))


def _gossip_pair(algorithm, compressor=None, asymmetric=False):
    """Both APIs for 2 rounds on the same 6 LR nodes from the reference's
    init; returns ``(reference api, port api)``."""
    ds = _dataset()
    kw = {} if compressor is None else {"compressor": compressor}
    mgr = "AsymmetricTopologyManager" if asymmetric \
        else "SymmetricTopologyManager"
    japi = JaxDecentralizedFedAPI(
        ds, _jax_spec(), _fed_args(**kw),
        topology=getattr(jtopology, mgr)(6, neighbor_num=3, seed=0),
        algorithm=algorithm)
    api = DecentralizedFedAPI(
        ds, _spec(), _fed_args(**kw),
        topology=getattr(topology, mgr)(6, neighbor_num=3, seed=0),
        algorithm=algorithm, device="cpu")
    api.states = cv_variables_to_state(
        jax.tree.map(np.array, japi.states), lead=1)
    for _ in range(2):
        japi.train_one_round()
        api.train_one_round()
    return japi, api


@pytest.fixture(scope="module")
def gossip_runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        return {"dsgd": _gossip_pair("dsgd"),
                "pushsum": _gossip_pair("pushsum", asymmetric=True),
                "dsgd_topk": _gossip_pair("dsgd", compressor="topk:0.25"),
                "pushsum_topk": _gossip_pair("pushsum", compressor="topk:0.25",
                                             asymmetric=True)}
    finally:
        mp.undo()


def _same_states(japi, api):
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.array, japi.states))
    have = dict(jax.tree_util.tree_leaves_with_path(
        cv_state_to_variables(api.states, lead=1)))
    assert len(want) == len(have)
    for path, leaf in want:
        np.testing.assert_allclose(have[path], leaf, atol=TOL)


@pytest.mark.parametrize("case", ["dsgd", "pushsum", "dsgd_topk",
                                  "pushsum_topk"])
def test_gossip_rounds_are_the_reference(gossip_runs, case):
    japi, api = gossip_runs[case]
    np.testing.assert_array_equal(api.W.numpy(), japi.W)
    _same_states(japi, api)
    np.testing.assert_allclose(api.pushsum_w.numpy(),
                               np.asarray(japi.pushsum_w), atol=TOL)
    assert len(api.history) == len(japi.history) == 2
    for got, want in zip(api.history, japi.history):
        assert sorted(got) == sorted(want)
        for k in ("Train/Loss", "Train/Acc"):
            np.testing.assert_allclose(got[k], want[k], atol=TOL)
        if "bytes_on_wire" in want:
            assert got["bytes_on_wire"] == want["bytes_on_wire"]
            assert got["compression_ratio"] == want["compression_ratio"]
    np.testing.assert_allclose(api.consensus_distance(),
                               japi.consensus_distance(), rtol=1e-4)
    for i in (0, 5):
        node = api.node_state(i)["params"]
        for k, v in node.items():
            np.testing.assert_array_equal(v.numpy(),
                                          api.states["params"][k][i].numpy())


def test_pushsum_weights_moved(gossip_runs):
    _, api = gossip_runs["pushsum"]
    # a directed W that is not doubly stochastic: the de-biasing counts
    assert not np.allclose(api.pushsum_w.numpy(), 1.0)
    W = api.W.numpy().astype(np.float64)
    np.testing.assert_allclose(api.pushsum_w.numpy(),
                               W @ (W @ np.ones(6)), rtol=1e-6)


# -- counterparts of the reference's TestDecentralized -------------------------

def test_mixing_preserves_average():
    tm = topology.SymmetricTopologyManager(8, neighbor_num=3, seed=0)
    W = torch.as_tensor(tm.generate_topology(), dtype=torch.float32)
    states = {"w": torch.as_tensor(
        np.random.default_rng(0).normal(size=(8, 5)), dtype=torch.float32)}
    mixed = mix_states(states, W)
    # doubly stochastic is not guaranteed, but mixing must contract spread
    assert float(mixed["w"].var(dim=0, unbiased=False).mean()) < float(
        states["w"].var(dim=0, unbiased=False).mean())


def test_dsgd_consensus_contracts():
    api = DecentralizedFedAPI(_dataset(), _spec(),
                              _fed_args(comm_round=4, lr=0.1), device="cpu")
    api.train_one_round()
    d1 = api.consensus_distance()
    for _ in range(3):
        api.train_one_round()
    d2 = api.consensus_distance()
    assert np.isfinite(d1) and np.isfinite(d2)
    assert d2 < max(d1, 1.0)  # gossip keeps nodes near consensus


def test_pushsum_runs():
    tm = topology.AsymmetricTopologyManager(6, neighbor_num=3, seed=0)
    api = DecentralizedFedAPI(_dataset(), _spec(),
                              _fed_args(comm_round=2, lr=0.1), topology=tm,
                              algorithm="pushsum", device="cpu")
    # the PushSum matrix is column-stochastic (senders split their mass)
    np.testing.assert_allclose(api.W.numpy().sum(axis=0), np.ones(6),
                               rtol=1e-5)
    api.train()
    assert not np.allclose(api.pushsum_w.numpy(), 1.0)
    assert np.isfinite(api.consensus_distance())
    assert all(torch.isfinite(v).all() for v in api.states["params"].values())


def test_pushsum_debias_recovers_uniform_average():
    # pure gossip (lr 0, no local drift): the de-biased states approach
    # the UNIFORM average of the initial states whatever the directed
    # topology's stationary distribution
    tm = topology.AsymmetricTopologyManager(6, neighbor_num=3, seed=0)
    api = DecentralizedFedAPI(_dataset(), _spec(),
                              _fed_args(comm_round=1, lr=0.0), topology=tm,
                              algorithm="pushsum", device="cpu")
    gen = torch.Generator().manual_seed(0)
    api.states = {"params": {k: v + torch.randn(v.shape, generator=gen)
                             for k, v in api.states["params"].items()}}
    target = {k: v.mean(dim=0) for k, v in api.states["params"].items()}
    for _ in range(30):
        api.train_one_round()
    for k, v in api.states["params"].items():
        np.testing.assert_allclose(v.mean(dim=0).numpy(),
                                   target[k].numpy(), atol=2e-2)


def test_decentralized_compressed_round():
    api = DecentralizedFedAPI(_dataset(), _spec(),
                              _fed_args(compressor="topk:0.25"),
                              device="cpu")
    m1 = api.train_one_round()
    m2 = api.train_one_round()
    assert m1["bytes_on_wire"] > 0 and m1["compression_ratio"] > 1.5
    assert np.isfinite(m2["Train/Loss"])


def test_unknown_algorithm_is_refused():
    with pytest.raises(ValueError, match="gossip algorithm"):
        DecentralizedFedAPI(_dataset(), _spec(), _fed_args(),
                            algorithm="ring", device="cpu")


# -- online gossip against the reference ---------------------------------------

def _jax_perms(seed, n, T):
    """The reference's time-varying permutations: ``split`` then
    ``permutation`` a step from ``PRNGKey(seed)``."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, n)))
    return np.stack(out)


@pytest.mark.parametrize("algorithm", ["dsgd", "pushsum"])
def test_online_is_the_reference(algorithm):
    streams = uci.load_synthetic_stream(client_num=5, T=200, d=6, seed=2)
    kw = dict(lr=0.2, seed=3, topology_neighbors=3, time_varying=True)
    japi = JaxOnlineAPI(streams, types.SimpleNamespace(**kw),
                        algorithm=algorithm)
    api = DecentralizedOnlineAPI(streams, types.SimpleNamespace(**kw),
                                 algorithm=algorithm, device="cpu")
    np.testing.assert_array_equal(api.W.numpy(), np.asarray(japi.W))
    want_w = japi.train()
    got_w = api.train(perms=_jax_perms(3, 5, api.T))
    np.testing.assert_allclose(got_w, want_w, atol=TOL)
    assert sorted(api.history) == sorted(japi.history)
    for k in ("Online/AvgLoss", "Online/AvgAcc", "Online/Regret"):
        np.testing.assert_allclose(api.history[k], japi.history[k],
                                   rtol=1e-6)
    # the consensus is a difference of node models that agree to 1e-5:
    # it cancels their common part, so it is held in absolute terms
    np.testing.assert_allclose(api.history["Online/FinalConsensus"],
                               japi.history["Online/FinalConsensus"],
                               atol=1e-7)
    np.testing.assert_allclose(api.consensus_distance(),
                               japi.consensus_distance(), rtol=1e-5)


def test_online_draws_its_own_perms():
    streams = uci.load_synthetic_stream(client_num=4, T=50, d=6, seed=0)
    api = DecentralizedOnlineAPI(streams, _oargs(time_varying=True),
                                 device="cpu")
    perms = api.draw_perms()
    assert perms.shape == (50, 4)
    assert all(sorted(p) == [0, 1, 2, 3] for p in perms)
    np.testing.assert_array_equal(api.train(), api.train(perms=perms))
    fixed = DecentralizedOnlineAPI(streams, _oargs(), device="cpu")
    with pytest.raises(ValueError, match="time-varying"):
        fixed.train(perms=perms)


# -- the main ----------------------------------------------------------------------

TINY = ["--client_num_in_total", "4", "--client_num_per_round", "2",
        "--comm_round", "2", "--epochs", "1", "--batch_size", "8",
        "--frequency_of_the_test", "1", "--ci", "1"]


def test_main_decentralized():
    from fedml_tpu_torch.experiments import main_decentralized
    api, states = main_decentralized.main(
        ["--dataset", "synthetic", "--model", "lr", "--lr", "0.1",
         "--algorithm", "dsgd", "--topology_neighbors", "2",
         "--platform", "cpu"] + TINY)
    assert states is not None
    assert api.device.type == "cpu" and api.round_idx == 2


def test_main_decentralized_is_the_reference_main():
    """The same argv (PushSum on a directed topology, compressed) through
    both mains from the reference's init."""
    from fedml_tpu.experiments import main_decentralized as jmain
    from fedml_tpu_torch.experiments import main_decentralized
    argv = ["--dataset", "synthetic", "--model", "lr", "--lr", "0.1",
            "--algorithm", "pushsum", "--asymmetric", "1",
            "--topology_neighbors", "3", "--compressor", "topk:0.25",
            "--client_num_in_total", "5", "--comm_round", "1",
            "--batch_size", "16"]
    inits = []
    jorig, orig = JaxDecentralizedFedAPI.__init__, DecentralizedFedAPI.__init__

    def jinit(self, *a, **kw):
        jorig(self, *a, **kw)
        inits.append(jax.tree.map(np.array, self.states))

    def init(self, *a, **kw):
        # the port main trains from the reference's initial weights
        orig(self, *a, **kw)
        self.states = cv_variables_to_state(inits[0], lead=1)
        inits.append(self)

    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    mp.setattr(JaxDecentralizedFedAPI, "__init__", jinit)
    mp.setattr(DecentralizedFedAPI, "__init__", init)
    try:
        japi, _ = jmain.main(argv + ["--platform", "cpu"])
        api, _ = main_decentralized.main(argv + ["--platform", "cpu"])
    finally:
        mp.undo()
    assert inits[1] is api
    np.testing.assert_array_equal(api.W.numpy(), japi.W)
    _same_states(japi, api)
    assert api.history[0]["bytes_on_wire"] == japi.history[0]["bytes_on_wire"]


@pytest.mark.parametrize("argv, match", [
    (["--mesh", "2"], "A15"),
    (["--audit", "1"], "not wired"),
])
def test_main_decentralized_refuses_unported_flags(argv, match, capfd):
    """``--mesh`` (ROADMAP A15) parses and, as in the reference, where
    only the FedAvg family shards its clients, the gossip main runs on
    one device; ``--audit`` runs and, as in the reference, warns that the
    gossip loop has no end-of-round sync to audit."""
    from fedml_tpu_torch.experiments import main_decentralized
    argv = argv + ["--platform", "cpu"]
    if match.startswith("A"):
        api, _ = main_decentralized.main(argv + ["--comm_round", "1"])
        assert api.args.mesh == 2 and len(api.history) == 1
        assert not hasattr(api, "mesh")
        return
    api, _ = main_decentralized.main(argv + ["--comm_round", "1"])
    # the main's logging setup writes to stderr
    assert match in capfd.readouterr().err and len(api.history) == 1
