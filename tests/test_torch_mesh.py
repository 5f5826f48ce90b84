"""The port's client-sharded rounds (``parallel/mesh.py``,
``parallel/engine.py`` ``make_sharded_round`` and ``ShardedLaneRunner``,
``FedAvgAPI(mesh=)``, ``compile_sim(mesh=)``) against the reference's.

The port's side runs in one spawned gloo group of 2 and of 4 ranks
(``tests/torch_dist.py``, one torch thread a rank); the reference's side
runs in this process on conftest's forced CPU devices, on a mesh of the
same size. The cases are the reference's ``tests/test_engine.py``
sharded cases (``:114`` sim == sharded, ``:135`` several clients a
shard, ``:301`` sharded lanes == flat, ``:330`` a subset cohort with
server hooks, ``:533`` the API's mesh lanes == its classic mesh round)
on LR, the port starting from the reference's initial weights carried
over and both sides packing with numpy (``FEDML_TPU_PACKING=python``).
Every port result is held to the port's own single-device round within
the reference's 1e-5 (2e-5 for the lanes, 5e-5 for the API's two paths,
as there) and to the reference's result within 1e-5; the ranks' results
are replicated, so every rank returns the same state. The one-rank mesh
cases run in this process."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
import torch_dist_cases as cases
from fedml_tpu import models
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.core import pytree
from fedml_tpu.data import load_synthetic_federated
from fedml_tpu.parallel.engine import (ClientUpdateConfig as JaxCfg,
                                       ShardedLaneRunner as JaxLanes,
                                       make_sharded_round as jax_sharded)
from fedml_tpu.parallel.mesh import make_client_mesh as jax_mesh
from fedml_tpu.parallel.mesh import pad_cohort_to_multiple as jax_pad
from fedml_tpu.parallel.multihost import global_cohort as jax_global
from fedml_tpu.parallel.packing import pack_cohort as jax_pack
from fedml_tpu.parallel.packing import pack_schedule as jax_schedule
from fedml_tpu.parallel.packing import stack_clients as jax_stack
from fedml_tpu_torch.parallel import mesh as pmesh
from fedml_tpu_torch.utils.torch_import import cv_state_to_variables

TOL = 1e-5
SIZES = (16, 8, 24, 12, 16, 8, 8, 20)
LANE_SIZES = (40, 8, 24, 16, 5, 31, 12, 9, 27, 14, 6)


@pytest.fixture(scope="module", params=[2, 4])
def group(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    g = torch_dist.RankGroup(request.param,
                             env={"FEDML_TPU_PACKING": "python"})
    try:
        yield g
    finally:
        g.close()
        mp.undo()


def _ref_mesh(n):
    return jax_mesh(n, devices=jax.devices()[:n])


def _lr():
    return jax_spec(models.LogisticRegression(num_classes=10,
                                              apply_sigmoid=False),
                    jnp.zeros((1, 60)))


def _init(seed):
    return jax.tree.map(np.array, _lr().init_fn(jax.random.PRNGKey(seed)))


def _vars(state_np):
    return cv_state_to_variables(
        {part: {k: torch.as_tensor(v) for k, v in leaves.items()}
         for part, leaves in state_np.items()})


def _close(port_np, ref, tol=TOL):
    got = dict(jax.tree_util.tree_leaves_with_path(_vars(port_np)))
    want = jax.tree_util.tree_leaves_with_path(ref)
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=tol)


def _same_on_every_rank(outs, key=None):
    pick = (lambda o: o[key]) if key is not None else (lambda o: o)
    first = jax.tree.leaves(pick(outs[0]))
    for o in outs[1:]:
        for a, b in zip(first, jax.tree.leaves(pick(o))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sizes", [SIZES, (8,) * 16],
                         ids=["sim_equals_sharded",
                              "multiple_clients_per_shard"])
def test_sharded_round_matches_sim_and_reference(group, sizes):
    n = group.n
    init = _init(7)
    outs = group.run(cases.sharded_round_lr, init, sizes, 3, 0.3, 5)
    _same_on_every_rank(outs, "sharded")
    out = outs[0]
    _close(out["sharded"], _vars(out["sim"]))
    assert out["count"] == sum(sizes)
    assert out["blocks"] == -(-len(sizes) // n)
    mesh = _ref_mesh(n)
    packed = jax_pack(cases.lr_clients(sizes, 3), batch_size=8, epochs=1)
    ref, _, _ = jax_sharded(_lr(), JaxCfg(lr=0.3), mesh)(
        jax.tree.map(jnp.asarray, init), (), jax_global(mesh, packed),
        jax.random.PRNGKey(5))
    _close(out["sharded"], ref)


def _ref_hooks():
    """The reference test's FedOpt-style hooks (``test_engine.py:337``)."""
    def payload_fn(local_state, global_state, aux):
        return pytree.tree_sub(global_state["params"], local_state["params"])

    def server_fn(global_state, avg_delta, server_state, rng):
        new = dict(global_state)
        new["params"] = pytree.tree_sub(global_state["params"],
                                        pytree.tree_scale(avg_delta, 0.5))
        return new, server_state

    return payload_fn, server_fn


@pytest.mark.parametrize("subset", [False, True],
                         ids=["sharded_lanes_equal_flat",
                              "subset_cohort_with_hook"])
def test_sharded_lanes_match_flat_and_reference(group, subset):
    n = group.n
    if subset:
        sizes, cohort, ns, epochs, sseed, rseed = (
            (10, 40, 6, 28, 18, 22, 9, 33), [1, 6, 2], [40, 9, 6], 1, 5, 9)
    else:
        sizes, cohort, epochs, sseed, rseed = (
            LANE_SIZES, list(range(len(LANE_SIZES))), 2, 1, 3)
        ns = list(sizes)
    init = _init(0)
    outs = group.run(cases.sharded_lanes_lr, init, sizes, 0, cohort, ns,
                     epochs, sseed, rseed, subset)
    _same_on_every_rank(outs, "lanes")
    out = outs[0]
    _close(out["lanes"], _vars(out["flat"]), 2e-5)
    assert out["count"] == (sum(ns) * epochs)
    mesh = _ref_mesh(n)
    payload_fn, server_fn = _ref_hooks() if subset else (None, None)
    stacked = jax_stack(cases.lr_clients(sizes, 0))
    placed = jax_global(mesh, {"x": stacked["x"], "y": stacked["y"]})
    sched = jax_schedule(ns, 8, epochs=epochs,
                         rng=np.random.default_rng(sseed))
    spec = _lr()
    ref, _, info = JaxLanes(spec, JaxCfg(lr=0.2), mesh, payload_fn,
                            server_fn, n_lanes=2).run_round(
        jax.tree.map(jnp.asarray, init), (), placed, cohort, sched,
        jax.random.PRNGKey(rseed))
    assert float(np.asarray(info["metrics"]["count"])) == out["count"]
    _close(out["lanes"], ref)


def test_api_mesh_lanes_match_classic_mesh_path(group):
    """``FedAvgAPI(mesh=)`` with ``wave_mode=2`` (resident rows sharded
    over the ranks, lanes) against ``wave_mode=1`` (the host-packed
    sharded round), 2 rounds each, and both against the reference's API
    on a mesh of the same size."""
    n = group.n
    init = _init(0)
    classic = group.run(cases.api_mesh_rounds, init, 1)
    lanes = group.run(cases.api_mesh_rounds, init, 2)
    _same_on_every_rank([o[0] for o in lanes])
    assert lanes[0][2] and not classic[0][2]
    _close(lanes[0][0], _vars(classic[0][0]), 5e-5)
    ds = load_synthetic_federated(client_num=8, n_train=640, n_test=160,
                                  seed=0)
    args = types.SimpleNamespace(
        client_num_per_round=8, comm_round=2, epochs=1, batch_size=16,
        lr=0.3, client_optimizer="sgd", wd=0.0, frequency_of_the_test=100,
        ci=0, seed=0, wave_mode=2, client_chunk=2, device_resident="auto")
    japi = JaxFedAvgAPI(ds, _lr(), args, mesh=_ref_mesh(n))
    japi.global_state = jax.tree.map(jnp.asarray, init)
    for _ in range(2):
        japi.train_one_round()
    _close(lanes[0][0], japi.global_state)
    for got, want in zip(lanes[0][1], japi.history):
        for key in ("Train/Loss", "Train/Acc"):
            np.testing.assert_allclose(got[key], want[key], atol=TOL)


def test_padding_helpers_match_the_reference():
    rng = np.random.default_rng(0)
    cohort = {"x": rng.normal(size=(5, 3, 2)).astype(np.float32),
              "n": np.arange(5, dtype=np.float32)}
    for multiple in (1, 2, 4, 8):
        got = pmesh.pad_cohort_to_multiple(cohort, multiple)
        want = jax_pad(cohort, multiple)
        for k in cohort:
            np.testing.assert_array_equal(got[k], want[k])
    t = {"a": torch.ones(2, 3), "b": (torch.zeros(2),)}
    padded = pmesh.zero_pad_leading(t, 3)
    assert padded["a"].shape == (5, 3) and padded["b"][0].shape == (5,)
    assert float(padded["a"][2:].abs().sum()) == 0.0
    assert pmesh.zero_pad_leading(t, 0) is t


def test_one_rank_mesh_in_process():
    """A mesh of one rank forms a one-rank gloo group here: ``--mesh 1``
    runs through the same collective calls, the sharded round over it
    equals the single-device round, ``compile_sim(mesh=)`` lowers to it,
    and a mesh wider than the world raises the reference's message."""
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 make_sim_round)
    from fedml_tpu_torch.parallel.packing import pack_cohort
    from fedml_tpu_torch.program.round import RoundProgram

    mesh = pmesh.make_client_mesh(1, device="cpu")
    assert mesh.shape == {"clients": 1, "model": 1}
    assert mesh.device == torch.device("cpu") and mesh.index("clients") == 0
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        pmesh.make_client_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 1"):
        pmesh.make_2d_mesh(2, 2, ("data", "seq"), device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        init = _init(7)
        spec, cfg = cases._lr_spec(), ClientUpdateConfig(lr=0.3)
        sharded = RoundProgram().compile_sim(spec, cfg, mesh=mesh)
        packed = pack_cohort(cases.lr_clients(SIZES, 3), batch_size=8,
                             epochs=1)
        got, _, info = sharded(cases._lr_state(init), (), packed, 5)
        assert info["metrics"].total == len(SIZES)
        dev = {k: torch.as_tensor(v) for k, v in packed.items()}
        dev["y"] = dev["y"].long()
        want, _, _ = make_sim_round(spec, cfg)(cases._lr_state(init), (),
                                               dev, 5)
        for k in want["params"]:
            torch.testing.assert_close(got["params"][k], want["params"][k],
                                       atol=TOL, rtol=0)
    finally:
        mp.undo()


def test_api_refuses_compressor_and_buckets_on_a_mesh():
    """The reference's refusals, with its messages."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.data.synthetic import load_synthetic_federated

    ds = load_synthetic_federated(client_num=4, n_train=80, n_test=16,
                                  seed=0)
    mesh = pmesh.make_client_mesh(1, device="cpu")
    base = dict(client_num_per_round=4, comm_round=1, epochs=1,
                batch_size=16, lr=0.1, client_optimizer="sgd", wd=0.0,
                frequency_of_the_test=1, seed=0)
    with pytest.raises(ValueError, match="mesh rounds aggregate"):
        FedAvgAPI(ds, cases._lr_spec(),
                  types.SimpleNamespace(**base, compressor="topk:0.1"),
                  mesh=mesh)
    with pytest.raises(ValueError, match="does not compose with --mesh"):
        FedAvgAPI(ds, cases._lr_spec(),
                  types.SimpleNamespace(**base, bucket_edges="geometric"),
                  mesh=mesh)
    with pytest.raises(ValueError, match="not the mesh's"):
        FedAvgAPI(ds, cases._lr_spec(), types.SimpleNamespace(**base),
                  mesh=mesh, device="meta")
    api = FedAvgAPI(ds, cases._lr_spec(), types.SimpleNamespace(**base),
                    mesh=mesh)
    assert api.device == torch.device("cpu")
    rec = api.train_one_round()
    assert np.isfinite(rec["Train/Loss"])
