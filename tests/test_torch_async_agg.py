"""Buffered async aggregation in the port against the JAX package: the
``BufferedAggregator`` (fold, ``fold_many``, ``ready``, overwrite,
``flush``, ``record``) bitwise on its fp32 outputs with equal counters;
the oracle (async with ``buffer_k`` = cohort and staleness decay 0 is
the synchronous bucketed round bit for bit); an LR bucketed round of 40
ragged clients (chunks of 4, ``buffer_k`` 8, decay 0.5, window 4) over
2 rounds against the JAX ``FedAvgAPI`` from the same initial weights,
every ``async/*`` counter equal and the parameters within 1e-5; and
``main_fedavg``/``main_fedopt`` with ``--async_agg 1`` against the
reference mains, records within 1e-4. Both packages pack schedules with
numpy (``FEDML_TPU_PACKING=python``)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.program import aggregation as jagg
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.experiments import main_fedavg, main_fedopt
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.parallel.engine import (BucketedStreamRunner,
                                             ClientUpdateConfig)
from fedml_tpu_torch.program import aggregation as agg
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

ROUNDS, CLIENTS, DIM, CLASSES = 2, 40, 16, 4
ASYNC = dict(async_agg=1, buffer_k=8, staleness_decay=0.5, async_window=4)


@pytest.fixture(scope="module", autouse=True)
def _numpy_packing():
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    yield
    mp.undo()


def _payload(rng, scale=1.0):
    return {"w": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}


def _drive(cls, policy, script):
    """Run ``script`` (a list of operations) on a fresh aggregator of
    ``cls``; returns every flush's output and the final record."""
    a = cls.BufferedAggregator(cls.AggregationPolicy(**policy))
    out = []
    for op, *rest in script:
        if op == "fold":
            out.append(("depth", a.fold(*rest[:3], **rest[3])))
        elif op == "fold_many":
            out.append(("many", a.fold_many(rest[0], ready_target=rest[1])))
        elif op == "ready":
            out.append(("ready", a.ready(rest[0])))
        elif op == "flush":
            r = a.flush(rest[0])
            out.append(("flush", r.params, r.weight, r.version,
                        r.contributors, r.clients, r.reason,
                        r.max_staleness))
    out.append(("record", a.record(), a.depth, a.clients_buffered()))
    return out


def _script():
    rng = np.random.default_rng(0)
    return [
        ("fold", 3, 7.0, _payload(rng), {"staleness": 0}),
        ("fold", 1, 5.0, _payload(rng), {"staleness": 2}),
        ("ready", None), ("ready", 2),
        ("fold", 3, 9.0, _payload(rng), {"staleness": 1}),   # overwrite
        ("fold", 0, 11.0, _payload(rng, 4.0),
         {"staleness": 3, "clients": 5, "preweighted": True}),
        ("ready", None),
        ("flush", "buffer_k"),
        ("fold_many", [(k, float(k + 1), _payload(rng), k % 3)
                       for k in (8, 6, 7, 5, 4)], None),
        ("fold_many", [(k, 2.0, _payload(rng), 0) for k in (9, 10)], 3),
        ("flush", "deadline"),
        ("fold", 2, 1.0, _payload(rng), {"staleness": 4}),
        ("flush", "drain"),
    ]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        if g[0] == "flush":
            assert g[1].keys() == w[1].keys()
            for k in w[1]:
                assert g[1][k].dtype == w[1][k].dtype == np.float32
                assert g[1][k].tobytes() == w[1][k].tobytes()
            assert g[2:] == w[2:]
        else:
            assert g == w


@pytest.mark.parametrize("policy", [
    dict(buffer_k=4, staleness_decay=0.5),
    dict(buffer_k=64, staleness_decay=0.0),
    dict(buffer_k=1, staleness_decay=1.5)])
def test_buffered_aggregator_matches_the_reference(policy):
    _assert_same(_drive(agg, policy, _script()),
                 _drive(jagg, policy, _script()))


def test_flush_of_an_empty_buffer_raises_in_both():
    for mod in (agg, jagg):
        with pytest.raises(ValueError, match="empty"):
            mod.BufferedAggregator(mod.AggregationPolicy()).flush()


def test_make_aggregator_folds_through_the_robust_leg():
    from fedml_tpu_torch.program.privacy import RobustPolicy
    from fedml_tpu_torch.program.round import RoundProgram
    prog = RoundProgram(robust=RobustPolicy(mode="coordinate_median"))
    a = prog.host_view().make_aggregator()
    assert a._fold_fn == prog.robust.fold_entries
    assert RoundProgram().host_view().make_aggregator()._fold_fn is None


# -- the bucketed round ------------------------------------------------------

def _population():
    return bench._ragged_lr_clients(CLIENTS, dim=DIM, classes=CLASSES,
                                    seed=3)


def _args(**kw):
    base = dict(client_num_in_total=CLIENTS, client_num_per_round=CLIENTS,
                comm_round=ROUNDS, epochs=1, batch_size=8, lr=0.05, wd=0.0,
                client_optimizer="sgd", frequency_of_the_test=10 ** 9,
                seed=0, client_chunk=4, bucket_edges="geometric",
                device_resident="0")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def lr_runs():
    """Both APIs trained ``ROUNDS`` async rounds from the reference's
    initial weights: (records, params) of each round, each side."""
    ds = _population()
    japi = JaxFedAvgAPI(ds, jax_spec(JaxLR(num_classes=CLASSES,
                                           apply_sigmoid=False),
                                     jnp.zeros((1, DIM))), _args(**ASYNC))
    api = FedAvgAPI(ds, make_classification_spec(
        LogisticRegression(DIM, CLASSES, apply_sigmoid=False)),
        _args(**ASYNC), device="cpu")
    init = jax.tree.map(np.array, japi.global_state)
    api.global_state = cv_variables_to_state(init)
    ref, got = [], []
    for _ in range(ROUNDS):
        ref.append((japi.train_one_round(),
                    jax.tree.map(np.array, japi.global_state)))
        got.append((api.train_one_round(),
                    cv_state_to_variables(api.global_state)))
    return ref, got, init


def test_async_round_counters_equal_the_reference(lr_runs):
    ref, got, _ = lr_runs
    for (rm, _), (gm, _) in zip(ref, got):
        want = {k: v for k, v in rm.items() if k.startswith("async/")}
        assert want and {k: v for k, v in gm.items()
                         if k.startswith("async/")} == want
        for k in ("bucket/chunks", "bucket/executed_steps",
                  "bucket/true_steps", "bucket/waste_frac"):
            assert gm[k] == rm[k], k
    # flushes fall inside the window: the round really ran stale
    assert got[-1][0]["async/max_staleness"] > 0
    assert got[-1][0]["async/flushes_this_round"] > 1
    assert got[0][0]["packing_backend"] == "python"


def test_async_round_params_match_the_reference(lr_runs):
    ref, got, init = lr_runs
    moved = 0.0
    for (rm, rs), (gm, gs) in zip(ref, got):
        np.testing.assert_allclose(gm["Train/Loss"], rm["Train/Loss"],
                                   atol=1e-5)
        for layer in rs["params"]:
            for k, want in rs["params"][layer].items():
                np.testing.assert_allclose(gs["params"][layer][k], want,
                                           rtol=0, atol=1e-5)
                moved = max(moved, float(np.abs(
                    want - init["params"][layer][k]).max()))
    assert moved > 1e-3


def _runner(spec, client_chunk=4):
    return BucketedStreamRunner(spec, ClientUpdateConfig(lr=0.05),
                                client_chunk=client_chunk, batch_size=8,
                                epochs=1, edges=(8, 16, 32, 64))


def test_async_oracle_is_the_synchronous_round_bitwise():
    """``buffer_k`` = the cohort and decay 0: one flush of every chunk's
    partial, folded as the synchronous round folds them."""
    ds = _population()
    datasets = [ds[5][c] for c in range(CLIENTS)]
    spec = make_classification_spec(LogisticRegression(DIM, CLASSES))
    state = spec.init_fn(0, "cpu")
    sync = _runner(spec).run_round(state, (), datasets, 11,
                                   data_rng=np.random.default_rng(2))
    a = agg.BufferedAggregator(agg.AggregationPolicy(
        buffer_k=CLIENTS, staleness_decay=0.0))
    asy = _runner(spec).run_round(state, (), datasets, 11,
                                  data_rng=np.random.default_rng(2),
                                  aggregator=a)
    for k, v in sync[0]["params"].items():
        assert torch.equal(asy[0]["params"][k], v), k
    assert asy[2]["async"]["async/flushes_this_round"] == 1
    assert asy[2]["async"]["async/max_staleness"] == 0
    assert asy[2]["metrics"] == sync[2]["metrics"]
    assert asy[2]["bucket"] == sync[2]["bucket"]


def test_drain_flushes_what_buffer_k_left():
    ds = _population()
    datasets = [ds[5][c] for c in range(10)]
    spec = make_classification_spec(LogisticRegression(DIM, CLASSES))
    a = agg.BufferedAggregator(agg.AggregationPolicy(buffer_k=1000))
    _, _, info = _runner(spec).run_round(spec.init_fn(0, "cpu"), (),
                                         datasets, 5, aggregator=a)
    rec = info["async"]
    assert rec["async/flushes_this_round"] == rec["async/drain_flushes"] == 1
    assert rec["async/clients_folded"] == 10 and rec["async/version"] == 1


# -- the experiment mains ----------------------------------------------------

MAIN_ARGV = ["--async_agg", "1", "--buffer_k", "4", "--client_chunk", "2",
             "--comm_round", "2", "--frequency_of_the_test", "1",
             "--platform", "cpu"]


def _run_mains(monkeypatch, name, jcls_path, tcls_path, argv):
    import importlib
    jmod = importlib.import_module(f"fedml_tpu.algorithms.{jcls_path[0]}")
    tmod = importlib.import_module(
        f"fedml_tpu_torch.algorithms.{tcls_path[0]}")
    jbase, tbase = getattr(jmod, jcls_path[1]), getattr(tmod, tcls_path[1])
    inits = []

    class JaxAPI(jbase):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append(jax.tree.map(np.array, self.global_state))

    class PortAPI(tbase):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.global_state = cv_variables_to_state(inits[0])

    monkeypatch.setattr(jmod, jcls_path[1], JaxAPI)
    monkeypatch.setattr(tmod, tcls_path[1], PortAPI)
    jmain = importlib.import_module(f"fedml_tpu.experiments.main_{name}")
    tmain = {"fedavg": main_fedavg, "fedopt": main_fedopt}[name]
    japi, _ = jmain.main(argv)
    api, _ = tmain.main(argv)
    return japi, api


@pytest.mark.parametrize("name,jcls,tcls,extra", [
    ("fedavg", ("fedavg", "FedAvgAPI"), ("fedavg", "FedAvgAPI"), []),
    ("fedopt", ("fedopt", "FedOptAPI"), ("fedopt", "FedOptAPI"),
     ["--bucket_edges", "geometric"])])
def test_main_with_async_agg_matches_the_reference(monkeypatch, name, jcls,
                                                   tcls, extra):
    japi, api = _run_mains(monkeypatch, name, jcls, tcls, MAIN_ARGV + extra)
    assert api.bucket_runner is not None and api.async_agg is not None
    assert len(api.history) == len(japi.history) == 2
    for rnd, (rm, gm) in enumerate(zip(japi.history, api.history)):
        extra_keys = set(gm) - set(rm)
        assert extra_keys == ({"packing_backend"} if rnd == 0 else set())
        for key in rm:
            if key in ("round_time_s",):
                continue
            if key.startswith(("async/", "bucket/")) or key == "round":
                assert gm[key] == rm[key], key
            else:
                np.testing.assert_allclose(gm[key], rm[key], atol=1e-4,
                                           err_msg=f"{name} {key}")
    assert api.history[-1]["async/flushes"] > api.history[-1]["round"] + 1
