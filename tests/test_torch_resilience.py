"""``SimResilience`` and the resilient cohort in the port against the JAX
package: over-selection, seeded deadline misses, the seeded arrival
permutation, "first C reports win" and the below-quorum re-sample give
the same cohorts and ``res/*`` records bit for bit on a grid (and the
same ``RuntimeError`` after ``max_round_retries``); every round path of
``FedAvgAPI`` trains the resilient cohort, and FedOpt (Adam), FedNova
and robust FedAvg compose with it, each held against the reference over
2 rounds at 1e-4 from the reference's initial weights; hierarchical
FedAvg bypasses it, as the reference's does; a resumed ``main_fedavg``
run under resilience is bit-equal to an uninterrupted one without pace
steering, and carries the reference's resumed records with it. The
reference's behaviour tests (renormalise, don't zero-bias) hold on the
port."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import itertools
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.algorithms import fedopt as jfedopt
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg_robust import FedAvgRobustAPI as JaxRobust
from fedml_tpu.algorithms.fednova import FedNovaAPI as JaxFedNova
from fedml_tpu.algorithms.hierarchical import (HierarchicalFedAvgAPI as
                                               JaxHierarchical)
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.data.synthetic import (load_synthetic_federated as
                                      jax_load_federated)
from fedml_tpu.experiments import main_fedavg as jmain
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.program.cohort import CohortPolicy as JaxCohortPolicy
from fedml_tpu.resilience import faults as jfaults
from fedml_tpu.resilience.integration import SimResilience as JaxSim
from fedml_tpu_torch.algorithms import fedopt
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustAPI
from fedml_tpu_torch.algorithms.fednova import FedNovaAPI
from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.experiments import (main_centralized, main_fedavg,
                                         main_fedavg_robust, main_fednova,
                                         main_fedopt, main_hierarchical)
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.program.cohort import CohortPolicy, client_sampling
from fedml_tpu_torch.resilience import faults
from fedml_tpu_torch.resilience.integration import SimResilience
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

ROUNDS, TOL = 2, 1e-4
RES = {"overselect": 0.3, "straggler_p": 0.25, "quorum": 0.5}


@pytest.fixture(scope="module", autouse=True)
def _numpy_packing():
    """Both packages pack schedules with numpy, byte-equal."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    yield
    mp.undo()


def _draws(res, totals, rounds=10):
    """Every round's cohort (ids with their types) and record, or the
    error it raised, for each ``(total, per_round)``."""
    out = []
    for total, per_round in totals:
        for rnd in range(rounds):
            try:
                ids, rec = res.sample(rnd, total, per_round)
                out.append(([(type(c).__name__, int(c)) for c in ids], rec))
            except RuntimeError as e:
                out.append(("raised", str(e)))
    return out


GRID = list(itertools.product((0.0, 0.3, 1.0), (0.25, 0.6), (0.34, 0.75)))
TOTALS = [(5, 3), (12, 6), (12, 12), (40, 10), (40, 40), (7, 9)]


@pytest.mark.parametrize("overselect,straggler_p,quorum", GRID)
def test_sim_resilience_matches_the_reference_bitwise(overselect,
                                                      straggler_p, quorum):
    args = types.SimpleNamespace(overselect=overselect,
                                 straggler_p=straggler_p, quorum=quorum,
                                 seed=5)
    got, want = SimResilience.from_args(args), JaxSim.from_args(args)
    assert _draws(got, TOTALS) == _draws(want, TOTALS)
    assert ((got.rounds_degraded, got.rounds_abandoned, got.clients_dropped)
            == (want.rounds_degraded, want.rounds_abandoned,
                want.clients_dropped))


def test_sim_resilience_grid_covers_every_outcome():
    seen = set()
    for overselect, straggler_p, quorum in GRID:
        res = SimResilience.from_args(types.SimpleNamespace(
            overselect=overselect, straggler_p=straggler_p, quorum=quorum,
            seed=5))
        for draw in _draws(res, TOTALS):
            if draw[0] == "raised":
                seen.add("raised")
            else:
                rec = draw[1]
                seen.add("degraded" if rec["res/degraded"] else "complete")
                if rec["res/attempts"] > 1:
                    seen.add("resampled")
                if rec["res/selected"] > rec["res/reporting"]:
                    seen.add("trimmed")
    assert seen == {"raised", "degraded", "complete", "resampled",
                    "trimmed"}


def test_trace_miss_fn_drives_both_alike():
    def trace(mod):
        return mod.DiurnalTrace.example(scale=0.5, dropout=0.5, seed=2)

    got = SimResilience(CohortPolicy(overselect=0.3, quorum=0.34),
                        miss_fn=faults.TraceLoadGen(
                            trace(faults), population=range(12))
                        .sim_miss_fn(round_s=1.0))
    want = JaxSim(JaxCohortPolicy(overselect=0.3, quorum=0.34),
                  miss_fn=jfaults.TraceLoadGen(
                      trace(jfaults), population=range(12))
                  .sim_miss_fn(round_s=1.0))
    draws = _draws(got, [(12, 6)], rounds=20)
    assert draws == _draws(want, [(12, 6)], rounds=20)
    assert any(d[1]["res/degraded"] for d in draws if d[0] != "raised")


def test_below_quorum_resamples_then_gives_up(caplog):
    for cls, pol in ((SimResilience, CohortPolicy),
                     (JaxSim, JaxCohortPolicy)):
        res = cls(pol(quorum=0.75, max_round_retries=2),
                  miss_fn=lambda r, a, c: a == 0 and c < 3)
        # attempt 0 drops clients 0..2 of [0..3] -> 1/4 < quorum 3;
        # attempt 1 drops nobody -> completes, counted as abandoned once
        reporting, rec = res.sample(0, 4, 4)
        assert rec["res/attempts"] == 2
        assert res.rounds_abandoned == 1
        assert len(reporting) == 4
        res2 = cls(pol(quorum=0.75, max_round_retries=1),
                   miss_fn=lambda r, a, c: True)
        with pytest.raises(RuntimeError, match="abandoned 2 consecutive"):
            res2.sample(0, 4, 4)
    assert "below quorum" in caplog.text


def test_overselect_trims_to_target():
    res = SimResilience(CohortPolicy(overselect=0.5))
    reporting, rec = res.sample(0, 10, 4)
    assert rec["res/selected"] == 6  # ceil(1.5 * 4)
    assert len(reporting) == 4      # first C reports win
    assert rec["res/degraded"] == 0
    assert reporting == sorted(reporting)


def test_client_sampling_attempt_folds_seed():
    base = client_sampling(3, 20, 5)
    assert client_sampling(3, 20, 5, attempt=0) == base
    assert client_sampling(3, 20, 5, attempt=1) != base


# -- FedAvgAPI on the resilient cohort --------------------------------------

def _args(mode=1, resident="auto", **kw):
    base = dict(client_num_in_total=8, client_num_per_round=4,
                comm_round=ROUNDS, epochs=1, batch_size=16, lr=0.05,
                wd=0.001, client_optimizer="sgd", frequency_of_the_test=1,
                seed=0, client_chunk=3, wave_mode=mode,
                device_resident=resident, device_data_cap_gb=1.0,
                device_dtype=None, **RES)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _lr_family():
    """LR on a heterogeneous (LDA) LEAF split of 8 clients."""
    ds = jax_load_federated(client_num=8, n_train=240, n_test=40,
                            partition="hetero", seed=0)
    return (ds, jax_spec(JaxLR(num_classes=10), jnp.zeros((1, 60))),
            make_classification_spec(LogisticRegression(60, 10)),
            cv_variables_to_state, cv_state_to_variables)


def _both(jcls, tcls, args):
    """Train the JAX API and the port's on LR (from the reference's
    initial weights) for ``comm_round`` rounds: their records and
    states."""
    ds, jspec, tspec, to_state, to_vars = _lr_family()
    japi = jcls(ds, jspec, args)
    api = tcls(ds, tspec, args, device="cpu")
    init = jax.tree.map(np.array, japi.global_state)
    api.global_state = to_state(init)
    ref, got = [], []
    japi.train(on_round=lambda a, m: ref.append(
        (dict(m), jax.tree.map(np.array, a.global_state))))
    api.train(on_round=lambda a, m: got.append(
        (dict(m), to_vars(a.global_state))))
    return ref, got, init, api, japi


def _res(m):
    return {k: v for k, v in m.items() if k.startswith(("res/", "pace/"))}


def check(run, resilient=True):
    ref, got, init, _, _ = run
    assert len(got) == len(ref) == ROUNDS
    moved = 0.0
    for rnd, ((rm, rs), (gm, gs)) in enumerate(zip(ref, got)):
        assert gm["round"] == rm["round"] == rnd
        assert _res(gm) == _res(rm)
        assert bool(_res(gm)) == resilient
        for key in ("Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc"):
            np.testing.assert_allclose(gm[key], rm[key], atol=TOL)
        have = dict(jax.tree_util.tree_leaves_with_path(gs))
        for path, leaf in jax.tree_util.tree_leaves_with_path(rs):
            np.testing.assert_allclose(have[path], leaf, atol=TOL)
            start = dict(jax.tree_util.tree_leaves_with_path(init))[path]
            moved = max(moved, float(np.abs(leaf - start).max()))
    assert moved > 1e-3  # the rounds really trained
    # the resilient rounds really dropped clients
    assert not resilient or got[-1][0]["res/clients_dropped"] > 0


# (wave_mode, device_resident): waves and vmap lanes (the flat round and
# packed lanes draw their cohort in the same place), the host-packed
# round and bucketed streaming
PATHS = [(1, "auto"), (2, "auto"), (1, "0"), (1, "bucketed")]


@pytest.mark.parametrize("mode,resident", PATHS)
def test_every_round_path_trains_the_resilient_cohort(mode, resident):
    args = _args(mode, resident)
    if resident == "bucketed":
        args.bucket_edges, args.device_resident = "geometric", "auto"
    run = _both(JaxFedAvgAPI, FedAvgAPI, args)
    api = run[3]
    assert (api.bucket_runner is not None) == (resident == "bucketed")
    assert (api.device_data is None) == (resident in ("0", "bucketed"))
    check(run)


def test_fedadam_composes_with_resilience():
    args = _args(server_optimizer="adam", server_lr=0.1)
    check(_both(jfedopt.FedOptAPI, fedopt.FedOptAPI, args))


def test_fednova_composes_with_resilience():
    check(_both(JaxFedNova, FedNovaAPI, _args()))


def test_robust_fedavg_composes_with_resilience():
    args = _args(norm_bound=0.05, stddev=0.0)
    check(_both(JaxRobust, FedAvgRobustAPI, args))


def test_hierarchical_bypasses_resilience_as_the_reference_does():
    args = _args(group_num=2, group_comm_round=1)
    run = _both(JaxHierarchical, HierarchicalFedAvgAPI, args)
    check(run, resilient=False)
    assert run[3].resilience is not None  # built, and not consulted


def test_dropped_client_renormalizes_not_zero_biases():
    """The reference's test on the port: a round whose client 2 misses
    its deadline equals, bit for bit, a round over the reporting subset
    [0, 1, 3] with no resilience, and differs from the full round."""
    ds, _, spec, _, _ = _lr_family()
    plain = dict(client_num_in_total=4, client_num_per_round=4,
                 comm_round=2, epochs=1, batch_size=16, lr=0.3,
                 client_optimizer="sgd", wd=0.0, frequency_of_the_test=100,
                 ci=0, seed=0)
    ds = [ds[0], ds[1], ds[2], ds[3], {i: ds[4][i] for i in range(4)},
          {i: ds[5][i] for i in range(4)}, {i: ds[6][i] for i in range(4)},
          ds[7]]
    api_a = FedAvgAPI(ds, spec, types.SimpleNamespace(**plain,
                                                      straggler_p=1.0),
                      device="cpu")
    api_a.resilience = SimResilience(CohortPolicy(quorum=0.5),
                                     miss_fn=lambda r, a, c: c == 2)
    api_a.train_one_round()
    assert api_a._last_res_record["res/degraded"] == 1
    assert api_a._last_res_record["res/reporting"] == 3
    api_b = FedAvgAPI(ds, spec, types.SimpleNamespace(**plain), device="cpu")
    api_b._sample_cohort = lambda r: [0, 1, 3]
    api_b.train_one_round()
    api_c = FedAvgAPI(ds, spec, types.SimpleNamespace(**plain), device="cpu")
    api_c.train_one_round()
    a, b, c = (api.global_state["params"] for api in (api_a, api_b, api_c))
    assert all((a[k] == b[k]).all() for k in a)
    assert any(not (a[k] == c[k]).all() for k in a)
    assert all(bool(v.isfinite().all()) for v in a.values())


# -- the mains --------------------------------------------------------------

IMAGES = ["--dataset", "synthetic_images", "--model", "cnn", "--image_size",
          "8", "--n_train", "160", "--n_test", "32"]
FLAGS = ["--client_num_in_total", "8", "--client_num_per_round", "4",
         "--batch_size", "16", "--comm_round", "2", "--overselect", "0.3",
         "--straggler_p", "0.25", "--quorum", "0.34", "--pace_steering",
         "1", "--platform", "cpu"]
MAINS = {"fedavg": (main_fedavg, []), "fedopt": (main_fedopt, []),
         "fednova": (main_fednova, []),
         "fedavg_robust": (main_fedavg_robust, IMAGES),
         "hierarchical": (main_hierarchical, []),
         "centralized": (main_centralized, [])}


def _reference_replay(args, rounds, total, per_round):
    """The ``res/*`` and ``pace/*`` records of ``rounds`` rounds from the
    reference's ``SimResilience`` and ``PaceController`` alone, on the
    host, steered as the reference's ``FedAvgAPI`` steers them."""
    import dataclasses

    from fedml_tpu.resilience.steering import PaceController
    res, pace = JaxSim.from_args(args), PaceController.from_args(args)
    target, prev, out = min(per_round, total), None, []
    for rnd in range(rounds):
        if prev is not None:
            dec = pace.decide(
                outcome="degraded" if prev["res/degraded"] else "complete",
                selected=target, reporting=min(prev["res/reporting"],
                                               target))
            res.policy = dataclasses.replace(res.policy,
                                             overselect=dec.overselect)
        _, prev = res.sample(rnd, total, per_round)
        prev.update(pace.record())
        out.append(prev)
    return out


@pytest.mark.parametrize("name", sorted(MAINS))
def test_each_main_runs_the_resilience_flags_as_the_reference_does(name):
    """The flags parse and run on every main; the rounds carry ``res/*``
    and ``pace/*`` records exactly where the reference's do
    (hierarchical and centralized training draw no resilient cohort),
    equal to the reference's host-only replay."""
    module, argv = MAINS[name]
    api, _ = module.main(argv + FLAGS)
    assert api.round_idx == 2
    records = [_res(m) for m in api.history]
    if name in ("hierarchical", "centralized"):
        assert records == [{}, {}]
    else:
        assert records == _reference_replay(api.args, 2, 8, 4)
        assert records[1]["pace/decision"] == 0


TINY = ["--dataset", "synthetic", "--model", "lr", "--lr", "0.1",
        "--client_num_in_total", "8", "--client_num_per_round", "4",
        "--epochs", "1", "--batch_size", "8", "--n_train", "128",
        "--n_test", "32", "--frequency_of_the_test", "100", "--ci", "1",
        "--save_frequency", "1", "--overselect", "0.3", "--straggler_p",
        "0.3", "--quorum", "0.34"]


def _cut_and_resume(mod, argv, ckpt):
    """The run cut after round 2 and resumed to round 4: its resumed
    api."""
    mod.main(argv + ["--comm_round", "2", "--checkpoint_dir", ckpt])
    resumed, _ = mod.main(argv + ["--comm_round", "4", "--resume", "1",
                                  "--checkpoint_dir", ckpt])
    assert resumed.round_idx == 4 and len(resumed.history) == 2
    return resumed


def test_resumed_run_without_pace_is_bitwise_uninterrupted(tmp_path):
    argv = TINY + ["--platform", "cpu"]
    full, _ = main_fedavg.main(argv + ["--comm_round", "4",
                                       "--checkpoint_dir",
                                       str(tmp_path / "a")])
    resumed = _cut_and_resume(main_fedavg, argv, str(tmp_path / "b"))
    for k, v in full.global_state["params"].items():
        assert (resumed.global_state["params"][k] == v).all()
    # the cohorts agree; the cumulative counters restart at 0 on resume
    for got, want in zip(resumed.history, full.history[2:]):
        assert got["res/reporting"] == want["res/reporting"]
        assert got["res/selected"] == want["res/selected"]
    assert resumed.history[0]["res/clients_dropped"] <= (
        full.history[2]["res/clients_dropped"])


def test_resumed_run_with_pace_carries_the_reference_records(tmp_path):
    argv = TINY + ["--pace_steering", "1"]
    logging.disable(logging.INFO)
    try:
        want = _cut_and_resume(jmain, argv, str(tmp_path / "ref"))
    finally:
        logging.disable(logging.NOTSET)
    got = _cut_and_resume(main_fedavg, argv + ["--platform", "cpu"],
                          str(tmp_path / "port"))
    assert [_res(m) for m in got.history] == [_res(m) for m in want.history]
    # pace restarts from its flags with no previous record
    assert got.history[0]["pace/decision"] == -1
    assert got.history[1]["pace/decision"] == 0
