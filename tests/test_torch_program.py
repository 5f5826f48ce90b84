"""The port's ``RoundProgram`` legs against the JAX package's
``fedml_tpu/program``: ``manifest()`` byte-equal (``json.dumps`` with
``sort_keys=True``) over a grid of argument sets, ``from_manifest`` and
``replace`` round trips, the host view's draws and counts equal,
``fold_entries_fp64`` and ``aggregate_reports`` bitwise on seeded
entries, ``client_sampling`` with ``attempt > 0`` equal, and the legs
that wait for later work raising with their ROADMAP item (the privacy
legs themselves: ``tests/test_torch_privacy.py``)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import dataclasses
import json
import types

import numpy as np
import pytest

from fedml_tpu.program import aggregation as jagg
from fedml_tpu.program import cohort as jcohort
from fedml_tpu.program.privacy import DPPolicy, RobustPolicy
from fedml_tpu.program.round import RoundProgram as JaxProgram
from fedml_tpu_torch.program import aggregation as agg
from fedml_tpu_torch.program import cohort
from fedml_tpu_torch.program.codec import CodecSpec
from fedml_tpu_torch.program.round import RoundProgram

ARG_SETS = [
    {},
    {"deadline": 5.0, "overselect": 0.3, "quorum": 0.8},
    {"async_agg": 1},
    {"async_agg": 1, "buffer_k": 16, "staleness_decay": 0.0,
     "flush_deadline": 2.5, "async_window": 8},
    {"compressor": "none", "quorum": 0.0},
    {"compressor": None, "overselect": 1.0, "async_agg": 0},
]


def _dumps(program):
    return json.dumps(program.manifest(), sort_keys=True)


@pytest.mark.parametrize("kw", ARG_SETS)
def test_manifest_is_byte_equal(kw):
    args = types.SimpleNamespace(**kw)
    assert _dumps(RoundProgram.from_args(args)) == _dumps(
        JaxProgram.from_args(args))


@pytest.mark.parametrize("kw", ARG_SETS)
def test_from_manifest_and_replace_round_trip(kw):
    args = types.SimpleNamespace(**kw)
    prog = RoundProgram.from_args(args)
    back = RoundProgram.from_manifest(json.loads(_dumps(prog)))
    assert back == prog and _dumps(back) == _dumps(prog)
    jprog = JaxProgram.from_manifest(json.loads(_dumps(prog)))
    assert _dumps(jprog) == _dumps(prog)
    moved = prog.replace(cohort=dataclasses.replace(prog.cohort,
                                                    overselect=0.5))
    jmoved = JaxProgram.from_args(args).replace(
        cohort=dataclasses.replace(JaxProgram.from_args(args).cohort,
                                   overselect=0.5))
    assert _dumps(moved) == _dumps(jmoved)
    assert moved.is_async == prog.is_async == jprog.is_async


@pytest.mark.parametrize("kw", ARG_SETS)
def test_host_view_draws_and_counts_are_equal(kw):
    args = types.SimpleNamespace(**kw)
    host = RoundProgram.from_args(args).host_view()
    jhost = JaxProgram.from_args(args).host_view()
    for rnd in range(4):
        for attempt in range(3):
            assert (host.sample_cohort(rnd, 50, 7, attempt)
                    == jhost.sample_cohort(rnd, 50, 7, attempt))
            ranks = [9, 3, 17, 5, 11, 2, 8]
            assert (host.sample_ranks(rnd, attempt, ranks, 4)
                    == jhost.sample_ranks(rnd, attempt, ranks, 4))
    assert host.sample_ranks(0, 0, [4, 1], 5) == [1, 4]
    for target in (1, 7, 10, 33):
        assert host.select_count(target) == jhost.select_count(target)
        assert host.select_count(target, 8) == jhost.select_count(target, 8)
        assert host.quorum_count(target) == jhost.quorum_count(target)
    for s in (0, 1, 5):
        assert host.staleness_weight(s) == jhost.staleness_weight(s)


@pytest.mark.parametrize("attempt", [0, 1, 2, 7])
@pytest.mark.parametrize("total,per_round", [(10, 10), (10, 4), (100, 9),
                                             (3, 5)])
def test_client_sampling_with_attempts_is_equal(attempt, total, per_round):
    for rnd in range(5):
        assert (cohort.client_sampling(rnd, total, per_round, attempt)
                == jcohort.client_sampling(rnd, total, per_round, attempt))
        assert (cohort.attempt_seed(rnd, attempt)
                == jcohort.attempt_seed(rnd, attempt))


def _entries(seed, n=7):
    rng = np.random.default_rng(seed)
    out = []
    for k in rng.permutation(n):
        payload = {"w": rng.normal(size=(3, 4)).astype(np.float32),
                   "b": [rng.normal(size=5).astype(np.float32),
                         (np.float32(rng.normal()),)]}
        weight = float(rng.integers(1, 50))
        scale = agg.staleness_weight(int(rng.integers(0, 4)), 0.5) * weight
        out.append((int(k), weight, payload, scale))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_entries_fp64_is_bitwise(seed):
    entries = _entries(seed)
    got, total = agg.fold_entries_fp64(entries)
    want, jtotal = jagg.fold_entries_fp64(entries)
    assert total == jtotal
    np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0], np.asarray(want["b"][0]))
    np.testing.assert_array_equal(got["b"][1][0],
                                  np.asarray(want["b"][1][0]))
    assert got["w"].dtype == np.float32
    # arrival order does not move a bit
    again, _ = agg.fold_entries_fp64(entries[::-1])
    np.testing.assert_array_equal(again["w"], got["w"])


@pytest.mark.parametrize("seed", [0, 3])
def test_aggregate_reports_is_bitwise(seed):
    rng = np.random.default_rng(seed)
    reports = {int(r): (int(rng.integers(1, 40)),
                        {"p": rng.normal(size=(6,)).astype(np.float32)})
               for r in rng.permutation(9)}
    got, total = agg.aggregate_reports(reports)
    want, jtotal = jagg.aggregate_reports(reports)
    assert total == jtotal
    np.testing.assert_array_equal(got["p"], np.asarray(want["p"]))
    host = RoundProgram().host_view()
    np.testing.assert_array_equal(host.fold_reports(reports)[0]["p"],
                                  got["p"])


def test_folds_refuse_empty_and_weightless_input():
    for fn in (agg.fold_entries_fp64, agg.aggregate_reports):
        with pytest.raises(ValueError):
            fn([] if fn is agg.fold_entries_fp64 else {})
    with pytest.raises(ValueError):
        agg.aggregate_reports({0: (0, {"p": np.zeros(2)})})


@pytest.mark.parametrize("s,decay", [(0, 0.5), (3, 0.0), (3, 0.5),
                                     (10, 1.0), (-2, 0.5)])
def test_staleness_weight_is_equal(s, decay):
    assert agg.staleness_weight(s, decay) == jagg.staleness_weight(s, decay)


def test_aggregation_policy_is_the_reference_one():
    assert (dataclasses.asdict(agg.AggregationPolicy.sync())
            == dataclasses.asdict(jagg.AggregationPolicy.sync()))
    assert ([f.name for f in dataclasses.fields(agg.AggregationPolicy)]
            == [f.name for f in dataclasses.fields(jagg.AggregationPolicy)])
    assert agg.AggregationPolicy.from_args(types.SimpleNamespace()) is None


def test_legs_waiting_for_later_work_raise():
    # the codec leg is ported: a compressor spec builds, and its manifest
    # is the reference's
    assert CodecSpec("topk:0.01").enabled
    qsgd = types.SimpleNamespace(compressor="qsgd:4")
    assert _dumps(RoundProgram.from_args(qsgd)) == _dumps(
        JaxProgram.from_args(qsgd))
    assert not CodecSpec.coerce(None).enabled
    assert CodecSpec.coerce(" NONE ").spec == "none"
    # the privacy legs are ported: a reference manifest carrying them
    # builds, and so does the buffered aggregator under them, its flush
    # folding through the robust leg
    jman = JaxProgram(dp=DPPolicy(clip_norm=1.0),
                      robust=RobustPolicy(mode="norm_clip",
                                          clip_bound=1.0)).manifest()
    legs = RoundProgram.from_manifest(jman)
    assert legs.manifest() == jman
    for prog in (RoundProgram(), legs):
        aggregator = prog.host_view().make_aggregator()
        assert isinstance(aggregator, agg.BufferedAggregator)
        assert aggregator._fold_fn == (None if prog.robust is None
                                       else prog.robust.fold_entries)
    prog = RoundProgram()
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        prog.compile_sim(None, None, mesh=object())
    with pytest.raises(ValueError, match="codec leg is disabled"):
        prog.compile_sim(None, None, compressed=True)
