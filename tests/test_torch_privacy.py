"""The port's privacy legs against the JAX package's: ``core/robust.py``
against ``fedml_tpu/core/robust.py`` (1e-6), ``program/privacy.py``'s
``DPPolicy`` and ``RobustPolicy`` host legs bitwise (numpy on both
sides, every robust mode), the ``RoundProgram`` manifest with the legs
byte-equal, and ``compile_sim``/``compile_bucketed`` lowering a clip leg
onto the payload hook (one host-packed LR round against the reference's
at 1e-4) and refusing the noise and order-statistic legs as the
reference does."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.core import robust as jrobust
from fedml_tpu.data.synthetic import load_synthetic_federated
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.parallel.engine import ClientUpdateConfig as JaxConfig
from fedml_tpu.parallel.packing import pack_cohort
from fedml_tpu.program import privacy as jpriv
from fedml_tpu.program.round import RoundProgram as JaxProgram
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.core import robust
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.parallel.engine import ClientUpdateConfig
from fedml_tpu_torch.program import privacy
from fedml_tpu_torch.program.round import RoundProgram
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

TOL = 1e-6
RNG = np.random.default_rng(0)


def _state(rng, k=None, bn=True):
    lead = () if k is None else (k,)
    s = {"params": {"conv.weight": rng.normal(size=lead + (4, 3, 3, 3)),
                    "fc.bias": rng.normal(size=lead + (5,))}}
    if bn:
        s["batch_stats"] = {"bn.running_mean": rng.normal(size=lead + (4,))}
    return jax.tree.map(lambda a: a.astype(np.float32), s)


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _close(got, want, tol=TOL):
    got = jax.tree.map(lambda t: t.numpy(), got)
    assert (jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want)))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


# -- core/robust.py ---------------------------------------------------------

def test_split_and_vectorize_weights():
    s = _state(RNG)
    w, rest = robust.split_weights(_t(s))
    jw, jrest = jrobust.split_weights(s)
    assert sorted(w) == sorted(jw) and sorted(rest) == sorted(jrest)
    _close(robust.vectorize_weights(_t(s)), jrobust.vectorize_weights(s))
    assert robust.split_weights(torch.ones(2))[1] == {}


@pytest.mark.parametrize("bound", [0.5, 100.0])
def test_norm_diff_clipping_matches(bound):
    """One client, and four stacked clients against the reference vmapped
    over them; a bound of 100 leaves the updates unclipped."""
    g, lo = _state(RNG), _state(RNG)
    _close(robust.norm_diff_clipping(_t(lo), _t(g), bound),
           jrobust.norm_diff_clipping(lo, g, bound))
    stacked = _state(RNG, k=4)
    want = jax.vmap(lambda s: jrobust.norm_diff_clipping(s, g, bound))(
        stacked)
    _close(robust.norm_diff_clipping(_t(stacked), _t(g), bound), want)


@pytest.mark.parametrize("m", [3, 4])
def test_order_statistics_match(m):
    states = [_state(RNG) for _ in range(m)]
    _close(robust.coordinate_median([_t(s) for s in states]),
           jrobust.coordinate_median(states))
    for ratio in (0.0, 0.25, 0.4, 0.49):
        _close(robust.trimmed_mean([_t(s) for s in states], ratio),
               jrobust.trimmed_mean(states, ratio))


def test_gaussian_noise_leaves_stats_and_integers():
    s = _t(_state(RNG))
    s["params"]["steps"] = torch.arange(3)
    out = robust.add_gaussian_noise(s, 0.1, 7)
    assert torch.equal(out["batch_stats"]["bn.running_mean"],
                       s["batch_stats"]["bn.running_mean"])
    assert torch.equal(out["params"]["steps"], s["params"]["steps"])
    d = out["params"]["conv.weight"] - s["params"]["conv.weight"]
    assert 0.05 < float(d.std()) < 0.15
    again = robust.add_gaussian_noise(s, 0.1, 7)
    assert torch.equal(again["params"]["fc.bias"], out["params"]["fc.bias"])


# -- program/privacy.py -----------------------------------------------------

def _delta(rng, scale=1.0):
    return {"w": (scale * rng.normal(size=(6, 5))).astype(np.float32),
            "b": (scale * rng.normal(size=(5,))).astype(np.float32)}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()


@pytest.mark.parametrize("clip,mult", [(0.5, 0.0), (0.5, 1.1), (50.0, 0.3)])
def test_dp_host_legs_are_bitwise(clip, mult):
    pol = privacy.DPPolicy(clip_norm=clip, noise_multiplier=mult)
    jpol = jpriv.DPPolicy(clip_norm=clip, noise_multiplier=mult)
    d = _delta(np.random.default_rng(1), 3.0)
    base, params = _delta(np.random.default_rng(2)), _delta(
        np.random.default_rng(3))
    _same(pol.clip(d), jpol.clip(d))
    for rank, rnd, attempt in ((0, 0, 0), (3, 7, 2)):
        _same(pol.noise(d, rank, rnd, attempt),
              jpol.noise(d, rank, rnd, attempt))
        _same(pol.privatize(d, rank, rnd, attempt),
              jpol.privatize(d, rank, rnd, attempt))
        _same(pol.privatize_params(base, params, rank, rnd, attempt),
              jpol.privatize_params(base, params, rank, rnd, attempt))
    for rounds in (1, 5):
        assert pol.epsilon(rounds) == jpol.epsilon(rounds)
        assert pol.record(rounds) == jpol.record(rounds)
    assert pol.sigma == jpol.sigma
    assert privacy.DP_SEED_SALT == jpriv.DP_SEED_SALT
    assert privacy.ROBUST_MODES == jpriv.ROBUST_MODES


@pytest.mark.parametrize("kw", [{"clip_norm": 0.0},
                                {"noise_multiplier": -1.0},
                                {"delta": 1.0}])
def test_dp_policy_validates_as_the_reference(kw):
    with pytest.raises(ValueError):
        jpriv.DPPolicy(**kw)
    with pytest.raises(ValueError):
        privacy.DPPolicy(**kw)


def _reports(rng, m=5):
    reports = {r: (float(rng.integers(1, 20)), _delta(rng, 2.0))
               for r in rng.permutation(m).tolist()}
    reports[99] = (3.0, _delta(rng, 40.0))  # an outlier
    return reports


@pytest.mark.parametrize("mode", jpriv.ROBUST_MODES)
@pytest.mark.parametrize("trim", [0.0, 0.2, 0.45])
def test_robust_folds_are_bitwise(mode, trim):
    pol = privacy.RobustPolicy(mode=mode, clip_bound=1.5, trim_ratio=trim)
    jpol = jpriv.RobustPolicy(mode=mode, clip_bound=1.5, trim_ratio=trim)
    reports = _reports(np.random.default_rng(4))
    base = _delta(np.random.default_rng(5))
    got, total = pol.fold_reports(reports, base=base)
    want, jtotal = jpol.fold_reports(reports, base=base)
    assert total == jtotal
    _same(got, want)
    entries = [(r, n, p, n) for r, (n, p) in reports.items()]
    if mode == "norm_clip":
        for p in (pol, jpol):
            with pytest.raises(ValueError, match="sync-leg"):
                p.fold_entries(entries)
        with pytest.raises(ValueError, match="round base"):
            pol.fold_reports(reports)
    else:
        got, total = pol.fold_entries(entries)
        want, jtotal = jpol.fold_entries(entries)
        assert total == jtotal
        _same(got, want)
    with pytest.raises(ValueError):
        pol.fold_reports({})


def test_host_view_swaps_in_the_robust_fold_and_privatizes():
    rob = privacy.RobustPolicy(mode="trimmed_mean", trim_ratio=0.2)
    dp = privacy.DPPolicy(clip_norm=0.5, noise_multiplier=0.7)
    host = RoundProgram(dp=dp, robust=rob).host_view()
    jhost = JaxProgram(dp=jpriv.DPPolicy(clip_norm=0.5, noise_multiplier=0.7),
                       robust=jpriv.RobustPolicy(mode="trimmed_mean",
                                                 trim_ratio=0.2)).host_view()
    reports = _reports(np.random.default_rng(6))
    got, total = host.fold_reports(reports)
    want, jtotal = jhost.fold_reports(reports)
    assert total == jtotal
    _same(got, want)
    base, params = _delta(RNG), _delta(RNG)
    _same(host.privatize_update(base, params, 2, 3, 1),
          jhost.privatize_update(base, params, 2, 3, 1))
    assert host.dp is dp and host.robust is rob
    plain = RoundProgram().host_view()
    assert plain.dp is None and plain.robust is None
    assert plain.privatize_update(base, params, 2, 3) is params


def test_device_privatize_clips_as_the_reference():
    g, lo = _state(RNG), _state(RNG)
    pol = privacy.DPPolicy(clip_norm=0.3)
    jpol = jpriv.DPPolicy(clip_norm=0.3)
    _close(pol.device_privatize(_t(lo), _t(g), 11),
           jpol.device_privatize(lo, g, jax.random.PRNGKey(11)))
    noisy = privacy.DPPolicy(clip_norm=0.3, noise_multiplier=2.0)
    out = noisy.device_privatize(_t(lo), _t(g), 11)
    clipped = pol.device_privatize(_t(lo), _t(g), 11)
    d = out["params"]["conv.weight"] - clipped["params"]["conv.weight"]
    assert 0.3 < float(d.std()) < 0.9  # sigma 0.6


# -- the legs on the RoundProgram --------------------------------------------

LEGS = [
    {"dp": (0.5, 0.0)},
    {"robust": ("norm_clip", 2.0, 0.1)},
    {"dp": (1.0, 1.1), "robust": ("trimmed_mean", 10.0, 0.25)},
    {"robust": ("coordinate_median", 10.0, 0.1)},
]


def _programs(legs, args=None):
    out = []
    for mod, cls in ((privacy, RoundProgram), (jpriv, JaxProgram)):
        kw = {}
        if "dp" in legs:
            c, m = legs["dp"]
            kw["dp"] = mod.DPPolicy(clip_norm=c, noise_multiplier=m)
        if "robust" in legs:
            mode, b, t = legs["robust"]
            kw["robust"] = mod.RobustPolicy(mode=mode, clip_bound=b,
                                            trim_ratio=t)
        base = cls.from_args(args or types.SimpleNamespace())
        out.append(base.replace(**kw))
    return out


@pytest.mark.parametrize("legs", LEGS)
def test_manifest_with_legs_is_byte_equal(legs):
    prog, jprog = _programs(legs, types.SimpleNamespace(overselect=0.2))
    dump = json.dumps(prog.manifest(), sort_keys=True)
    assert dump == json.dumps(jprog.manifest(), sort_keys=True)
    back = RoundProgram.from_manifest(json.loads(dump))
    assert back == prog
    assert json.dumps(back.manifest(), sort_keys=True) == dump
    assert JaxProgram.from_manifest(json.loads(dump)) == jprog


@pytest.mark.parametrize("legs,match", [
    ({"dp": (1.0, 0.5)}, "DP noise leg"),
    ({"robust": ("coordinate_median", 1.0, 0.1)}, "coordinate_median"),
    ({"robust": ("trimmed_mean", 1.0, 0.1)}, "trimmed_mean"),
])
def test_compile_refuses_what_the_reference_refuses(legs, match):
    prog, jprog = _programs(legs)
    spec = make_classification_spec(LogisticRegression(60, 10))
    for lower in (lambda p, s, c: p.compile_sim(s, c),
                  lambda p, s, c: p.compile_bucketed(s, c)):
        with pytest.raises(ValueError, match=match):
            lower(prog, spec, ClientUpdateConfig())
        with pytest.raises(ValueError, match=match):
            lower(jprog, None, None)


@pytest.mark.parametrize("legs", [{"dp": (0.05, 0.0)},
                                  {"robust": ("norm_clip", 0.05, 0.1)}])
def test_clip_leg_lowers_onto_the_payload_hook(legs, monkeypatch):
    """One host-packed round of LR (4 clients) through a program with a
    clip leg that binds: the port's global state within 1e-4 of the
    reference's."""
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    prog, jprog = _programs(legs)
    ds = load_synthetic_federated(client_num=4, n_train=120, n_test=20,
                                  seed=0)
    jspec = jax_spec(JaxLR(num_classes=10), jnp.zeros((1, 60)))
    init = jax.tree.map(np.array, jspec.init_fn(jax.random.PRNGKey(0)))
    cohort = pack_cohort([ds[5][i] for i in range(4)], 16, 1,
                         rng=np.random.default_rng(0))
    jfn = jprog.compile_sim(jspec, JaxConfig(lr=0.1))
    want, _, _ = jfn(jax.tree.map(jnp.asarray, init), (),
                     jax.tree.map(jnp.asarray, cohort),
                     jax.random.PRNGKey(1))
    fn = prog.compile_sim(make_classification_spec(
        LogisticRegression(60, 10)), ClientUpdateConfig(lr=0.1))
    data = {k: torch.as_tensor(v) for k, v in cohort.items()}
    data["y"] = data["y"].long()
    got, _, _ = fn(cv_variables_to_state(init), (), data, 1)
    got = cv_state_to_variables(got)
    moved = 0.0
    for (path, g), w, i in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree.leaves(want), jax.tree.leaves(init)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4,
                                   err_msg=str(path))
        moved += float(np.sum((np.asarray(w) - i) ** 2))
    assert math.sqrt(moved) <= 0.05 + 1e-6  # the clip bound held
