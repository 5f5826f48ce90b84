"""FedNAS's search against the JAX package on the CPU: the first- and
second-order arch gradients and two whole local search steps (the
alphas after the arch Adam, the weights after the clipped, decayed
momentum SGD, the BatchNorm statistics and the summed metrics; the last
train batch with a padded slot) within 2e-5, the server's weighted mean
against ``tree_weighted_mean``, and the counterparts of
``tests/test_fednas.py``'s search-round cases, whose bodies call jax,
with the same asserts.

The reference's second-order search step is one XLA program whose
tracing and compilation take one to two and a half minutes on an 8-core
CPU host at C 4, 3 layers and 2 steps a cell (8x8 images): those cases
are slow-marked, and the tier-1 cases run the same checks on one normal
cell (C 4, 1 layer, 2 steps), with the second-order arch gradient also
through two reduction cells at one step a cell (C 4, 3 layers); the
reductions' stride-2 ops are held op by op in ``test_torch_darts.py``.
The reference's arch gradient and its search step are a jitted program
each, compiled once a (size, order)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_scenarios import retarget
from seeded_variables import seeded_variables

from fedml_tpu.algorithms import fednas as jfednas
from fedml_tpu.algorithms.specs import make_classification_spec as jspec
from fedml_tpu.models import darts as jdarts
from fedml_tpu_torch.algorithms import fednas
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.models import darts
from fedml_tpu_torch.utils.torch_import import cv_variables_to_state

#: arch gradients and the search steps' states
STEP_TOL = 2e-5
HW = 8
#: (C, layers, steps a cell): one normal cell, and the search network's
#: size in the slow tier
SMALL, FULL = (4, 1, 2), (4, 3, 2)
SIZES = [SMALL, pytest.param(FULL, marks=pytest.mark.slow)]

_nas = retarget("test_fednas.py")
tiny_dataset = _nas.tiny_dataset


def _batches(S=2, B=4):
    rng = np.random.default_rng(3)
    mask = np.ones((S, B), np.float32)
    mask[-1, -1] = 0.0  # a padded slot in the last train batch
    return {"x": rng.normal(size=(S, B, HW, HW, 3)).astype(np.float32),
            "y": rng.integers(0, 4, (S, B)).astype(np.int64), "mask": mask,
            "val_x": rng.normal(size=(S, B, HW, HW, 3)).astype(np.float32),
            "val_y": rng.integers(0, 4, (S, B)).astype(np.int64),
            "n": np.float32(2 * B - 1)}


def _first_batches(d):
    return ({"x": d["x"][0], "y": d["y"][0], "mask": d["mask"][0]},
            {"x": d["val_x"][0], "y": d["val_y"][0],
             "mask": np.ones(d["mask"].shape[1:], np.float32)})


@functools.lru_cache(maxsize=None)
def _reference(size, order):
    """The reference's variables for ``size``, drawn with numpy, whose
    alphas lie a softmax apart (normal draws, not 1e-3), its spec and
    config, and the port's spec, carried state and config."""
    C, layers, steps = size
    jm = jdarts.DARTSNetwork(C=C, layers=layers, num_classes=4, steps=steps)
    x = np.random.default_rng(0).normal(size=(4, HW, HW, 3)).astype(
        np.float32)
    v = seeded_variables(jm, x, train=False)
    rng = np.random.default_rng(7)
    v["arch"] = {k: rng.normal(size=a.shape).astype(np.float32)
                 for k, a in v["arch"].items()}
    model = darts.DARTSNetwork(C=C, layers=layers, num_classes=4,
                               steps=steps)
    return (v, jspec(jm, jnp.zeros((1, HW, HW, 3))),
            jfednas.FedNASConfig(lr=0.05, arch_order=order),
            make_classification_spec(model), cv_variables_to_state(v),
            fednas.FedNASConfig(lr=0.05, arch_order=order), _batches())


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference_arch_grad(size, order):
    """The reference's arch gradient on the first batches (its
    ``fednas.py`` ``val_loss``), one jitted program."""
    v, spec, cfg, _, _, _, d = _reference(size, order)
    key = jax.random.PRNGKey(0)

    def arch_grad(v, train_b, val_b):
        rest = {k: c for k, c in v.items() if k not in ("arch", "params")}

        def val_loss(a):
            params = v["params"]
            if cfg.arch_order == 2:
                def train_loss(p):
                    st = dict(rest); st["params"] = p; st["arch"] = a
                    return spec.loss_fn(st, train_b, key, True)[0]
                g = jax.grad(train_loss)(params)
                p2 = jax.tree.map(lambda p_, g_: p_ - cfg.unrolled_xi * g_,
                                  params, g)
            else:
                p2 = params
            st = dict(rest); st["params"] = p2; st["arch"] = a
            return spec.loss_fn(st, val_b, key, True)[0]

        return jax.grad(val_loss)(v["arch"])

    grads = jax.jit(arch_grad)(_j(v), *map(_j, _first_batches(d)))
    return jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _reference_search(size, order):
    """The reference's two-step local search, one jitted program."""
    v, spec, cfg, _, _, _, d = _reference(size, order)
    update = jfednas.make_search_client_update(spec, cfg)
    local, _, metrics = jax.jit(update)(_j(v), _j(d), jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, dict(local)),
            jax.tree.map(np.asarray, metrics))


#: (size, order) of the arch-gradient cases: also the second-order
#: gradient through two reduction cells at one step a cell (C 4, 3
#: layers: its reference program compiles in under a minute here), and
#: in the slow tier through a cell of the reference's default 4 steps
GRAD_CASES = [(SMALL, 1), (SMALL, 2), ((4, 3, 1), 2),
              pytest.param(FULL, 1, marks=pytest.mark.slow),
              pytest.param(FULL, 2, marks=pytest.mark.slow),
              pytest.param((4, 1, 4), 2, marks=pytest.mark.slow)]


@pytest.mark.parametrize("size,order", GRAD_CASES)
def test_arch_gradient_is_the_reference(size, order):
    want = _reference_arch_grad(size, order)
    _, _, _, spec, state, cfg, d = _reference(size, order)
    tt = lambda b: {k: torch.as_tensor(a) for k, a in b.items()}
    train_b, val_b = map(tt, _first_batches(d))
    got = fednas.make_arch_grad_fn(spec, cfg)(
        state["params"], {"batch_stats": state["batch_stats"]},
        state["arch"], train_b, val_b)
    assert sorted(got) == sorted(want)
    for k in want:  # no zero gradient (3 layers: the reduction cells too)
        if k == "alphas_normal" or size[1] >= 3:
            assert np.abs(want[k]).max() > 1e-4, k
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=STEP_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_search_steps_are_the_reference(size, order):
    """Two local search steps: the alphas after Adam, the clipped weight
    steps, the statistics and the metrics."""
    jlocal, jm = _reference_search(size, order)
    _, _, _, spec, state, cfg, d = _reference(size, order)
    data = {k: torch.as_tensor(a) for k, a in d.items() if k != "n"}
    local, msum = fednas.make_search_client_update(spec, cfg)(state, data)
    want = cv_variables_to_state(jlocal)
    for coll in ("params", "batch_stats", "arch"):
        moved = max(float((want[coll][k] - state[coll][k]).abs().max())
                    for k in want[coll])
        assert moved > 10 * STEP_TOL, coll
        for k, w in want[coll].items():
            err = float((local[coll][k] - w).abs().max())
            assert err <= STEP_TOL, (coll, k, err)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(msum[k]), float(np.sum(jm[k])),
                                   atol=1e-4, err_msg=k)


def test_weighted_mean_is_tree_weighted_mean():
    from fedml_tpu.core import pytree
    rng = np.random.default_rng(0)
    trees = [{"a": {"w": rng.normal(size=(3, 2)).astype(np.float32)},
              "b": {"v": rng.normal(size=(4,)).astype(np.float32)}}
             for _ in range(3)]
    for n in ([3.0, 1.0, 0.0], [0.0, 0.0, 0.0]):
        want = pytree.tree_weighted_mean(
            jax.tree.map(lambda *xs: jnp.stack(xs), *trees), jnp.asarray(n))
        got = fednas.weighted_mean(
            [jax.tree.map(torch.as_tensor, t) for t in trees], n)
        for a, b in (("a", "w"), ("b", "v")):
            np.testing.assert_allclose(got[a][b].numpy(),
                                       np.asarray(want[a][b]), atol=1e-6)


# -- counterparts of test_fednas.py's search-round cases that call jax --------

@pytest.mark.parametrize("arch_order", [1, 2])
def test_fednas_search_round_updates_alphas(arch_order):
    args = types.SimpleNamespace(client_num_per_round=2, comm_round=1,
                                 epochs=1, batch_size=8, lr=0.05, seed=0,
                                 init_channels=4, layers=2, device="cpu")
    api = fednas.FedNASAPI(
        tiny_dataset(), args,
        model=darts.DARTSNetwork(C=4, layers=2, num_classes=4, steps=2),
        cfg=fednas.FedNASConfig(lr=0.05, arch_order=arch_order))
    a0 = {k: v.clone() for k, v in api.global_state["arch"].items()}
    out = api.train_one_round()
    a1 = api.global_state["arch"]
    assert np.isfinite(out["Train/Loss"])
    # alphas moved (architecture step ran) and stayed finite
    assert any(float((a0[k] - a1[k]).abs().max()) > 0 for k in a0)
    for leaf in a1.values():
        assert torch.isfinite(leaf).all()
    assert isinstance(out["genotype"], darts.Genotype)


def test_fednas_eval_runs():
    args = types.SimpleNamespace(client_num_per_round=2, comm_round=1,
                                 epochs=1, batch_size=8, lr=0.05, seed=0,
                                 device="cpu")
    api = fednas.FedNASAPI(
        tiny_dataset(), args,
        model=darts.DARTSNetwork(C=4, layers=1, num_classes=4, steps=2),
        cfg=fednas.FedNASConfig(arch_order=1))
    m = api.evaluate()
    assert 0.0 <= m["Test/Acc"] <= 1.0


@pytest.mark.parametrize("stage", ["search", "train"])
def test_main_fednas_runs_both_stages(stage):
    from fedml_tpu_torch.experiments import main_fednas
    api, out = main_fednas.main(
        ["--stage", stage, "--dataset", "synthetic_images", "--n_train",
         "32", "--n_test", "8", "--image_size", "8", "--init_channels",
         "4", "--layers", "3", "--steps", "2", "--client_num_in_total",
         "2", "--client_num_per_round", "2", "--comm_round", "1",
         "--batch_size", "8", "--platform", "cpu"])
    assert api.round_idx == 1
    if stage == "search":
        assert isinstance(out, darts.Genotype)
    else:
        assert "batch_stats" in out and "arch" not in out


# -- the clipped local optimizer ----------------------------------------------

@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_clipped_optimizer_is_optax_on_stacked_clients(momentum):
    """``grad_clip`` in front of the coupled decay and SGD, against
    ``optax.chain(clip_by_global_norm, add_decayed_weights, sgd)`` vmapped
    over 3 stacked clients: one client's gradients under the norm (left
    alone), two over it (each scaled by its own norm), 3 steps."""
    import optax
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 make_optimizer)
    rng = np.random.default_rng(0)
    shapes = {"conv.weight": (4, 3, 3, 3), "fc.bias": (5,)}
    params = {k: rng.normal(size=(3,) + s).astype(np.float32)
              for k, s in shapes.items()}
    scales = np.asarray([0.01, 1.0, 10.0], np.float32)
    grads = [{k: (rng.normal(size=(3,) + s) * scales.reshape(
        (3,) + (1,) * len(s))).astype(np.float32)
        for k, s in shapes.items()} for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.add_decayed_weights(3e-4),
                     optax.sgd(0.05, momentum=momentum or None))
    step = jax.vmap(lambda g, s, p: tx.update(g, s, p))
    jp, js = params, jax.vmap(tx.init)(params)
    opt = make_optimizer(ClientUpdateConfig(
        lr=0.05, weight_decay=3e-4, momentum=momentum, grad_clip=5.0))
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ts = opt.init(tp, (3,))
    for g in grads:
        upd, js = step(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.update({k: torch.as_tensor(v) for k, v in g.items()},
                            ts, tp)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)
