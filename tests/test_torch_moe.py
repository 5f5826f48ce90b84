"""The MoE TransformerLM and its sown load-balancing loss in the port
against the JAX package (``fedml_tpu/models/moe.py``,
``fedml_tpu/algorithms/specs.py``), in fp32 from the reference's weights
carried over: ``MoEMLP`` outputs within 1e-5, the aux loss within 1e-6
and every token's route (expert and whether it fit the capacity) equal,
with a capacity factor small enough that tokens drop; the gradients of
loss + 0.01 * aux within 1e-4 of ``jax.grad``; the sequence spec's
training loss the reference's within 1e-6; ``MoETransformerLM`` logits within
1e-5 through the plain attention on the CPU (the JAX side through its
plain ``mha``); the client-stacked path equal to K single-client
applications (capacity, queue order and aux per client); the init's
standard deviation per parameter within 5% of flax's; a model that sows
nothing adds exactly nothing; and ``main_fedavg --model moe_transformer
--moe_experts 2`` against the reference's main over 2 rounds, losses
within 1e-5 and parameters at the LM rounds' tolerance (lr/2 elementwise,
99.9% within 1e-6)."""

import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from fedml_tpu.algorithms import specs as jspecs
from fedml_tpu.models.moe import MoEMLP as JaxMoEMLP
from fedml_tpu.models.moe import MoETransformerLM as JaxMoELM
from fedml_tpu.ops.attention import mha as jax_mha
from fedml_tpu_torch.algorithms import specs
from fedml_tpu_torch.models.moe import (MoEBlock, MoEMLP, MoETransformerLM,
                                        capacity, moe_mlp)
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                lm_variables_to_state,
                                                zoo_variables_to_state)

C, E, V, T = 16, 4, 30, 8
LM = dict(n_layers=2, n_heads=2, d_model=C, max_len=T, n_experts=E)


def _mlp_params(p):
    """Flax MoEMLP params -> the port's (router kernel transposed)."""
    return {"router.weight": torch.tensor(np.asarray(p["router"]["kernel"]).T
                                          .copy()),
            "router.bias": torch.tensor(np.asarray(p["router"]["bias"])),
            "wi": torch.tensor(np.asarray(p["wi"])),
            "wo": torch.tensor(np.asarray(p["wo"]))}


def _jax_routes(p, x, cf):
    """Each token's expert and whether it fit, by the reference's rule."""
    gates = jax.nn.softmax(x @ p["router"]["kernel"] + p["router"]["bias"])
    expert = np.asarray(jnp.argmax(gates, axis=-1))
    onehot = np.eye(E)[expert]
    pos = (np.cumsum(onehot, axis=0) * onehot - 1).max(axis=-1)
    return expert, pos < capacity(len(x), E, cf)


@pytest.mark.parametrize("cf", [1.25, 0.3])
def test_moe_mlp_matches_flax(cf):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, C)).astype(np.float32)
    jm = JaxMoEMLP(n_experts=E, capacity_factor=cf)
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want, mut = jax.jit(functools.partial(jm.apply, mutable=["losses"]))(
        {"params": p}, jnp.asarray(x))
    aux_want = jax.tree.leaves(mut["losses"])[0]
    tp = _mlp_params(p)
    y, aux = MoEMLP(C, E, capacity_factor=cf).apply_params(
        tp, torch.tensor(x), stacked=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_want), atol=1e-6)
    _, _, expert, keep = moe_mlp(
        torch.tensor(x)[None], tp["router.weight"][None],
        tp["router.bias"][None], tp["wi"][None], tp["wo"][None], cf)
    j_expert, j_keep = _jax_routes(p, x, cf)
    np.testing.assert_array_equal(expert[0].numpy(), j_expert)
    np.testing.assert_array_equal(keep[0].numpy(), j_keep)
    if cf < 1:  # tokens dropped: their output is exactly 0
        assert not j_keep.all()
        assert (y[~keep[0]] == 0).all()


def test_moe_mlp_gradients_match_jax_grad():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, C)).astype(np.float32)
    r = rng.standard_normal((24, C)).astype(np.float32)
    jm = JaxMoEMLP(n_experts=E, capacity_factor=0.6)
    p = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))["params"]

    def jloss(params, x):
        y, mut = jm.apply({"params": params}, x, mutable=["losses"])
        return jnp.sum(y * r) + 0.01 * jax.tree.leaves(mut["losses"])[0]

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _mlp_params(p).items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = MoEMLP(C, E, capacity_factor=0.6).apply_params(tp, tx,
                                                            stacked=False)
    ((y * torch.tensor(r)).sum() + 0.01 * aux).backward()
    want = _mlp_params(gp)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), want[k].numpy(),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-4)
    assert float(want["router.weight"].abs().sum()) > 0  # gates carry grad


@pytest.fixture(scope="module")
def lm_pair():
    """The reference's MoE LM (plain attention) with two initialisations
    and the port's LM, the first carried over."""
    jm = JaxMoELM(vocab_size=V, attention_fn=functools.partial(
        jax_mha, causal=True), **LM)
    idx = np.random.default_rng(3).integers(0, V, (3, T)).astype(np.int32)
    init = jax.jit(jm.init)
    vs = [{"params": init(jax.random.PRNGKey(s), jnp.asarray(idx))["params"]}
          for s in (0, 1)]
    return jm, vs, idx, MoETransformerLM(V, **LM)


def test_moe_lm_logits_match_flax_from_carried_weights(lm_pair):
    jm, vs, idx, model = lm_pair
    want, mut = jax.jit(functools.partial(jm.apply, mutable=["losses"]))(
        vs[0], jnp.asarray(idx))
    aux_want = sum(jax.tree.leaves(mut["losses"]), 0.0)
    state = lm_variables_to_state(vs[0])
    assert set(state["params"]) == set(dict(model.named_parameters()))
    logits, aux = model.apply_params(state["params"], torch.tensor(idx),
                                     with_sown=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_want), atol=1e-6)
    assert torch.equal(model.apply_params(state["params"],
                                          torch.tensor(idx)), logits)


def test_moe_weight_carrier_round_trips_exactly(lm_pair):
    _, vs, _, _ = lm_pair
    state = lm_variables_to_state(vs[0])
    assert state["params"]["blocks.1.moe.wi"].shape == (E, C, 4 * C)
    assert state["params"]["blocks.0.moe.router.weight"].shape == (E, C)
    np.testing.assert_array_equal(
        state["params"]["blocks.0.moe.wo"].numpy(),
        np.asarray(vs[0]["params"]["block0"]["moe"]["wo"]))
    back = lm_state_to_variables(state)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, vs[0]))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(vs[0])):
        np.testing.assert_array_equal(a, np.asarray(b))
    stacked = jax.tree.map(lambda *a: np.stack(a), *vs)
    st = lm_variables_to_state(stacked)
    assert st["params"]["blocks.0.moe.wi"].shape == (2, E, C, 4 * C)
    for a, b in zip(jax.tree.leaves(lm_state_to_variables(st)),
                    jax.tree.leaves(stacked)):
        np.testing.assert_array_equal(a, b)


def test_stacked_path_equals_k_single_client_applications(lm_pair):
    """Capacity, the queue order and the aux loss are per client: the
    client-stacked forward equals each client's own forward (and one
    client's routing over all K clients' tokens would differ)."""
    _, vs, idx, model = lm_pair
    states = [lm_variables_to_state(v)["params"] for v in vs]
    toks = torch.tensor(np.stack([idx, idx[::-1].copy()]))
    stacked = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    logits, aux = model.apply_params(stacked, toks, stacked=True,
                                     with_sown=True)
    assert aux.shape == (2,)
    for k in range(2):
        one, a = model.apply_params(states[k], toks[k], with_sown=True)
        np.testing.assert_allclose(logits[k].detach().numpy(),
                                   one.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(float(aux[k]), float(a), atol=1e-7)
    # each client's routes equal its own single-client routes, and no
    # expert takes more of a client's tokens than that client's capacity
    p = {k[len("blocks.0.moe."):]: v for k, v in stacked.items()
         if k.startswith("blocks.0.moe.")}
    x = torch.randn(2, 6, C, generator=torch.Generator().manual_seed(0))
    _, aux2, expert, keep = moe_mlp(x, p["router.weight"], p["router.bias"],
                                    p["wi"], p["wo"], 0.5)
    for k in range(2):
        _, a, e, kp = moe_mlp(x[k:k + 1], p["router.weight"][k:k + 1],
                              p["router.bias"][k:k + 1], p["wi"][k:k + 1],
                              p["wo"][k:k + 1], 0.5)
        assert torch.equal(expert[k], e[0]) and torch.equal(keep[k], kp[0])
        assert torch.equal(aux2[k], a[0])
        kept = torch.bincount(expert[k][keep[k]], minlength=E)
        assert int(kept.max()) <= capacity(6, E, 0.5) == 1
    assert not keep.all()


def test_moe_block_holds_the_moe_mlp():
    blk = MoEBlock(C, n_experts=E)
    assert isinstance(blk.moe, MoEMLP) and not hasattr(blk, "mlp_up")
    names = {n for n, _ in blk.named_parameters()}
    assert {"moe.router.weight", "moe.wi", "moe.wo", "qkv.weight"} <= names


def test_init_std_is_flax_within_five_percent():
    d, experts = 256, 8
    jm = JaxMoELM(vocab_size=90, n_layers=1, d_model=d, n_experts=experts,
                  max_len=80, attention_fn=functools.partial(jax_mha,
                                                             causal=True))
    want = lm_variables_to_state({"params": jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]})
    model = MoETransformerLM(90, n_layers=1, d_model=d, n_experts=experts,
                             max_len=80)
    got = specs.make_seq_classification_spec(model).init_fn(0, "cpu")
    # flax's lecun-normal over wi's whole shape: fan-in E*C
    assert abs(float(want["params"]["blocks.0.moe.wi"].std())
               - 1 / np.sqrt(experts * d)) < 0.05 / np.sqrt(experts * d)
    for k, w in want["params"].items():
        g = got["params"][k]
        assert g.shape == w.shape, k
        ws, gs = float(w.std()), float(g.std())
        if ws == 0.0:  # LayerNorm scales and biases, Dense biases
            assert torch.equal(g, w), k
            continue
        assert abs(gs - ws) <= 0.05 * ws, (k, gs, ws)
        assert abs(float(g.mean())) <= 0.05 * ws, k


def _batch(rng, K=None, B=4):
    shape = (B, T) if K is None else (K, B, T)
    x = rng.integers(1, V, shape)
    y = rng.integers(0, V, shape)
    mask = np.ones(shape[:-1], np.float32)
    mask[..., -1] = 0.0  # a padded sample: routed and counted all the same
    return {"x": x.astype(np.int32), "y": y.astype(np.int64), "mask": mask}


def test_seq_spec_adds_the_sown_loss(lm_pair):
    """The training loss is the reference spec's (aux at weight 0.01);
    the metrics leave the aux out, as the reference's do. The gradient of
    the sum is held at the MLP above and, through training, by the main
    below."""
    jm, vs, _, model = lm_pair
    batch = _batch(np.random.default_rng(4))
    jspec = jspecs.make_seq_classification_spec(
        jm, jnp.zeros((1, T), jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p: jspec.loss_fn({"params": p}, jb, None,
                                           True)[0])(vs[0]["params"])
    spec = specs.make_seq_classification_spec(model)
    state = lm_variables_to_state(vs[0])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, (_, metrics) = spec.loss_fn(state, tb, True)
        plain = spec.metrics_fn(state, tb)
    np.testing.assert_allclose(float(loss), float(want), atol=1e-6)
    for k, v in metrics.items():
        assert torch.equal(v, plain[k]), k
    _, aux = model.apply_params(state["params"], tb["x"], with_sown=True)
    np.testing.assert_allclose(
        float(loss), float(plain["loss_sum"] / plain["count"] + 0.01 * aux),
        atol=1e-6)


def test_stacked_spec_loss_is_the_sum_of_client_losses(lm_pair):
    _, vs, _, model = lm_pair
    spec = specs.make_seq_classification_spec(model)
    states = [lm_variables_to_state(v)["params"] for v in vs]
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(np.random.default_rng(5), K=2).items()}
    stacked = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    total, _ = spec.stacked_loss_fn({"params": stacked}, batch, True)
    each = [spec.loss_fn({"params": states[k]},
                         {n: v[k] for n, v in batch.items()}, True)[0]
            for k in range(2)]
    np.testing.assert_allclose(float(total), float(sum(each)), atol=1e-6)


def test_a_model_that_sows_nothing_adds_nothing():
    model = TransformerLM(V, n_layers=1, n_heads=2, d_model=C, max_len=T)
    spec = specs.make_seq_classification_spec(model)
    state = spec.init_fn(0, "cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(np.random.default_rng(6), K=2).items()}
    stacked = {k: torch.stack([v, v]) for k, v in state["params"].items()}
    total, _ = spec.stacked_loss_fn({"params": stacked}, batch, True)
    logits = model.apply_params(stacked, batch["x"], stacked=True)
    want, _ = specs._seq_loss_and_metrics(logits, batch["y"], batch["mask"],
                                          0, (1, 2))
    assert torch.equal(total, want.sum())
    assert not model.sows_losses


class _JaxSower(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        logits = fnn.Dense(3, name="linear")(x)
        self.sow("losses", "aux", jnp.mean(logits ** 2))
        return logits


class _Sower(nn.Module):
    sows_losses = True

    def __init__(self):
        super().__init__()
        self.linear = nn.Linear(5, 3)

    def forward(self, x, train=False, with_sown=False):
        logits = self.linear(x)
        return (logits, (logits ** 2).mean()) if with_sown else logits


def test_classification_spec_adds_the_sown_loss():
    rng = np.random.default_rng(7)
    batch = {"x": rng.standard_normal((2, 6, 5)).astype(np.float32),
             "y": rng.integers(0, 3, (2, 6)),
             "mask": np.ones((2, 6), np.float32)}
    jspec = jspecs.make_classification_spec(_JaxSower(),
                                            jnp.zeros((1, 5)))
    v = jspec.init_fn(jax.random.PRNGKey(0))
    want = [float(jspec.loss_fn(v, {k: jnp.asarray(b[i])
                                    for k, b in batch.items()},
                                None, True)[0]) for i in range(2)]
    spec = specs.make_classification_spec(_Sower())
    state = zoo_variables_to_state(jax.tree.map(np.asarray, v))
    tb = {k: torch.as_tensor(b) for k, b in batch.items()}
    got = [float(spec.loss_fn(state, {k: b[i] for k, b in tb.items()},
                              True)[0]) for i in range(2)]
    np.testing.assert_allclose(got, want, atol=1e-6)
    stacked = {"params": {k: torch.stack([t, t])
                          for k, t in state["params"].items()}}
    total, _ = spec.stacked_loss_fn(stacked, tb, True)
    np.testing.assert_allclose(float(total), sum(want), atol=1e-6)
    plain = specs.make_classification_spec(_Sower(), aux_loss_weight=0.0)
    assert float(plain.loss_fn(state, {k: b[0] for k, b in tb.items()},
                               True)[0]) < got[0]


# -- through the experiment main ---------------------------------------------

TINY = dict(n_layers=1, n_heads=2, d_model=32)


@pytest.fixture(scope="module")
def moe_mains():
    """``main_fedavg --model moe_transformer --moe_experts 2`` in both
    packages, each factory's model cut to d_model 32 and 1 layer (the
    JAX side through its plain attention), the port from the
    reference's initial weights."""
    import fedml_tpu.algorithms.fedavg as jfedavg
    import fedml_tpu.models as jmodels
    import fedml_tpu_torch.algorithms.fedavg as tfedavg
    import fedml_tpu_torch.models.factory as tfactory
    from fedml_tpu.experiments import main_fedavg as jmain
    from fedml_tpu_torch.experiments import main_fedavg

    mp = pytest.MonkeyPatch()
    inits = []

    class JaxAPI(jfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append(jax.tree.map(np.array, self.global_state))

    class PortAPI(tfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.global_state = lm_variables_to_state(inits[0])

    try:
        mp.setenv("FEDML_TPU_PACKING", "python")
        mp.setattr(jmodels, "MoETransformerLM", functools.partial(
            JaxMoELM, attention_fn=functools.partial(jax_mha, causal=True),
            **TINY))
        mp.setattr(tfactory, "MoETransformerLM", functools.partial(
            MoETransformerLM, **TINY))
        mp.setattr(jfedavg, "FedAvgAPI", JaxAPI)
        mp.setattr(tfedavg, "FedAvgAPI", PortAPI)
        argv = ["--model", "moe_transformer", "--moe_experts", "2",
                "--dataset", "synthetic_sequences", "--client_num_in_total",
                "4", "--client_num_per_round", "4", "--epochs", "1",
                "--comm_round", "2", "--n_train", "32", "--n_test", "8",
                "--batch_size", "4", "--frequency_of_the_test", "2",
                "--platform", "cpu"]
        japi, _ = jmain.main(argv)
        api, _ = main_fedavg.main(argv)
        return japi, api, inits[0]
    finally:
        mp.undo()


def test_moe_main_matches_the_reference_main(moe_mains):
    japi, api, init = moe_mains
    assert api.round_idx == 2
    assert api.global_state["params"]["blocks.0.moe.wi"].shape[0] == 2
    for rm, gm in zip(japi.history, api.history):
        for key in ("Train/Loss", "Test/Loss"):
            if key in rm or key in gm:
                np.testing.assert_allclose(gm[key], rm[key], atol=1e-5)
    assert "Test/Loss" in api.history[-1]
    lr = api.args.lr
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.array, japi.global_state))
    have = dict(jax.tree_util.tree_leaves_with_path(
        lm_state_to_variables(api.global_state)))
    start = dict(jax.tree_util.tree_leaves_with_path(init))
    errs, moved = [], 0.0
    for path, leaf in want:
        np.testing.assert_allclose(have[path], leaf, atol=lr / 2)
        errs.append(np.abs(have[path] - leaf).ravel())
        moved = max(moved, float(np.abs(leaf - start[path]).max()))
    assert np.mean(np.concatenate(errs) > 1e-6) < 1e-3
    assert moved > 1e-3


def test_factory_builds_the_moe_model_with_its_defaults():
    from fedml_tpu_torch.models.factory import create_model
    model = create_model(types.SimpleNamespace(moe_experts=4,
                                               model_dtype="bf16"),
                         "moe_transformer", 90)
    assert isinstance(model, MoETransformerLM)
    assert (model.n_experts, model.d_model, model.n_layers, model.n_heads,
            model.mlp_ratio, model.capacity_factor) == (4, 256, 4, 4, 4,
                                                        1.25)
    assert model.dtype == torch.bfloat16
    assert create_model(None, "moe_transformer", 90).n_experts == 8
