"""The port's TransformerLM (``models/transformer.py``) against the JAX
package's Flax model on the same weights (carried across by
``utils/torch_import.py``) and the same seeded token ids, at vocab 90,
d_model 32, 2 layers, 2 heads (head dim 16), T 16. The Flax model runs
its Pallas flash attention in interpret mode; the port's runs the plain
version of its kernels (CPU tensors).

Tolerances: fp32 logits 1e-5 and gradients 1e-4 (fp32 sums in another
order); bf16 logits 0.05 absolute against logits up to 3.8 (observed
0.024): the two frameworks round bf16 at other places (GELU inside or
outside fp32, the Dense product's accumulation), each rounding 2^-8
relative.
"""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.models.transformer import lm_loss as jax_lm_loss
from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
from fedml_tpu_torch.models.transformer import TransformerLM, lm_loss
from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                lm_variables_to_state)

V, D_MODEL, LAYERS, HEADS, T, B = 90, 32, 2, 2, 16, 3


def _models(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JaxLM(vocab_size=V, n_layers=LAYERS, n_heads=HEADS,
               d_model=D_MODEL, max_len=T, dtype=jdt)
    tm = TransformerLM(V, n_layers=LAYERS, n_heads=HEADS, d_model=D_MODEL,
                       max_len=T, dtype=tdt)
    return jm, tm


@pytest.fixture(scope="module")
def variables():
    jm, _ = _models("f32")
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))
    return jax.tree.map(np.asarray, v)


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


def test_carrier_round_trip_is_exact(variables):
    state = lm_variables_to_state(variables)
    _, tm = _models("f32")
    assert set(state["params"]) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        assert state["params"][n].shape == p.shape, n
    back = lm_state_to_variables(state)
    want = jax.tree_util.tree_leaves_with_path(variables)
    have = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(have)
    for path, leaf in want:
        np.testing.assert_array_equal(have[path], leaf)
    # client-stacked variables cross too
    stacked = jax.tree.map(lambda a: np.stack([a, 2 * a]), variables)
    sstate = lm_variables_to_state(stacked)
    for n, p in state["params"].items():
        torch.testing.assert_close(sstate["params"][n][1], 2 * p, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-5), ("bf16", 0.05)])
def test_logits_match_flax(variables, dtype, atol):
    jm, tm = _models(dtype)
    idx = _ids()
    want = np.asarray(jm.apply(variables, jnp.asarray(idx)))
    got = tm.apply_params(lm_variables_to_state(variables)["params"],
                          torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (B, T, V)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol)


def test_loss_and_gradients_match_jax_grad(variables):
    jm, tm = _models("f32")
    idx = _ids(1)
    tgt = np.random.default_rng(2).integers(-1, V, (B, T)).astype(np.int32)

    def jloss(params):
        return jax_lm_loss(jm.apply({"params": params}, jnp.asarray(idx)),
                           jnp.asarray(tgt))

    jl, jg = jax.value_and_grad(jloss)(variables["params"])
    params = {k: v.requires_grad_(True) for k, v in
              lm_variables_to_state(variables)["params"].items()}
    loss = lm_loss(tm.apply_params(params, torch.from_numpy(idx)),
                   torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=1e-5)
    want = lm_variables_to_state({"params": jg})["params"]
    for (n, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-4,
                                   err_msg=n)


def test_stacked_clients_train_independently(variables):
    """K clients stacked on a leading axis: the stacked loss's gradient
    for each client is that client's own gradient."""
    _, tm = _models("f32")
    spec = make_seq_classification_spec(tm)
    p0 = lm_variables_to_state(variables)["params"]
    p1 = {k: v * 0.9 for k, v in p0.items()}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, V, (2, B, T)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, V, (2, B, T)).astype(np.int64))
    mask = torch.tensor([[1., 1., 0.], [1., 0., 0.]])
    stacked = {k: torch.stack([p0[k], p1[k]]).requires_grad_(True)
               for k in p0}
    loss, (_, m) = spec.stacked_loss_fn({"params": stacked},
                                        {"x": x, "y": y, "mask": mask}, True)
    grads = torch.autograd.grad(loss, list(stacked.values()))
    for c, p in enumerate((p0, p1)):
        single = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        lc, (_, mc) = spec.loss_fn({"params": single},
                                   {"x": x[c], "y": y[c], "mask": mask[c]},
                                   True)
        gc = torch.autograd.grad(lc, list(single.values()))
        for a, b in zip(grads, gc):
            torch.testing.assert_close(a[c], b, atol=1e-6, rtol=1e-5)
        for key in ("loss_sum", "correct", "count"):
            torch.testing.assert_close(m[key][c], mc[key])


def test_init_draws_the_reference_initialisers(variables):
    """Same distributions as Flax's initialisers (different draws):
    per-leaf standard deviations within 15%, LayerNorm and biases
    exact."""
    _, tm = _models("f32")
    spec = make_seq_classification_spec(tm)
    state = spec.init_fn(0, "cpu")
    ref = lm_variables_to_state(variables)["params"]
    again = spec.init_fn(0, "cpu")
    for n, p in state["params"].items():
        torch.testing.assert_close(again["params"][n], p, rtol=0, atol=0)
        r = ref[n]
        if float(r.std()) == 0.0:
            torch.testing.assert_close(p, r, rtol=0, atol=0)
        else:
            assert abs(float(p.std()) / float(r.std()) - 1) < 0.15, n
