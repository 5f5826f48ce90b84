"""The port's sequence parallelism (``ops/ring_attention.py``,
``parallel/seq_parallel.py``, ``experiments/main_longcontext.py``)
against single-device attention and the reference's.

The port's side runs in one spawned gloo group of 2 and of 4 ranks
(``tests/torch_dist.py``); the reference's side in this process on
conftest's forced CPU devices, on a mesh of the same shape. Held:

- the ring's forward and its gradients (q, k, v of each rank's shard)
  against the plain ``mha`` of the whole sequence within 1e-4, causal
  (the mask across shard edges) and not, with ragged key blocks; every
  ring hop moves one shard, ``T / n`` rows, so no rank holds the whole
  K/V; each rank's output shard against the reference ring's slice
  within 2e-5;
- one dp x sp SGD step of a 1-layer LM (the reference's
  ``test_ops.py:205`` case, its weights carried over) against the
  port's unsharded step and the reference's ``make_seq_parallel_lm_step``
  on the same mesh shape: loss and parameters within 1e-4;
- ``main_longcontext --ci`` at ``--n_seq`` n against ``--n_seq 1`` in
  this process (losses within 1e-4), and the reference's two
  ``test_experiments.py`` main cases (dense and ``--moe``): the loss
  falls."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist
import torch_dist_cases as cases
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.ops.attention import mha as jax_mha
from fedml_tpu.ops.ring_attention import make_ring_attention
from fedml_tpu.parallel import seq_parallel as jax_sp
from fedml_tpu_torch.models.transformer import TransformerLM, lm_loss
from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                lm_variables_to_state)

TOL = 1e-4
LM = dict(vocab_size=50, n_layers=1, n_heads=2, d_model=32, max_len=32)


@pytest.fixture(scope="module", params=[2, 4])
def group(request):
    g = torch_dist.RankGroup(request.param)
    try:
        yield g
    finally:
        g.close()


@pytest.mark.parametrize("causal,T,block", [(True, 16, 3), (False, 16, 3),
                                            (True, 24, 8)])
def test_ring_matches_single_device_attention(group, causal, T, block):
    outs = group.run(cases.ring_case, 0, causal, T, block)
    for out in outs:
        assert out["n"] == group.n
        assert max(out["errs"]) < TOL, out["errs"]
        assert out["hop_rows"] == (T // group.n if group.n > 1 else 0)


def test_ring_forward_matches_the_reference_ring(group):
    from jax.sharding import Mesh

    n, T = group.n, 24
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    fn = jax.jit(make_ring_attention(mesh, "seq", causal=True,
                                     block_size=8))
    # ring_case draws q, k, v (then do) from the same seeded stream
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, T, 2, 8)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(fn(q, k, v))
    np.testing.assert_allclose(ref, np.asarray(jax_mha(q, k, v,
                                                       causal=True)),
                               atol=2e-5)
    outs = group.run(cases.ring_case, 0, True, T, 8)
    assert sorted(o["rows"] for o in outs) == [
        (r * T // n, (r + 1) * T // n) for r in range(n)]
    for o in outs:
        start, stop = o["rows"]
        np.testing.assert_allclose(o["o"], ref[:, start:stop], atol=2e-5)


@pytest.fixture(scope="module")
def lm_params():
    """The reference LM's initial parameters (flax's initialisers), as
    numpy."""
    return jax.tree.map(np.asarray, JaxLM(**LM).init(
        jax.random.PRNGKey(1), jnp.zeros((1, LM["max_len"]),
                                         jnp.int32))["params"])


def _reference_step(n_data, n_seq, params, idx):
    """The reference's sp SGD step on an ``(n_data, n_seq)`` mesh from
    ``params``: ``(params after, loss)``."""
    mesh = jax_sp.make_seq_mesh(n_data, n_seq,
                        devices=jax.devices()[:n_data * n_seq])
    model = jax_sp.seq_parallel_model(JaxLM, mesh, block_size=8, **LM)
    tx = optax.sgd(0.1)
    _, step_fn = jax_sp.make_seq_parallel_lm_step(model, mesh, tx)
    p = jax.tree.map(jnp.asarray, params)
    idx = jnp.asarray(idx)
    new, _, loss = step_fn(p, tx.init(p), *jax_sp.place_lm_batch(
        mesh, idx, jax_sp.shift_targets(idx)))
    return jax.tree.map(np.asarray, new), float(loss)


def _port_unsharded_step(params, idx):
    model = TransformerLM(**LM)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    tgt = torch.as_tensor(np.array(
        jax_sp.shift_targets(jnp.asarray(idx)))).long()
    loss = lm_loss(model.apply_params(p, torch.as_tensor(idx).long()), tgt)
    grads = torch.autograd.grad(loss, list(p.values()))
    return ({k: (v - 0.1 * g).detach() for (k, v), g in zip(p.items(),
                                                           grads)},
            float(loss.detach()))


@pytest.mark.parametrize("dp", [1, 2])
def test_sp_step_matches_unsharded_and_reference(group, dp, lm_params):
    n_seq = group.n // dp
    idx = np.random.default_rng(0).integers(0, 50, (4, LM["max_len"]))
    ref_new, ref_loss = _reference_step(dp, n_seq, lm_params, idx)
    params = lm_variables_to_state({"params": lm_params})["params"]
    outs = group.run(cases.sp_step, {k: v.numpy()
                                     for k, v in params.items()}, idx, dp)
    new, loss, shape = outs[0]
    assert shape == {"data": dp, "seq": n_seq}
    for other in outs[1:]:
        assert other[1] == loss
        for k in new:
            np.testing.assert_array_equal(other[0][k], new[k])
    want, want_loss = _port_unsharded_step(params, idx)
    assert abs(loss - want_loss) < TOL and abs(loss - ref_loss) < TOL
    for k in want:
        np.testing.assert_allclose(new[k], want[k].numpy(), atol=TOL)
    got = lm_state_to_variables({"params": {
        k: torch.as_tensor(v) for k, v in new.items()}})
    have = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            {"params": ref_new}):
        np.testing.assert_allclose(have[path], leaf, atol=TOL)


def test_main_longcontext_ci_matches_one_rank(group):
    from fedml_tpu_torch.experiments import main_longcontext

    argv = ["--ci", "1", "--steps", "2", "--batch_size", "4", "--lr",
            "0.003", "--n_train", "16", "--platform", "cpu"]
    outs = group.run(cases.longcontext_main,
                     argv + ["--n_seq", str(group.n)])
    params, losses = main_longcontext.main(argv + ["--n_seq", "1"])
    for o in outs:
        np.testing.assert_allclose(o[1], losses, atol=TOL)
    for k, v in params.items():
        np.testing.assert_allclose(outs[0][0][k], v.detach().numpy(),
                                   atol=TOL)


@pytest.mark.parametrize("moe", [0, 1], ids=["dense", "moe"])
def test_main_longcontext_seq_parallel_loss_falls(group, moe):
    """The reference's ``test_main_longcontext_seq_parallel`` and
    ``..._moe_seq_parallel`` over this group's ranks (data 2 x seq 2 on 4
    ranks, seq 2 on 2)."""
    n_data = 2 if group.n == 4 else 1
    steps = 10 if moe else 8
    argv = ["--n_data", str(n_data), "--n_seq", str(group.n // n_data),
            "--steps", str(steps), "--batch_size", "4", "--seq_len", "32",
            "--lr", "0.01" if moe else "0.003", "--n_train", "32", "--ci",
            "1", "--platform", "cpu"]
    if moe:
        argv += ["--moe", "1", "--moe_experts", "4"]
    outs = group.run(cases.longcontext_main, argv)
    losses = outs[0][1]
    assert all(o[1] == losses for o in outs)
    assert len(losses) == steps
    if moe:
        assert min(losses[-3:]) < losses[0]
    else:
        assert losses[-1] < losses[0]
