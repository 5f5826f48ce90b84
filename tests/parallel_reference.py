"""The reference's tp, pp and ep steps (``fedml_tpu/parallel/
{tensor,pipeline,expert}_parallel.py``) in the test process, on
conftest's forced CPU devices, from given weights, and the holds the
port's tests and dry run put on the port's steps against them: the loss
within rtol 1e-5 and every parameter, carried back to the reference's
layout (``lm_state_to_variables``), within 1e-4 (the reference's
``tests/test_ops.py`` tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                lm_variables_to_state)

LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tgt(idx):
    from fedml_tpu.parallel.seq_parallel import shift_targets

    return shift_targets(jnp.asarray(idx))


def lm_params(kw, seed, T, moe=False):
    """Flax's initial parameters (numpy) of the reference's
    ``TransformerLM(**kw)`` (``MoETransformerLM`` for ``moe``) from
    ``PRNGKey(seed)``."""
    from fedml_tpu.models.moe import MoETransformerLM
    from fedml_tpu.models.transformer import TransformerLM

    cls = MoETransformerLM if moe else TransformerLM
    return _np(cls(**kw).init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, T), jnp.int32))["params"])


def port_params(params):
    """The reference's parameters as the port's (torch names, numpy)."""
    return {k: v.numpy() for k, v in
            lm_variables_to_state({"params": params})["params"].items()}


def tp_step(params, idx, n_data, n_model, kw, block):
    """The reference's tp SGD step (lr 0.1) on an ``(n_data, n_model)``
    mesh: ``(new params, loss)``."""
    from fedml_tpu.models.transformer import TransformerLM
    from fedml_tpu.parallel import tensor_parallel as tp

    mesh = tp.make_tp_mesh(n_data, n_model,
                           devices=jax.devices()[:n_data * n_model])
    model = TransformerLM(attention_fn=tp.tp_attention(block_size=block),
                          **kw)
    tx = optax.sgd(0.1)
    _, step_fn = tp.make_tp_lm_step(model, mesh, tx)
    p = jax.tree.map(jax.device_put, jax.tree.map(jnp.asarray, params),
                     tp.tp_param_shardings(params, mesh))
    new, _, loss = step_fn(p, tx.init(p), jnp.asarray(idx), _tgt(idx))
    return _np(new), float(loss)


def pp_step(params, idx, n_stages, kw, n_micro, block=None):
    """The reference's pp SGD step (lr 0.1) over ``n_stages`` from the
    unstacked ``params``: ``(new params unstacked, loss)``."""
    from fedml_tpu.models.transformer import TransformerLM
    from fedml_tpu.parallel import pipeline_parallel as pp
    from fedml_tpu.parallel.tensor_parallel import tp_attention

    mesh = pp.make_pp_mesh(n_stages, devices=jax.devices()[:n_stages])
    n_layers = sum(1 for k in params if k.startswith("block"))
    model = TransformerLM(n_layers=n_layers, attention_fn=(
        tp_attention(block_size=block) if block else None), **kw)
    host = pp.stack_pp_params(jax.tree.map(jnp.asarray, params), n_stages)
    p = {"stages": jax.tree.map(lambda a: jax.device_put(
             a, NamedSharding(mesh, P(pp.STAGE_AXIS))), host["stages"]),
         "shared": jax.tree.map(lambda a: jax.device_put(
             a, NamedSharding(mesh, P())), host["shared"])}
    tx = optax.sgd(0.1)
    prep_fn, step_fn = pp.make_pp_lm_step(model, mesh, tx, n_micro=n_micro)
    new, _, loss = step_fn(p, tx.init(p), *prep_fn(jnp.asarray(idx),
                                                   _tgt(idx)))
    return _np(pp.unstack_pp_params(new, n_stages)), float(loss)


def ep_step(params, idx, n_data, n_ep, kw, block):
    """The reference's ep SGD step (lr 0.1) of ``MoETransformerLM(**kw)``
    on an ``(n_data, n_ep)`` mesh: ``(new params, loss)``."""
    from fedml_tpu.models.moe import MoETransformerLM
    from fedml_tpu.parallel import expert_parallel as ep
    from fedml_tpu.parallel.tensor_parallel import tp_attention

    mesh = ep.make_ep_mesh(n_data, n_ep,
                           devices=jax.devices()[:n_data * n_ep])
    model = MoETransformerLM(attention_fn=tp_attention(block_size=block),
                             **kw)
    tx = optax.sgd(0.1)
    _, step_fn = ep.make_ep_lm_step(model, mesh, tx)
    p = jax.tree.map(jax.device_put, jax.tree.map(jnp.asarray, params),
                     ep.ep_param_shardings(params, mesh, kw["n_experts"]))
    new, _, loss = step_fn(p, tx.init(p), jnp.asarray(idx), _tgt(idx))
    return _np(new), float(loss)


def assert_step_matches(port_new, port_loss, ref_new, ref_loss, label=""):
    """The port's step (``port_new``: torch names, numpy) against the
    reference's (``ref_new``: flax tree)."""
    np.testing.assert_allclose(port_loss, ref_loss, rtol=LOSS_RTOL,
                               err_msg=f"{label} loss")
    got = dict(jax.tree_util.tree_leaves_with_path(lm_state_to_variables(
        {"params": {k: torch.as_tensor(v) for k, v in port_new.items()}})))
    want = jax.tree_util.tree_leaves_with_path({"params": ref_new})
    assert len(got) == len(want), label
    for path, leaf in want:
        np.testing.assert_allclose(got[path], leaf, atol=PARAM_TOL,
                                   rtol=PARAM_TOL,
                                   err_msg=f"{label} {path}")
