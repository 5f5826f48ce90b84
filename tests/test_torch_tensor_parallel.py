"""The port's tensor parallelism (``parallel/tensor_parallel.py``,
``parallel/collectives.py``) against the reference's
(``fedml_tpu/parallel/tensor_parallel.py``).

The port's side runs in one spawned gloo group of 2 and of 4 ranks
(``tests/torch_dist.py``), the reference's in this process on conftest's
forced CPU devices on a mesh of the same shape, both from the same
weights (flax's initialisers, carried by ``lm_variables_to_state``).
Held, as the reference's ``tests/test_ops.py:242``: one SGD step of a
2-layer LM (vocab 50, 4 heads, d_model 32) on a ``(data, model)`` mesh,
its loss within rtol 1e-5 and every parameter within 1e-4 of the
reference's step, gathered on the ranks (``gather_tp_params``) and on
the host (``tp_gather_params`` over the ranks' shards) in the
reference's layout; every rank holds only its block of the sharded
leaves (its heads' rows of q, k and v). ``tp_param_shardings``'s
validation (``tests/test_ops.py:480``): exact name components, an
unknown 2-D leaf raises, an indivisible dim raises. The carrier's
shard and gather round-trip exactly."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import numpy as np
import pytest
import torch

import parallel_reference as ref
import torch_dist
import torch_dist_cases as cases
from fedml_tpu_torch.parallel import tensor_parallel as tp
from fedml_tpu_torch.utils.torch_import import (tp_gather_params,
                                                tp_shard_params)

KW = dict(vocab_size=50, n_layers=2, n_heads=4, d_model=32, max_len=64)


@pytest.fixture(scope="module", params=[2, 4])
def group(request):
    g = torch_dist.RankGroup(request.param)
    try:
        yield g
    finally:
        g.close()


@pytest.fixture(scope="module")
def weights():
    return ref.lm_params(KW, 1, 32)


@pytest.mark.parametrize("n_data", [1, 2])
def test_tp_step_matches_the_reference(group, weights, n_data):
    n_model = group.n // n_data
    idx = np.random.default_rng(0).integers(0, 50, (4, 32))
    ref_new, ref_loss = ref.tp_step(weights, idx, n_data, n_model, KW, 32)
    params = ref.port_params(weights)
    outs = group.run(cases.tp_step, params, idx, n_data, KW, 32)
    specs = tp.tp_param_shardings(params, types.SimpleNamespace(
        shape={"model": n_model}))
    by_coord = {o["coord"]: o for o in outs}
    assert sorted(by_coord) == [(d, m) for d in range(n_data)
                                for m in range(n_model)]
    for out in outs:
        assert out["mesh"] == {"data": n_data, "model": n_model}
        ref.assert_step_matches(out["gathered"], out["loss"], ref_new,
                                ref_loss, f"rank {out['coord']}")
        for k, v in out["local"].items():
            whole = params[k].shape
            want = (whole if "model" not in specs[k] else tuple(
                s // n_model if d == specs[k].index("model") else s
                for d, s in enumerate(whole)))
            assert v.shape == want, (k, v.shape, whole)
    host = tp_gather_params([by_coord[(0, m)]["local"]
                             for m in range(n_model)], specs)
    for k, v in host.items():
        np.testing.assert_array_equal(v.numpy(), outs[0]["gathered"][k])


def test_tp_shard_takes_each_ranks_heads():
    """A rank's ``qkv`` rows are its heads' rows of q, k and v; shard
    then gather is the identity."""
    C, n = 8, 2
    qkv = torch.arange(3 * C * 2, dtype=torch.float32).reshape(3 * C, 2)
    params = {"blocks.0.qkv.weight": qkv,
              "blocks.0.proj.weight": torch.arange(64.).reshape(8, 8),
              "blocks.0.mlp_up.bias": torch.arange(4.)}
    specs = tp.tp_param_shardings(params, types.SimpleNamespace(
        shape={"model": n}))
    shards = [tp_shard_params(params, specs, n, r) for r in range(n)]
    rows = [torch.cat([qkv[j * C + r * 4:j * C + (r + 1) * 4]
                       for j in range(3)]) for r in range(n)]
    for r in range(n):
        assert torch.equal(shards[r]["blocks.0.qkv.weight"], rows[r])
        assert torch.equal(shards[r]["blocks.0.proj.weight"],
                           params["blocks.0.proj.weight"][:, r * 4:
                                                          (r + 1) * 4])
        assert torch.equal(shards[r]["blocks.0.mlp_up.bias"],
                           params["blocks.0.mlp_up.bias"])
    back = tp_gather_params(shards, specs)
    for k, v in params.items():
        assert torch.equal(back[k], v)


def test_tp_param_shardings_validation():
    # exact-component matching: an unknown >=2D param raises instead of
    # silently replicating; 'projector' must NOT match row-parallel
    # 'proj'; indivisible sharded dims raise
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    good = {"blocks.0.qkv.weight": torch.zeros(24, 8),
            "blocks.0.proj.weight": torch.zeros(8, 8),
            "blocks.0.ln1.weight": torch.zeros(8),
            "tok_embed.weight": torch.zeros(50, 8)}
    sh = tp.tp_param_shardings(good, mesh)
    assert "model" in sh["blocks.0.qkv.weight"]
    assert sh["blocks.0.proj.weight"] == (None, "model")
    assert sh["tok_embed.weight"] == () and sh["blocks.0.ln1.weight"] == ()

    with pytest.raises(ValueError, match="no Megatron placement"):
        tp.tp_param_shardings(
            {"blocks.0.projector.weight": torch.zeros(8, 8)}, mesh)

    with pytest.raises(ValueError, match="does not divide"):
        tp.tp_param_shardings(
            {"blocks.0.qkv.weight": torch.zeros(9, 8)}, mesh)
