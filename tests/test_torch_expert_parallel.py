"""The port's expert parallelism (``parallel/expert_parallel.py``)
against the reference's (``fedml_tpu/parallel/expert_parallel.py``).

The port's side runs in spawned gloo groups of 2 and 4 ranks, and of 8
for the reference's ``(2, 4)`` mesh (``tests/test_ops.py:349``); the
reference's in this process on conftest's forced CPU devices on a mesh
of the same shape, both from the same weights. Held: one SGD step of
the MoE LM (vocab 50, 2 layers, 2 heads, d_model 16, 4 experts, the
loss ``lm_loss + MOE_AUX_WEIGHT * aux``) on ``(data, expert)`` meshes
with one and two ``data`` rows, its loss within rtol 1e-5 and every
parameter within 1e-4 of the reference's, whose routing, capacity and
queue order are the global batch's: with ``n_data > 1`` a rank that
routed only its own tokens would drop others. Every rank holds only its
experts. ``ep_param_shardings``'s validation (``tests/test_ops.py:507``):
only ``moe`` ``wi``/``wo`` shard, a wrong expert count raises, an
indivisible one raises."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import numpy as np
import pytest
import torch

import parallel_reference as ref
import torch_dist
import torch_dist_cases as cases
from fedml_tpu_torch.parallel import expert_parallel as ep

KW = dict(vocab_size=50, n_layers=2, n_heads=2, d_model=16, max_len=32,
          n_experts=4)


@pytest.fixture(scope="module", params=[2, 4, 8])
def group(request):
    g = torch_dist.RankGroup(request.param)
    try:
        yield g
    finally:
        g.close()


@pytest.fixture(scope="module")
def weights():
    return ref.lm_params(KW, 1, 16, moe=True)


def _check(group, weights, n_data):
    n_ep = group.n // n_data
    idx = np.random.default_rng(0).integers(0, 50, (4, 16))
    ref_new, ref_loss = ref.ep_step(weights, idx, n_data, n_ep, KW, 16)
    outs = group.run(cases.ep_step, ref.port_params(weights), idx, n_data,
                     KW, 16)
    assert sorted(o["coord"] for o in outs) == [
        (d, e) for d in range(n_data) for e in range(n_ep)]
    for out in outs:
        assert out["mesh"] == {"data": n_data, "expert": n_ep}
        ref.assert_step_matches(out["gathered"], out["loss"], ref_new,
                                ref_loss, f"rank {out['coord']}")
        for k, v in out["local"].items():
            if k.endswith(("moe.wi", "moe.wo")):
                assert v.shape[0] == KW["n_experts"] // n_ep, (k, v.shape)


#: the ``data`` sizes of each group's two meshes (8 ranks: the
#: reference's (2, 4) and (4, 2); a (1, 8) mesh has more ranks than the
#: 4 experts)
N_DATA = {2: (1, 2), 4: (1, 2), 8: (2, 4)}


@pytest.mark.parametrize("which", [0, 1])
def test_ep_step_matches_the_reference(group, weights, which):
    _check(group, weights, N_DATA[group.n][which])


def test_ep_param_shardings_validation():
    # anchored matching: only moe.{wi,wo} shard; a stray param ending in
    # 'wi' replicates; wrong expert counts raise
    mesh = types.SimpleNamespace(shape={"data": 1, "expert": 2})
    params = {"blocks.0.moe.wi": torch.zeros(4, 8, 16),
              "blocks.0.moe.wo": torch.zeros(4, 16, 8),
              "blocks.0.moe.router.weight": torch.zeros(4, 8),
              "blocks.0.kiwi": torch.zeros(3, 8)}
    sh = ep.ep_param_shardings(params, mesh, n_experts=4)
    assert "expert" in sh["blocks.0.moe.wi"]
    assert sh["blocks.0.kiwi"] == ()
    assert sh["blocks.0.moe.router.weight"] == ()

    with pytest.raises(ValueError, match="!= n_experts"):
        ep.ep_param_shardings(params, mesh, n_experts=8)
    bad = {"moe.wi": torch.zeros(3, 8, 16)}
    with pytest.raises(ValueError, match="not divisible"):
        ep.ep_param_shardings(bad, mesh)
