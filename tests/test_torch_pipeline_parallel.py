"""The port's pipeline parallelism (``parallel/pipeline_parallel.py``,
``collectives.stage_hop``) against the reference's
(``fedml_tpu/parallel/pipeline_parallel.py``).

The port's side runs in one spawned gloo group of 2 and of 4 ranks, a
stage a rank; the reference's in this process on conftest's forced CPU
devices over as many stages, both from the same weights. Held, as the
reference's ``tests/test_ops.py:281`` and ``:428``: one GPipe SGD step
of an LM (vocab 50, 2 heads, d_model 32) with 2 microbatches and the
model's default attention (the flash attention's plain version here,
the kernels on a card), one block a stage and two, its loss within
rtol 1e-5 and every parameter within 1e-4 of the reference's step once
gathered and unstacked; every rank holds only its stage's blocks. The
refusals (``:467``): ragged layers at init, at the step builder and in
the stacking, and a batch that does not split into the microbatches.
The carrier's stack and unstack round-trip exactly."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import pytest
import torch

import parallel_reference as ref
import torch_dist
import torch_dist_cases as cases
from fedml_tpu_torch.utils.torch_import import (stack_pp_params,
                                                unstack_pp_params)

KW = dict(vocab_size=50, n_heads=2, d_model=32, max_len=32)


@pytest.fixture(scope="module", params=[2, 4])
def group(request):
    g = torch_dist.RankGroup(request.param)
    try:
        yield g
    finally:
        g.close()


@pytest.mark.parametrize("per_stage", [1, 2])
def test_pp_step_matches_the_reference(group, per_stage):
    S = group.n
    weights = ref.lm_params(dict(KW, n_layers=per_stage * S), 3, 16)
    idx = np.random.default_rng(2).integers(0, 50, (4, 16))
    ref_new, ref_loss = ref.pp_step(weights, idx, S, KW, n_micro=2)
    outs = group.run(cases.pp_step, ref.port_params(weights), idx, KW, 2)
    for rank, out in enumerate(outs):
        ref.assert_step_matches(out["params"], out["loss"], ref_new,
                                ref_loss, f"stage {rank}")
        for k, v in out["stage"].items():
            np.testing.assert_array_equal(
                v, np.stack([out["params"][f"blocks.{rank * per_stage + j}"
                                           f".{k}"]
                             for j in range(per_stage)]))


def test_pp_refuses_ragged_layers_and_batches(group):
    for out in group.run(cases.pp_refusals):
        assert set(out) == {"init", "step", "stack", "micro"}, out
        assert "multiple of" in out["init"]
        assert "multiple of" in out["step"]
        assert "multiple of" in out["stack"]
        assert "not divisible by n_micro=3" in out["micro"]


def test_pp_stack_round_trips():
    params = {"tok_embed.weight": torch.randn(5, 4),
              **{f"blocks.{i}.{n}": torch.randn(3, 4) * i
                 for i in range(4) for n in ("qkv.weight", "ln1.bias")},
              "head.bias": torch.randn(5)}
    pp = stack_pp_params(params, 2)
    assert pp["stages"]["qkv.weight"].shape == (2, 2, 3, 4)
    assert torch.equal(pp["stages"]["ln1.bias"][1, 0],
                       params["blocks.2.ln1.bias"])
    assert sorted(pp["shared"]) == ["head.bias", "tok_embed.weight"]
    back = unstack_pp_params(pp, 2)
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert torch.equal(back[k], v)
    with pytest.raises(ValueError, match="non-contiguous"):
        stack_pp_params({"blocks.1.x": torch.zeros(1)}, 1)
