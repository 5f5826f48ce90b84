"""Head dims above 128 against the JAX package on the same inputs: the
plain versions of the flash-attention kernels (``ops/flash_attention.py``)
against ``pallas_attention._fa_fwd``/``_fa_bwd`` (Pallas in interpret mode
on the CPU) at D 256, 384 and 512, the kernels' head-dim rule against the
reference's ``_require_hw_head_dim`` on the TPU, and one training step of
the port's ``TransformerLM`` at head dim 256 against the Flax model.

Inputs are made with numpy from a seed. Tolerances are those of
``tests/test_torch_attention.py``: fp32 forward 2e-5 and backward 1e-5
(sums in another order); bf16 forward one bf16 ulp at the magnitude of
max|ref| and bf16 backward 2^-8 * max|ref| (both round fp32 results to
bf16). The step: logits and loss 1e-5 and gradients 1e-4, as
``tests/test_torch_transformer.py`` holds them (fp32 sums in another
order, over 256 terms here instead of 32), and the weights after one SGD
step at lr 0.1 1e-5.
"""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.models.transformer import lm_loss as jax_lm_loss
from fedml_tpu.ops import pallas_attention as jpa
from fedml_tpu_torch.models.transformer import TransformerLM, lm_loss
from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.utils.torch_import import lm_variables_to_state
from seeded_variables import seeded_variables

B, H, BLOCK = 2, 1, 16

# (causal, Tq, Tk): square, and Tq > Tk
CASES = [(False, 24, 24), (True, 24, 24), (False, 40, 24), (True, 40, 24)]


def _np(seed, t, D):
    return np.random.default_rng(seed).standard_normal(
        (B, t, H, D)).astype(np.float32)


def _inputs(tq, tk, D):
    return _np(1, tq, D), _np(2, tk, D), _np(3, tk, D), _np(4, tq, D)


def _bf16(x):
    """numpy (or a JAX array's values) -> bf16 tensor, rounded to nearest
    even as ``jnp.asarray(x, jnp.bfloat16)`` rounds."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("D", [256, 384, 512])
@pytest.mark.parametrize("causal,tq,tk", CASES)
def test_plain_versions_match_pallas_in_fp32(causal, tq, tk, D):
    q, k, v, g = _inputs(tq, tk, D)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o_ref, res = jpa._fa_fwd(jq, jk, jv, causal, None, BLOCK, BLOCK)
    want = jpa._fa_bwd(causal, None, BLOCK, BLOCK, res, jnp.asarray(g))
    tq_, tk_, tv_, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = fa.flash_attention_fwd(tq_, tk_, tv_, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(res[4]).transpose(0, 2, 1),
                               atol=2e-5)
    delta = (tg * o).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd_reference(tq_, tk_, tv_, tg, lse, delta,
                                           causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("D", [256, 384, 512])
@pytest.mark.parametrize("causal,tq,tk", CASES)
def test_plain_versions_match_pallas_in_bf16(causal, tq, tk, D):
    """Both sides take the same bf16 q, k, v (and dO, with the JAX
    forward's O and lse) and round p and ds to bf16 before their second
    products."""
    q, k, v, g = _inputs(tq, tk, D)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    o_ref, res = jpa._fa_fwd(jq, jk, jv, causal, None, BLOCK, BLOCK)
    want = jpa._fa_bwd(causal, None, BLOCK, BLOCK, res, jg)
    tq_, tk_, tv_, tg = (_bf16(x) for x in (q, k, v, g))
    o, lse = fa.flash_attention_fwd(tq_, tk_, tv_, causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = np.asarray(o_ref, np.float32)
    err = np.abs(o.float().numpy() - ref).max()
    assert err <= 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7), err
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(res[4]).transpose(0, 2, 1),
                               atol=2e-5)
    out, jlse = _bf16(res[3]), torch.from_numpy(np.array(res[4]))
    delta = (tg.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd_reference(
        tq_, tk_, tv_, tg, jlse.transpose(1, 2).contiguous(), delta, causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        ref = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - ref).max()
        assert err <= 2.0 ** -8 * np.abs(ref).max(), err


@pytest.mark.parametrize("D", [48, 64, 96, 128, 192, 256, 384, 512])
def test_head_dims_are_the_references_on_the_tpu(D):
    """The kernels take what the reference's Pallas kernels take on the
    TPU (a multiple of 128), and D 64 besides; every other head dim is
    refused with the message that names ``blockwise_attention``."""
    try:
        jpa._require_hw_head_dim(D, interpret=False)
        reference_takes = True
    except ValueError:
        reference_takes = False
    assert fa.head_dim_supported(D) == (reference_takes or D == 64)
    q = torch.zeros(1, 4, 1, D)
    if fa.head_dim_supported(D):
        assert fa._check_cuda((q, q, q)) == 0
    else:
        with pytest.raises(ValueError, match="blockwise_attention"):
            fa._check_cuda((q, q, q))


V, LAYERS, D_MODEL, HEADS, T, NB = 90, 2, 256, 1, 16, 3


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab_size=V, n_layers=LAYERS, n_heads=HEADS,
               d_model=D_MODEL, max_len=T, dtype=jnp.float32)
    variables = seeded_variables(jm, np.zeros((1, T), np.int32), seed=7)
    tm = TransformerLM(V, n_layers=LAYERS, n_heads=HEADS, d_model=D_MODEL,
                       max_len=T, dtype=torch.float32)
    return jm, tm, variables


def test_lm_step_at_head_dim_256_matches_flax(lm):
    """One SGD step of the TransformerLM with one head of 256 (the port
    through its flash attention's plain versions, the reference through
    its Pallas kernels in interpret mode): logits, loss, every gradient
    and the stepped weights."""
    jm, tm, variables = lm
    assert D_MODEL // tm.n_heads == 256
    rng = np.random.default_rng(8)
    idx = rng.integers(0, V, (NB, T)).astype(np.int32)
    tgt = rng.integers(-1, V, (NB, T)).astype(np.int32)

    def jloss(params):
        return jax_lm_loss(jm.apply({"params": params}, jnp.asarray(idx)),
                           jnp.asarray(tgt))

    jl, jg = jax.value_and_grad(jloss)(variables["params"])
    params = {k: v.requires_grad_(True) for k, v in
              lm_variables_to_state(variables)["params"].items()}
    logits = tm.apply_params(params, torch.from_numpy(idx))
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jm.apply(variables, jnp.asarray(idx))), atol=1e-5)
    loss = lm_loss(logits, torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=1e-5)
    want = lm_variables_to_state({"params": jg})["params"]
    stepped = lm_variables_to_state({"params": jax.tree.map(
        lambda p, g: p - 0.1 * g, variables["params"], jg)})["params"]
    for (n, p), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-4,
                                   err_msg=n)
        np.testing.assert_allclose((p - 0.1 * g).detach().numpy(),
                                   stepped[n].numpy(), atol=1e-5,
                                   err_msg=n)
