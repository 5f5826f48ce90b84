"""The port's attention ops against the JAX package on the same inputs:
the plain versions of the flash-attention kernels (``ops/flash_attention.py``)
against ``pallas_attention._fa_fwd``/``_fa_bwd`` (Pallas in interpret
mode on the CPU), ``mha`` and ``blockwise_attention`` against theirs, and
the autograd Function on CPU tensors against autograd through ``mha``.

Inputs are made with numpy from a seed, fp32 (and the forward's and
backward's also in bf16, the LM path's dtype). Tolerances: 2e-5 on the
forward (the JAX package's own, ``tests/test_ops.py``), 1e-5 on the
backward (tighter than its gradient tolerance of 5e-4; the observed error
is about 1e-6): fp32 sums in another order; one bf16 ulp on the bf16
forward and backward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import attention as jattn
from fedml_tpu.ops import pallas_attention as jpa
from fedml_tpu_torch.ops import attention as tattn
from fedml_tpu_torch.ops import flash_attention as fa

B, H, D, BLOCK = 2, 2, 16, 16


def _np(seed, t):
    return np.random.default_rng(seed).standard_normal(
        (B, t, H, D)).astype(np.float32)


def _inputs(tq, tk):
    return _np(1, tq), _np(2, tk), _np(3, tk)


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


CASES = [(False, 24, 24), (True, 24, 24), (False, 40, 24), (True, 40, 24)]


@pytest.mark.parametrize("causal,tq,tk", CASES)
def test_plain_forward_matches_pallas_fwd(causal, tq, tk):
    q, k, v = _inputs(tq, tk)
    o_ref, (_, _, _, _, lse_ref) = jpa._fa_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, BLOCK,
        BLOCK)
    o, lse = fa.flash_attention_fwd(*_t(q, k, v), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5)
    # the port keeps lse as [B, H, Tq]; the reference's wrapper [B, Tq, H]
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_ref).transpose(0, 2, 1),
                               atol=2e-5)


@pytest.mark.parametrize("causal,tq,tk", CASES)
def test_plain_backward_matches_pallas_bwd(causal, tq, tk):
    q, k, v = _inputs(tq, tk)
    g = _np(4, tq)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_ref, res = jpa._fa_fwd(jq, jk, jv, causal, None, BLOCK, BLOCK)
    want = jpa._fa_bwd(causal, None, BLOCK, BLOCK, res, jnp.asarray(g))
    tq_, tk_, tv_, tg = _t(q, k, v, g)
    o, lse = fa.flash_attention_fwd(tq_, tk_, tv_, causal)
    delta = (tg * o).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd_reference(tq_, tk_, tv_, tg, lse, delta,
                                           causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _bf16(x):
    """numpy (or a JAX array's values) -> bf16 tensor, rounded to nearest
    even as ``jnp.asarray(x, jnp.bfloat16)`` rounds."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("causal,tq,tk", CASES)
def test_plain_backward_matches_pallas_bwd_in_bf16(causal, tq, tk):
    """The kernels' oracle in the main path's dtype: both backwards take
    the same bf16 q, k, v, dO and the JAX forward's O and lse, and round
    p and ds to bf16 before their second product. Tolerance one bf16 ulp
    at the outputs' magnitude, 2^-8 * max|ref| (the card tests hold the
    kernels to this oracle at 1.6e-2 * max|ref| + 1e-3): both round fp32
    sums taken in another order (the Pallas kernel scales each tile's dq
    and dk, the plain version the sum) to bf16. Observed: 0."""
    q, k, v = _inputs(tq, tk)
    g = _np(4, tq)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    _, res = jpa._fa_fwd(jq, jk, jv, causal, None, BLOCK, BLOCK)
    want = jpa._fa_bwd(causal, None, BLOCK, BLOCK, res, jg)
    out, lse = _bf16(res[3]), torch.from_numpy(np.array(res[4]))
    tq_, tk_, tv_, tg = (_bf16(x) for x in (q, k, v, g))
    delta = (tg.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd_reference(
        tq_, tk_, tv_, tg, lse.transpose(1, 2).contiguous(), delta, causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        ref = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - ref).max()
        assert err <= 2.0 ** -8 * np.abs(ref).max(), err


@pytest.mark.parametrize("causal,tq,tk", CASES)
def test_plain_forward_matches_pallas_fwd_in_bf16(causal, tq, tk):
    """The forward kernel's oracle in the main path's dtype: both forwards
    take the same bf16 q, k, v and round p to bf16 before the PV product.
    O is held to one bf16 ulp at the magnitude of max|ref|,
    2^(floor(log2 max|ref|) - 7), between 2^-8 and 2^-7 times max|ref|
    (the card tests hold the kernel to this oracle at 1.6e-2 * max|ref| +
    1e-3): Pallas rounds p against a 16-key running maximum, the plain
    version against the whole row's, so an fp32 O a hair apart may round
    to the neighbouring bf16 value. lse is fp32 on both sides, at 2e-5.
    Observed: O one ulp non-causal at Tq 24 (0.0078 at max|ref| 1.12),
    a quarter or half of one elsewhere; lse 4.8e-7."""
    q, k, v = _inputs(tq, tk)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o_ref, res = jpa._fa_fwd(jq, jk, jv, causal, None, BLOCK, BLOCK)
    o, lse = fa.flash_attention_fwd(*(_bf16(x) for x in (q, k, v)), causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = np.asarray(o_ref, np.float32)
    err = np.abs(o.float().numpy() - ref).max()
    assert err <= 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7), err
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(res[4]).transpose(0, 2, 1),
                               atol=2e-5)


def test_fully_masked_rows_give_zero_lse():
    """Keys at or past ``k_len`` are masked (the Pallas kernel's
    ``seq_len``, applied when the kernel masks at all: causal here); with
    none left every row is fully masked."""
    q, k, v = _inputs(24, 24)
    o_ref, lse_ref = jpa._fwd_one_head(
        jnp.asarray(q[0, :, 0]), jnp.asarray(k[0, :, 0]),
        jnp.asarray(v[0, :, 0]), scale=D ** -0.5, causal=True,
        block_q=BLOCK, block_k=8, k_len=0, interpret=True)
    o, lse = fa.flash_attention_fwd(*_t(q, k, v), True, k_len=0)
    assert np.all(np.asarray(lse_ref)[:, 0] == 0.0)
    assert torch.equal(lse, torch.zeros_like(lse))
    assert torch.equal(o, torch.zeros_like(o))
    np.testing.assert_array_equal(o[0, :, 0].numpy(), np.asarray(o_ref))


@pytest.mark.parametrize("causal", [False, True])
def test_mha_matches_jax(causal):
    q, k, v = _inputs(40, 24)
    want = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    got = tattn.mha(*_t(q, k, v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal,offsets", [(False, (0, 0)), (True, (0, 0)),
                                            (True, (16, 4))])
def test_blockwise_attention_matches_jax(causal, offsets):
    q, k, v = _inputs(24, 40)
    bias = np.random.default_rng(5).standard_normal(
        (1, H, 1, 40)).astype(np.float32)
    kw = dict(block_size=16, causal=causal, q_offset=offsets[0],
              k_offset=offsets[1])
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), bias=jnp.asarray(bias),
                                     **kw)
    got = tattn.blockwise_attention(*_t(q, k, v),
                                    bias=torch.from_numpy(bias), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_gradients_match_mha(causal):
    q, k, v = _t(*_inputs(24, 24))
    g = torch.from_numpy(_np(6, 24))
    grads = []
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c, causal),
               lambda a, b, c: tattn.mha(a, b, c, causal)):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*xs).backward(g)
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_cpu_path_launches_no_kernel():
    before = dict(fa.launches)
    q, k, v = _t(*_inputs(24, 24))
    fa.flash_attention(q.requires_grad_(True), k, v, True).sum().backward()
    assert fa.launches == before
