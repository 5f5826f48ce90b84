"""The arithmetic of the fp32 flash-attention kernels' tensor-core
products (3xTF32), on the CPU.

The fp32 B2, B3 and B4 kernels (``csrc/flash_attention.cu``) split each
fp32 operand as they read it, ``x = hi + lo`` with both parts rounded to
TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero),
and take each product as ``lo.hi + hi.lo + hi.hi`` on the tensor cores.
``ops/flash_attention.py`` ``tf32_split`` emulates that rounding on the
bits, and ``flash_attention_fwd_tf32_reference`` and
``flash_attention_bwd_tf32_reference`` are the plain forward and
backward with each of their products taken from those parts. Here the
split is held to the rounding's definition, and the 3-pass forward and
backward to the fp32 plain versions at the card's fp32 tolerance
(``1e-4 * max|ref| + 1e-5``, as ``tests/test_torch_cuda.py`` holds the
kernels) and to the JAX package's ``_fa_fwd`` and ``_fa_bwd`` (Pallas in
interpret mode) at 1e-5, as ``tests/test_torch_attention.py`` holds the
plain versions. One-pass TF32 on the same inputs misses that tolerance:
its error is about 3e-4 to 1e-3 of max|ref| (three decimal digits), the
3-pass one's below 1e-6. Inputs are made with numpy from a seed.
"""

import struct

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import pallas_attention as jpa
from fedml_tpu_torch.ops import flash_attention as fa

B, H, BLOCK = 2, 2, 16


def _f32(bits):
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _bits(x):
    return [b & 0xFFFFFFFF for b in x.view(torch.int32).tolist()]


# (input bits, bits of its TF32 rounding): exact, below a tie, ties away
# from zero on either sign (also with an odd kept bit), a carry into the
# exponent, overflow to inf, zeros, a subnormal, inf and NaN
ROUNDING = [(0x3F800000, 0x3F800000), (0x3F800FFF, 0x3F800000),
            (0x3F801000, 0x3F802000), (0xBF801000, 0xBF802000),
            (0x3F803000, 0x3F804000), (0x3F801001, 0x3F802000),
            (0x3FFFF000, 0x40000000), (0x7F7FFFFF, 0x7F800000),
            (0x00000000, 0x00000000), (0x80000000, 0x80000000),
            (0x00001000, 0x00002000), (0x7F800000, 0x7F800000),
            (0xFF800000, 0xFF800000), (0x7FC00000, 0x7FC00000)]


def test_tf32_split_rounds_to_nearest_ties_away():
    x = torch.tensor([_f32(b) for b, _ in ROUNDING])
    hi, _ = fa.tf32_split(x)
    assert _bits(hi) == [want for _, want in ROUNDING]


def test_tf32_split_parts_are_tf32_and_sum_to_x():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32) * 10.0 ** np.random.default_rng(1)
        .integers(-20, 20, 100_000).astype(np.float32))
    hi, lo = fa.tf32_split(x)
    assert all(b & 0x1FFF == 0 for b in _bits(hi) + _bits(lo))
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs())
    # hi keeps 11 significant bits, lo the next 11 of the 13 dropped
    assert float(rel.max()) <= 2.0 ** -22
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -11


def _np(seed, t, D):
    return np.random.default_rng(seed).standard_normal(
        (B, t, H, D)).astype(np.float32)


def _inputs(tq, tk, D):
    return tuple(torch.from_numpy(x) for x in (
        _np(1, tq, D), _np(2, tk, D), _np(3, tk, D), _np(4, tq, D)))


def _bwd_args(q, k, v, do, causal, k_len=None):
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, k_len=k_len)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, causal


def _rel_err(got, want):
    """Largest error of each tensor (O, lse; dq, dk, dv) over max|want| +
    0.1 (so that
    the card's ``1e-4 * max|ref| + 1e-5`` is about ``err <= 1e-4``)."""
    return [float((g - w).abs().max()) / (float(w.abs().max()) + 0.1)
            for g, w in zip(got, want)]


def _within_card_tol(got, want):
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-5, err


# (causal, Tq, Tk, D, k_len): square and ragged, the kernels' head dims
# cut to 16 and 32 where the point is the product, and keys past k_len
CASES = [(False, 24, 24, 16, None), (True, 24, 24, 16, None),
         (False, 40, 24, 32, None), (True, 40, 24, 32, None),
         (False, 33, 50, 32, 37), (True, 50, 50, 16, 21)]


@pytest.mark.parametrize("causal,tq,tk,D,k_len", CASES)
def test_3xtf32_backward_holds_the_fp32_tolerance(causal, tq, tk, D, k_len):
    """The 3-pass backward against the fp32 plain backward at the card's
    fp32 tolerance; one-pass TF32 on the same inputs misses it."""
    args = _bwd_args(*_inputs(tq, tk, D), causal, k_len)
    want = fa.flash_attention_bwd_reference(*args, k_len=k_len)
    got = fa.flash_attention_bwd_tf32_reference(*args, k_len=k_len)
    _within_card_tol(got, want)
    one = fa.flash_attention_bwd_tf32_reference(*args, k_len=k_len,
                                                passes=1)
    err3, err1 = _rel_err(got, want), _rel_err(one, want)
    assert max(err3) < 1e-6, err3
    assert max(err1) > 1e-4, err1
    assert all(a > 20 * b for a, b in zip(err1, err3)), (err1, err3)


@pytest.mark.parametrize("causal,tq,tk,D,k_len",
                         [c for c in CASES if c[4] is None])
def test_3xtf32_backward_matches_pallas_bwd(causal, tq, tk, D, k_len):
    """The 3-pass backward against the JAX package's ``_fa_bwd`` on its
    own forward's residuals, as the plain backward is held in
    ``tests/test_torch_attention.py``."""
    q, k, v, g = (x.numpy() for x in _inputs(tq, tk, D))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _, res = jpa._fa_fwd(jq, jk, jv, causal, None, BLOCK, BLOCK)
    want = jpa._fa_bwd(causal, None, BLOCK, BLOCK, res, jnp.asarray(g))
    tq_, tk_, tv_, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = fa.flash_attention_fwd(tq_, tk_, tv_, causal)
    delta = (tg * o).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd_tf32_reference(tq_, tk_, tv_, tg, lse,
                                                delta, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# (causal, Tq, Tk, D, k_len): the kernels' head dims, square and ragged
# both ways, keys past a k_len inside a 16-key group, and no key at all
# (k_len 0)
FWD_CASES = [(False, 24, 24, 64, None), (True, 24, 24, 128, None),
             (False, 40, 24, 64, None), (True, 40, 24, 128, None),
             (True, 24, 40, 64, None), (False, 33, 50, 128, 37),
             (True, 50, 50, 64, 21), (True, 24, 40, 128, 0)]


@pytest.mark.parametrize("causal,tq,tk,D,k_len", FWD_CASES)
def test_3xtf32_forward_holds_the_fp32_tolerance(causal, tq, tk, D, k_len):
    """The 3-pass forward's O and lse against the fp32 plain forward at
    the card's fp32 tolerance; one-pass TF32 on the same inputs misses it
    on O. With k_len 0 every row is fully masked: O and lse are 0."""
    q, k, v, _ = _inputs(tq, tk, D)
    want = fa.flash_attention_fwd_reference(q, k, v, causal, k_len=k_len)
    got = fa.flash_attention_fwd_tf32_reference(q, k, v, causal,
                                                k_len=k_len)
    _within_card_tol(got, want)
    one = fa.flash_attention_fwd_tf32_reference(q, k, v, causal,
                                                k_len=k_len, passes=1)
    if k_len == 0:
        assert all(torch.equal(x, torch.zeros_like(x)) for x in got + one)
        return
    (err3,), (err1,) = _rel_err(got[:1], want[:1]), _rel_err(one[:1],
                                                             want[:1])
    assert err3 < 1e-6, err3
    assert err1 > 1e-4, err1
    assert err1 > 20 * err3, (err1, err3)


@pytest.mark.parametrize("causal,tq,tk,D,k_len",
                         [c for c in FWD_CASES if c[4] is None])
def test_3xtf32_forward_matches_pallas_fwd(causal, tq, tk, D, k_len):
    """The 3-pass forward against the JAX package's ``_fa_fwd``, as the
    plain forward is held in ``tests/test_torch_attention.py`` (lse kept
    as [B, H, Tq] by the port, [B, Tq, H] by the reference's wrapper)."""
    q, k, v, _ = (x.numpy() for x in _inputs(tq, tk, D))
    o_ref, (_, _, _, _, lse_ref) = jpa._fa_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, BLOCK,
        BLOCK)
    o, lse = fa.flash_attention_fwd_tf32_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_ref).transpose(0, 2, 1),
                               atol=1e-5)
