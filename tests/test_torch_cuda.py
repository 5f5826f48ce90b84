"""Tests of the port that need an NVIDIA GPU: the hand-written kernels
against their plain PyTorch versions on the card. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up for the
CPU suite). Without a GPU every test skips.

Tolerances. Grouped-conv dW (B1), either kernel: max|err| <=
1e-3*max|ref| + 1e-3 against the plain version computed in fp32 from the
same inputs -- the same bf16 or fp32 products, fp32 sums taken in
another order over K = B*Ho*Wo up to 65,536. Flash
attention (B2-B4): against the plain versions on the same inputs in the
same dtype; fp32 max|err| <= 1e-4*max|ref| + 1e-5 (sums in another
order); bf16 max|err| <= 1.6e-2*max|ref| + 1e-3 -- both sides round
their fp32 results to bf16 (one ulp is 2^-8 relative) and the kernel
rounds p to bf16 against its running row maximum, 16 keys at a time in
bf16 (B2) or tile by tile in fp32, where the plain version uses the
final maximum. lse is fp32 on both sides and
held at 1e-4*max|lse| + 1e-5.
"""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import pytest
import torch

from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.ops import grouped_conv

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", 0)


def _close(got, ref):
    err = float((got - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max()) + 1e-3, err


# (L, B, Ci, Co, H, W, k, padding): the main path's four widths at L=8,
# B=64, then odd channel counts, padding 0 and 2, a 5x5 and a 1x1 kernel,
# and spatial sizes that do not fill the kernel's tiles
SHAPES = [(8, 64, 3, 16, 32, 32, 3, 1), (8, 64, 16, 16, 32, 32, 3, 1),
          (8, 64, 32, 32, 16, 16, 3, 1), (8, 64, 64, 64, 8, 8, 3, 1),
          (4, 3, 5, 7, 8, 8, 3, 0), (4, 3, 5, 7, 8, 8, 5, 2),
          (2, 5, 3, 16, 13, 11, 3, 1), (8, 2, 64, 48, 9, 7, 1, 0)]


def _dw_launch(x, dy, L, k, p):
    """dW from the kernel, and the route the launch took."""
    before = dict(grouped_conv.route_launches)
    launches = grouped_conv.launches
    got = grouped_conv.grouped_conv_dw(x, dy, L, k, k, (p, p))
    assert grouped_conv.launches == launches + 1
    took = [r for r, n in grouped_conv.route_launches.items()
            if n != before[r]]
    assert len(took) == 1
    return got, took[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,B,ci,co,H,W,k,p", SHAPES)
def test_kernel_matches_plain_version(cuda, dtype, L, B, ci, co, H, W, k,
                                      p):
    gen = torch.Generator(device=cuda).manual_seed(ci * 100 + co)
    ho, wo = H + 2 * p - k + 1, W + 2 * p - k + 1
    x = torch.randn(B, L * ci, H, W, generator=gen, device=cuda).to(dtype)
    dy = torch.randn(B, L * co, ho, wo, generator=gen, device=cuda).to(dtype)
    got, route = _dw_launch(x, dy, L, k, p)
    # bf16 rows of whole 16-byte chunks take the tensor cores (the main
    # path's four shapes and the 5x5 case); fp32, W 11, 7 and Wo 6 take
    # the CUDA cores
    tensor_core = dtype == torch.bfloat16 and W % 8 == 0 and wo % 8 == 0
    assert route == ("tensor_core" if tensor_core else "cuda_core")
    assert got.dtype == torch.float32 and got.shape == (L * co, ci, k, k)
    _close(got, grouped_conv.grouped_conv_dw_reference(
        x.float(), dy.float(), L, k, k, (p, p)))
    # the split-K sums are reduced in a fixed order: a second call repeats
    # the result bit for bit
    assert torch.equal(got, grouped_conv.grouped_conv_dw(x, dy, L, k, k,
                                                         (p, p)))


# (L, B, Ci, Co, H, W, k, padding), bf16 on the tensor-core kernel: a last
# K tile that is partial (Ho 20 in 8-row tiles, B*Ho*Wo not a multiple of
# the tile) and one taller than the image (Ho 4); Ci/Co of 16, 48, 64 and
# Ci 3; a 1x1 kernel at padding 0 and 5x5 at padding 2; W 64, the widest
# the route takes, at 3x3 and at 5x5 with 64 channels (the most shared
# memory)
MMA_SHAPES = [(2, 3, 16, 16, 20, 16, 3, 1), (2, 2, 16, 16, 4, 8, 3, 1),
              (2, 4, 16, 48, 16, 16, 3, 1), (2, 4, 48, 64, 8, 8, 3, 1),
              (2, 4, 64, 16, 16, 16, 3, 1), (2, 4, 3, 64, 16, 16, 3, 1),
              (2, 3, 16, 32, 16, 16, 1, 0), (2, 3, 32, 16, 16, 16, 5, 2),
              (2, 3, 48, 48, 24, 24, 5, 2), (1, 2, 16, 16, 64, 64, 3, 1),
              (1, 2, 64, 64, 64, 64, 5, 2)]


@pytest.mark.parametrize("L,B,ci,co,H,W,k,p", MMA_SHAPES)
def test_tensor_core_kernel_matches_plain_version(cuda, L, B, ci, co, H, W,
                                                  k, p):
    gen = torch.Generator(device=cuda).manual_seed(ci * 7 + co + H)
    ho, wo = H + 2 * p - k + 1, W + 2 * p - k + 1
    x = torch.randn(B, L * ci, H, W, generator=gen,
                    device=cuda).to(torch.bfloat16)
    dy = torch.randn(B, L * co, ho, wo, generator=gen,
                     device=cuda).to(torch.bfloat16)
    got, route = _dw_launch(x, dy, L, k, p)
    assert route == "tensor_core"
    assert got.dtype == torch.float32 and got.shape == (L * co, ci, k, k)
    _close(got, grouped_conv.grouped_conv_dw_reference(
        x.float(), dy.float(), L, k, k, (p, p)))
    # split-K and the warps' k16 split are merged in a fixed order
    assert torch.equal(got, _dw_launch(x, dy, L, k, p)[0])


@pytest.mark.parametrize("case", ["x_off_16_bytes", "dy_off_16_bytes",
                                  "W_72"])
def test_bf16_outside_the_tensor_core_route_takes_cuda_cores(cuda, case):
    """bf16 inputs the tensor-core kernel does not take -- x or dy not on
    a 16-byte address (a view one element into a buffer), W above 64 --
    go to the CUDA-core kernel and match the plain version."""
    L, B, ci, co, H = 2, 3, 16, 16, (72 if case == "W_72" else 16)
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    bufs = [torch.randn(B * L * c * H * H + 8, generator=gen,
                        device=cuda).to(torch.bfloat16) for c in (ci, co)]
    shift = {"x_off_16_bytes": (1, 0), "dy_off_16_bytes": (0, 1)}.get(
        case, (0, 0))
    x, dy = (b[s:s + B * L * c * H * H].view(B, L * c, H, H)
             for b, s, c in zip(bufs, shift, (ci, co)))
    assert (x.data_ptr() % 16 != 0) == (shift[0] == 1)
    got, route = _dw_launch(x, dy, L, 3, 1)
    assert route == "cuda_core"
    _close(got, grouped_conv.grouped_conv_dw_reference(
        x.float(), dy.float(), L, 3, 3, (1, 1)))


@pytest.mark.parametrize("stride", [1, 2])
def test_lane_conv_pallas_on_card_matches_cpu(cuda, stride):
    """Forward, dX and dW of the autograd Function on the card (fp32)
    against the same Function on CPU tensors; only the stride-1 dW
    launches the kernel."""
    L, B, ci, co, H = 4, 8, 16, 32, 16
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn(B, L * ci, H, H, generator=gen)
    w = torch.randn(L, co, ci, 3, 3, generator=gen) * 0.1
    outs = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).detach().requires_grad_(True)
        wd = w.to(dev).detach().requires_grad_(True)
        before = grouped_conv.launches
        y = grouped_conv.lane_conv_pallas(xd, wd, L, (stride, stride),
                                          (1, 1))
        torch.sin(y).sum().backward()
        launched = grouped_conv.launches - before
        outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    assert launched == (1 if stride == 1 else 0)
    for got, ref in zip(outs[1], outs[0]):
        _close(got, ref)


def _close_rel(got, ref, rel, abs_):
    err = float((got.float() - ref.float()).abs().max())
    assert err <= rel * float(ref.float().abs().max()) + abs_, err


def _tol(dtype):
    return (1e-4, 1e-5) if dtype == torch.float32 else (1.6e-2, 1e-3)


def _qkv_do(dev, dtype, B, Tq, Tk, H, D, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, Tq, H, D, generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Tk, H, D, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


# (B, Tq, Tk, H, D): the LM flagship's launch (8 clients x batch 4 at
# T=80, 4 heads of 128), T of 1 and 129 (one row; one past two tiles),
# Tq != Tk both ways, head dim 64; then the edges of the bf16 kernels'
# 16-row sub-tiles and 32/64-row tiles (T of 15, 16, 17, 33, 63, 65) and
# a T above 128 with Tq != Tk
ATTN_SHAPES = [(32, 80, 80, 4, 128), (2, 1, 1, 2, 128), (2, 129, 129, 2, 64),
               (2, 129, 129, 2, 128), (2, 40, 24, 3, 64),
               (2, 24, 70, 2, 128), (3, 80, 80, 2, 64),
               (2, 15, 15, 2, 128), (2, 16, 16, 2, 64), (2, 17, 17, 2, 128),
               (2, 33, 33, 2, 64), (2, 63, 63, 2, 128), (2, 65, 65, 2, 128),
               (2, 200, 150, 2, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,Tq,Tk,H,D", ATTN_SHAPES)
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, B, Tq, Tk,
                                            H, D):
    q, k, v, do = _qkv_do(cuda, dtype, B, Tq, Tk, H, D, Tq * 7 + Tk + D)
    rel, abs_ = _tol(dtype)
    before = dict(fa.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal)
    assert o.dtype == dtype and lse.shape == (B, H, Tq)
    _close_rel(o, o_ref, rel, abs_)
    _close_rel(lse, lse_ref, 1e-4, 1e-5)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_ref, delta, causal)
    dq = fa.flash_attention_dq(*args)
    dk, dv = fa.flash_attention_dkv(*args)
    for got, ref in zip((dq, dk, dv), fa.flash_attention_bwd_reference(*args)):
        assert got.dtype == dtype and got.shape == ref.shape
        _close_rel(got, ref, rel, abs_)
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "fwd": 1, "dq": 1, "dkv": 1}
    # each output tile has one owner and no atomics: repeats are bit-equal
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(dq, fa.flash_attention_dq(*args))
    assert all(torch.equal(a, b)
               for a, b in zip((dk, dv), fa.flash_attention_dkv(*args)))


def _bwd_args(q, k, v, do, causal, k_len=None):
    """(q, k, v, dO, lse, delta, causal) from the plain forward."""
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, k_len=k_len)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, causal


def _bwd(args, k_len=None):
    """(dq, dk, dv) from the kernels."""
    return ((fa.flash_attention_dq(*args, k_len=k_len),)
            + fa.flash_attention_dkv(*args, k_len=k_len))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("k_len", [0, 1, 37, 64])
def test_flash_backward_masks_keys_past_k_len(cuda, dtype, causal, k_len):
    """Keys at or past ``k_len`` get no attention: dq, dk and dv match the
    plain versions, and with ``k_len = 0`` all three are zero."""
    q, k, v, do = _qkv_do(cuda, dtype, 2, 80, 80, 2, 128, 17 + k_len)
    args = _bwd_args(q, k, v, do, causal, k_len)
    rel, abs_ = _tol(dtype)
    got = _bwd(args, k_len)
    for g, ref in zip(got, fa.flash_attention_bwd_reference(*args,
                                                             k_len=k_len)):
        _close_rel(g, ref, rel, abs_)
    if k_len == 0:
        assert all(torch.equal(g, torch.zeros_like(g)) for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, _bwd(args, k_len)))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Tq,Tk,k_len", [(40, 70, 37), (24, 70, 45),
                                         (70, 40, 37), (80, 50, 21),
                                         (40, 70, 0)])
def test_bf16_causal_forward_masks_keys_past_k_len(cuda, D, Tq, Tk, k_len):
    """The bf16 forward, causal, with ``k_len`` ending inside a 16-key
    sub-tile, Tq < Tk and Tq > Tk, or at 0 (every row fully masked: O and
    lse zero): O and lse match the plain version and a repeat is
    bit-equal."""
    q, k, v, _ = _qkv_do(cuda, torch.bfloat16, 2, Tq, Tk, 2, D,
                         Tq + 3 * Tk + k_len)
    o, lse = fa.flash_attention_fwd(q, k, v, True, k_len=k_len)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, True,
                                                      k_len=k_len)
    _close_rel(o, o_ref, *_tol(torch.bfloat16))
    _close_rel(lse, lse_ref, 1e-4, 1e-5)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, True, k_len=k_len)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    if k_len == 0:
        assert torch.equal(o, torch.zeros_like(o))
        assert torch.equal(lse, torch.zeros_like(lse))


def test_flash_kernels_read_strided_qkv_views(cuda):
    """q, k, v as column slices of one fused qkv product (the model's
    layout) give the same bits as contiguous copies: O and lse, dq, dk
    and dv."""
    B, T, H, D = 4, 80, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(B, T, 3 * H * D, generator=gen,
                      device=cuda).to(torch.bfloat16)
    do = torch.randn(B, T, H, D, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(B, T, H, D)
               for i in range(3))
    assert not q.is_contiguous()
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    oc, lsec = fa.flash_attention_fwd(qc, kc, vc, True)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    got = _bwd(_bwd_args(q, k, v, do, True))
    want = _bwd(_bwd_args(qc, kc, vc, do, True))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_take_views_off_16_byte_rows(cuda, causal):
    """q, k, v and dO whose rows do not start on 16 bytes (views one
    element into a buffer with an odd row stride) are read element by
    element: forward and backward match the plain versions."""
    B, T, H, D = 2, 70, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(9)
    buf = torch.randn(4, B, T, H * D + 1, generator=gen,
                      device=cuda).to(torch.bfloat16)
    q, k, v, do = (buf[i, :, :, 1:].reshape(B, T, H, D) for i in range(4))
    assert q.data_ptr() % 16 and q.stride(1) % 8
    rel, abs_ = _tol(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal)
    _close_rel(o, o_ref, rel, abs_)
    _close_rel(lse, lse_ref, 1e-4, 1e-5)
    args = _bwd_args(q, k, v, do, causal)
    for g, ref in zip(_bwd(args), fa.flash_attention_bwd_reference(*args)):
        _close_rel(g, ref, rel, abs_)


def test_fully_masked_rows_give_zero_output_and_lse(cuda):
    q, k, v, _ = _qkv_do(cuda, torch.float32, 2, 24, 24, 2, 64, 5)
    o, lse = fa.flash_attention_fwd(q, k, v, False, k_len=0)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, torch.zeros_like(lse))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_gradients_match_plain_backward(cuda,
                                                                 causal):
    q, k, v, g = _qkv_do(cuda, torch.float32, 2, 70, 70, 2, 64, 11)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fa.flash_attention(qr, kr, vr, causal)
    o.backward(g)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (g * o_ref).sum(-1).transpose(1, 2).contiguous()
    ref = fa.flash_attention_bwd_reference(q, k, v, g, lse_ref, delta,
                                           causal)
    _close_rel(o.detach(), o_ref, 1e-4, 1e-5)
    for got, want in zip((qr.grad, kr.grad, vr.grad), ref):
        _close_rel(got, want, 1e-4, 1e-5)


def test_flash_kernels_refuse_unsupported_head_dims(cuda):
    q, k, v, _ = _qkv_do(cuda, torch.float32, 1, 8, 8, 1, 48, 0)
    with pytest.raises(ValueError, match="blockwise_attention"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
