"""The port's grouped-conv dW (fedml_tpu_torch/ops/grouped_conv.py) held
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_lane_packed.py runs it.

Layouts: the reference is NHWC with per-lane HWIO kernels and dW
``[L, kh, kw, Ci, Co]``; the port is lane-merged NCHW with per-lane OIHW
kernels and dW ``[L*Co, Ci, kh, kw]``. Tolerance: fp32 on both sides,
atol 1e-4 / rtol 1e-5 for the forward, dX and dW -- values reach about
10 and are fp32 sums taken in another order by another implementation,
the dW tolerance of the reference's own Pallas-vs-XLA test.
"""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.lane_packed import lane_conv as jax_lane_conv
from fedml_tpu.models.lane_packed import lane_merge as jax_lane_merge
from fedml_tpu.ops.pallas_grouped_conv import grouped_conv_dw as jax_dw
from fedml_tpu_torch.ops import grouped_conv

CASES = [(1, 1, 3), (1, 0, 3), (1, 2, 5), (2, 1, 3), (2, 0, 1)]
STRIDE1 = [c for c in CASES if c[0] == 1]


def _merged_nchw(x_lanes):
    """``[L, B, H, W, C]`` numpy -> port merged ``[B, L*C, H, W]``."""
    L, B, H, W, C = x_lanes.shape
    return torch.from_numpy(np.ascontiguousarray(
        x_lanes.transpose(1, 0, 4, 2, 3).reshape(B, L * C, H, W)))


@pytest.mark.parametrize("s,p,k", STRIDE1)
def test_reference_matches_pallas_kernel(s, p, k):
    L, B, H, ci, co = 4, 3, 8, 5, 7
    rng = np.random.default_rng(0)
    x = rng.normal(size=(L, B, H, H, ci)).astype(np.float32)
    ho = H + 2 * p - k + 1
    dy = rng.normal(size=(L, B, ho, ho, co)).astype(np.float32)
    want = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(dy), k, k,
                             ((p, p), (p, p))))
    got = grouped_conv.grouped_conv_dw(_merged_nchw(x), _merged_nchw(dy),
                                       L, k, k, (p, p))
    assert got.dtype == torch.float32 and got.shape == (L * co, ci, k, k)
    got = got.numpy().reshape(L, co, ci, k, k).transpose(0, 3, 4, 2, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("s,p,k", CASES)
def test_autograd_function_matches_jax_pallas_lowering(s, p, k):
    L, B, H, ci, co = 4, 3, 8, 5, 7
    rng = np.random.default_rng(1)
    x = rng.normal(size=(L, B, H, H, ci)).astype(np.float32)
    w = rng.normal(size=(L, k, k, ci, co)).astype(np.float32)

    def jloss(xm, ww):
        y = jax_lane_conv(xm, ww, L, strides=(s, s),
                          padding=((p, p), (p, p)), strategy="pallas")
        return jnp.sum(jnp.sin(y))

    xm = jax_lane_merge(jnp.asarray(x))
    y_ref = np.asarray(jax_lane_conv(xm, jnp.asarray(w), L, strides=(s, s),
                                     padding=((p, p), (p, p)),
                                     strategy="pallas"))
    dx_ref, dw_ref = jax.grad(jloss, argnums=(0, 1))(xm, jnp.asarray(w))

    xt = _merged_nchw(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(
        w.transpose(0, 4, 3, 1, 2))).requires_grad_(True)
    y = grouped_conv.lane_conv_pallas(xt, wt, L, (s, s), (p, p))
    torch.sin(y).sum().backward()

    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               y_ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(dx_ref), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(0, 3, 4, 2, 1),
                               np.asarray(dw_ref), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("ci,co", [(3, 16), (16, 16), (32, 32), (64, 64)])
def test_reference_matches_pallas_kernel_at_main_path_widths(ci, co):
    """The channel widths of ResNet-56's stride-1 convs, at a small
    spatial size."""
    L, B, H = 2, 2, 4
    rng = np.random.default_rng(ci)
    x = rng.normal(size=(L, B, H, H, ci)).astype(np.float32)
    dy = rng.normal(size=(L, B, H, H, co)).astype(np.float32)
    want = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(dy), 3, 3,
                             ((1, 1), (1, 1))))
    got = grouped_conv.grouped_conv_dw(_merged_nchw(x), _merged_nchw(dy),
                                       L, 3, 3, (1, 1))
    got = got.numpy().reshape(L, co, ci, 3, 3).transpose(0, 3, 4, 2, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = grouped_conv.launches
    x = torch.randn(2, 4 * 3, 6, 6)
    dy = torch.randn(2, 4 * 5, 6, 6)
    out = grouped_conv.grouped_conv_dw(x, dy, 4, 3, 3, (1, 1))
    torch.testing.assert_close(
        out, grouped_conv.grouped_conv_dw_reference(x, dy, 4, 3, 3, (1, 1)),
        rtol=0, atol=0)
    assert grouped_conv.launches == before


def test_wrapper_rejects_other_devices_and_bad_shapes():
    x = torch.empty(2, 12, 6, 6, device="meta")
    dy = torch.empty(2, 20, 6, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_conv.grouped_conv_dw(x, dy, 4, 3, 3, (1, 1))
    with pytest.raises(ValueError, match="stride-1 output"):
        grouped_conv.grouped_conv_dw(torch.randn(2, 12, 6, 6),
                                     torch.randn(2, 20, 5, 5), 4, 3, 3,
                                     (1, 1))



@pytest.mark.parametrize("dtype,ci,co,W,Wo,k,aligned,route", [
    # the main path's four stride-1 shapes in bf16
    (torch.bfloat16, 3, 16, 32, 32, 3, True, "tensor_core"),
    (torch.bfloat16, 16, 16, 32, 32, 3, True, "tensor_core"),
    (torch.bfloat16, 32, 32, 16, 16, 3, True, "tensor_core"),
    (torch.bfloat16, 64, 64, 8, 8, 3, True, "tensor_core"),
    # 1x1 and 5x5 kernels with rows of whole 16-byte chunks
    (torch.bfloat16, 48, 16, 16, 16, 1, True, "tensor_core"),
    (torch.bfloat16, 16, 48, 64, 64, 5, True, "tensor_core"),
    # everything else goes to the CUDA cores
    (torch.float32, 16, 16, 32, 32, 3, True, "cuda_core"),
    (torch.float32, 64, 64, 8, 8, 3, True, "cuda_core"),
    (torch.bfloat16, 3, 16, 11, 11, 3, True, "cuda_core"),
    (torch.bfloat16, 5, 7, 8, 6, 3, True, "cuda_core"),
    (torch.bfloat16, 16, 16, 32, 32, 3, False, "cuda_core"),
    (torch.bfloat16, 16, 16, 72, 72, 3, True, "cuda_core"),
    (torch.bfloat16, 16, 16, 16, 16, 7, True, "cuda_core"),
    (torch.bfloat16, 65, 16, 16, 16, 3, True, "cuda_core"),
])
def test_route_picks_the_kernel(dtype, ci, co, W, Wo, k, aligned, route):
    assert grouped_conv._route(dtype, ci, co, W, Wo, k, k, aligned) == route


def test_cpu_tensors_count_no_route():
    before = dict(grouped_conv.route_launches)
    x = torch.randn(2, 4 * 3, 8, 8, dtype=torch.bfloat16)
    dy = torch.randn(2, 4 * 16, 8, 8, dtype=torch.bfloat16)
    grouped_conv.grouped_conv_dw(x, dy, 4, 3, 3, (1, 1))
    assert grouped_conv.route_launches == before
