"""Tests of the port that need an NVIDIA GPU: the hand-written kernels
against their plain PyTorch versions on the card. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up for the
CPU suite). Without a GPU every test skips.

Tolerance: max|err| <= 1e-3*max|ref| + 1e-3 against the plain version
computed in fp32 from the same inputs -- fp32 sums taken in another
order over K = B*Ho*Wo up to 65,536.
"""

import pytest
import torch

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,B,ci,co,H,W,k,p", SHAPES)
def test_kernel_matches_plain_version(cuda, dtype, L, B, ci, co, H, W, k,
                                      p):
    gen = torch.Generator(device=cuda).manual_seed(ci * 100 + co)
    ho, wo = H + 2 * p - k + 1, W + 2 * p - k + 1
    x = torch.randn(B, L * ci, H, W, generator=gen, device=cuda).to(dtype)
    dy = torch.randn(B, L * co, ho, wo, generator=gen, device=cuda).to(dtype)
    before = grouped_conv.launches
    got = grouped_conv.grouped_conv_dw(x, dy, L, k, k, (p, p))
    assert grouped_conv.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (L * co, ci, k, k)
    _close(got, grouped_conv.grouped_conv_dw_reference(
        x.float(), dy.float(), L, k, k, (p, p)))
    # the split-K sums are reduced in a fixed order: a second call repeats
    # the result bit for bit
    assert torch.equal(got, grouped_conv.grouped_conv_dw(x, dy, L, k, k,
                                                         (p, p)))


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
