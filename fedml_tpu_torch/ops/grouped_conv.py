"""Per-lane (grouped) conv weight gradient: the hand-written Hopper kernel
and the autograd Function around it.

Counterpart of ``fedml_tpu/ops/pallas_grouped_conv.py``. The lane-packed
ResNet keeps activations lane-merged, ``[B, L*C, H, W]`` (lane-major
channels), and a per-lane conv is one ``groups=L`` conv whose weight is
the lane-stacked kernels ``[L*Co, Ci, kh, kw]``. Its weight gradient,
stride 1, is

    dW[l*Co + o, i, dh, dw] = sum_{b,h,w} x[b, l*Ci + i, h+dh-pt, w+dw-pl]
                                          * dy[b, l*Co + o, h, w]

computed by ``csrc/grouped_conv_dw.cu`` on a CUDA tensor and by
:func:`grouped_conv_dw_reference` (plain PyTorch) on a CPU tensor. The
source holds two kernels, and :func:`_route` picks one per call: the
tensor-core kernel (``dw_mma_kernel``, bf16 at the shapes it takes, the
whole main path) or the CUDA-core kernel (``dw_partial_kernel``, fp32
and every other shape). The source is compiled with ``nvcc`` for
``sm_90a`` into ``build/`` at its first use and loaded with ``ctypes``
(``ops/_build.py``); nothing is compiled at import.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops._build import CudaLibrary

_MAX_CH = 64      # kMaxCh in the CUDA source
_MMA_MAX_W = 64   # kMmaMaxW
_MMA_MAX_K = 5    # kMmaMaxK

#: launches of the CUDA kernels made by :func:`grouped_conv_dw`; the
#: plain version on CPU tensors does not count
launches = 0
#: the same launches by route (:func:`_route`)
route_launches = {"tensor_core": 0, "cuda_core": 0}
#: the tensor-core kernel's name in the source, templated on CH
MMA_KERNEL = "dw_mma_kernel"


def _bind(lib):
    fn = lib.fedml_grouped_conv_dw
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                   + [ctypes.c_void_p])
    plan = lib.fedml_grouped_conv_dw_nsplit
    plan.restype = ctypes.c_int
    plan.argtypes = [ctypes.c_int] * 13
    fn = lib.fedml_grouped_conv_dw_mma
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                   + [ctypes.c_void_p])
    plan = lib.fedml_grouped_conv_dw_mma_nsplit
    plan.restype = ctypes.c_int
    plan.argtypes = [ctypes.c_int] * 13
    info = lib.fedml_grouped_conv_dw_mma_info
    info.restype = ctypes.c_int
    info.argtypes = [ctypes.c_int] * 13 + [ctypes.c_void_p]


LIBRARY = CudaLibrary("grouped_conv_dw", _bind)


def build():
    """Compile ``csrc/grouped_conv_dw.cu`` into ``build/`` (when the
    library is missing or older than its source) and load it. Returns
    the compiler's ``-Xptxas -v`` report when it compiled, else ``""``."""
    return LIBRARY.build()


def _check(x, dy, L, kh, kw, padding):
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError("x and dy must be NCHW [B, L*C, H, W]")
    if x.device != dy.device or x.dtype != dy.dtype:
        raise ValueError("x and dy must share device and dtype")
    if x.shape[0] != dy.shape[0] or x.shape[1] % L or dy.shape[1] % L:
        raise ValueError(f"batch/lane mismatch: x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}, L={L}")
    ph, pw = padding
    H, W = x.shape[2], x.shape[3]
    if (dy.shape[2] != H + 2 * ph - kh + 1
            or dy.shape[3] != W + 2 * pw - kw + 1):
        raise ValueError("dy's spatial shape is not the stride-1 output")


def grouped_conv_dw_reference(x, dy, L, kh, kw, padding):
    """Plain PyTorch dW of the stride-1 ``groups=L`` conv, in fp32: the
    same contraction as the kernel, tap by tap. ``x [B, L*Ci, H, W]``,
    ``dy [B, L*Co, Ho, Wo]``, ``padding (ph, pw)``; returns
    ``[L*Co, Ci, kh, kw]`` float32."""
    _check(x, dy, L, kh, kw, padding)
    ph, pw = padding
    B, LCi, _, _ = x.shape
    _, LCo, Ho, Wo = dy.shape
    xp = F.pad(x.float(), (pw, pw, ph, ph)).reshape(
        B, L, LCi // L, x.shape[2] + 2 * ph, x.shape[3] + 2 * pw)
    g = dy.float().reshape(B, L, LCo // L, Ho, Wo)
    taps = [[torch.einsum("blihw,blohw->loi",
                          xp[..., dh:dh + Ho, dw:dw + Wo], g)
             for dw in range(kw)] for dh in range(kh)]
    out = torch.stack([torch.stack(row, dim=-1) for row in taps], dim=-2)
    return out.reshape(LCo, LCi // L, kh, kw)


def _route(dtype, Ci, Co, W, Wo, kh, kw, aligned):
    """The kernel that takes a launch: ``"tensor_core"`` for bf16 with Ci
    and Co at most 64, x rows (W) and dy rows (Wo) of whole 16-byte
    chunks, W at most 64, kernels up to 5x5 and x and dy on 16-byte
    addresses (``aligned``); ``"cuda_core"`` for everything else."""
    if (dtype == torch.bfloat16 and Ci <= _MAX_CH and Co <= _MAX_CH
            and W % 8 == 0 and Wo % 8 == 0 and W <= _MMA_MAX_W
            and kh <= _MMA_MAX_K and kw <= _MMA_MAX_K and aligned):
        return "tensor_core"
    return "cuda_core"


def mma_launch_info(B, L, Ci, Co, H, W, kh, kw, padding, device=None):
    """Launch shape of the tensor-core kernel at a bf16 shape on the
    current card: ``{"ch", "threads", "smem_bytes", "blocks_per_sm",
    "nsplit"}``; ``ch`` names the template instance (``CH``)."""
    ph, pw = padding
    Ho, Wo = H + 2 * ph - kh + 1, W + 2 * pw - kw + 1
    n_sm = torch.cuda.get_device_properties(
        device or torch.device("cuda", 0)).multi_processor_count
    out = (ctypes.c_int * 5)()
    err = LIBRARY.lib.fedml_grouped_conv_dw_mma_info(
        B, L, Ci, Co, H, W, Ho, Wo, kh, kw, ph, pw, n_sm, out)
    if err != 0:
        raise RuntimeError(f"grouped_conv_dw mma_info failed ({err})")
    return {"ch": out[4], "threads": out[0], "smem_bytes": out[1],
            "blocks_per_sm": out[2], "nsplit": out[3]}


def grouped_conv_dw(x, dy, L, kh, kw, padding):
    """Per-lane stride-1 conv weight gradient, ``[L*Co, Ci, kh, kw]`` fp32.

    On CUDA tensors this launches a hand-written kernel, the one
    :func:`_route` names (bf16 or fp32 inputs, contiguous, Ci and Co at
    most 64), and raises on anything it does not take; on CPU tensors it
    computes :func:`grouped_conv_dw_reference`."""
    global launches
    if x.device.type == "cpu":
        return grouped_conv_dw_reference(x, dy, L, kh, kw, padding)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, dy, L, kh, kw, padding)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"grouped_conv_dw takes bf16 or fp32, got {x.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("grouped_conv_dw needs contiguous x and dy")
    B, LCi, H, W = x.shape
    _, LCo, Ho, Wo = dy.shape
    Ci, Co = LCi // L, LCo // L
    if Ci > _MAX_CH or Co > _MAX_CH:
        raise ValueError(f"Ci={Ci}, Co={Co}: the kernel takes at most "
                         f"{_MAX_CH} channels per lane")
    lib = LIBRARY.lib
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    dims = (B, L, Ci, Co, H, W, Ho, Wo, kh, kw, padding[0], padding[1], n_sm)
    route = _route(x.dtype, Ci, Co, W, Wo, kh, kw,
                   x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
    if route == "tensor_core":
        nsplit = lib.fedml_grouped_conv_dw_mma_nsplit(*dims)
    else:
        nsplit = lib.fedml_grouped_conv_dw_nsplit(*dims)
    if nsplit < 1:
        raise ValueError(f"grouped_conv_dw does not take x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}, kernel {kh}x{kw}")
    out = torch.empty((LCo, Ci, kh, kw), device=x.device, dtype=torch.float32)
    # per-split partial sums, reduced in split order by the second pass
    work = torch.empty((L * kh * kw, nsplit, Ci * Co), device=x.device,
                       dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), dy.data_ptr(), out.data_ptr(), work.data_ptr())
    if route == "tensor_core":
        err = lib.fedml_grouped_conv_dw_mma(*ptrs, *dims, stream)
    else:
        err = lib.fedml_grouped_conv_dw(
            *ptrs, int(x.dtype == torch.bfloat16), *dims, stream)
    if err != 0:
        raise RuntimeError(f"grouped_conv_dw ({route}) launch failed: CUDA "
                           f"error {err}")
    launches += 1
    route_launches[route] += 1
    return out


class LaneConvPallas(torch.autograd.Function):
    """Per-lane conv, ``groups=L`` forward with the hand-written dW kernel
    on the backward (the ``strategy="pallas"`` lowering).

    ``x [B, L*Ci, H, W]`` lane-merged, ``w [L, Co, Ci, kh, kw]``; returns
    the merged ``[B, L*Co, H', W']``. dX is the transpose conv
    (``torch.nn.grad.conv2d_input``); dW is :func:`grouped_conv_dw` for
    stride 1 and ``torch.nn.grad.conv2d_weight`` for the strided convs,
    as the reference falls back to XLA's dW there."""

    @staticmethod
    def forward(ctx, x, w, L, stride, padding):
        wf = w.reshape((-1,) + w.shape[2:])
        ctx.save_for_backward(x, w)
        ctx.conf = (L, stride, padding)
        return F.conv2d(x, wf, stride=stride, padding=padding, groups=L)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        L, stride, padding = ctx.conf
        wf = w.reshape((-1,) + w.shape[2:])
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, wf, g, stride=stride,
                                            padding=padding, groups=L)
        if ctx.needs_input_grad[1]:
            if tuple(stride) == (1, 1):
                dwf = grouped_conv_dw(x.contiguous(), g, L, w.shape[3],
                                      w.shape[4], tuple(padding))
            else:
                dwf = torch.nn.grad.conv2d_weight(
                    x, wf.shape, g, stride=stride, padding=padding, groups=L)
            dw = dwf.to(w.dtype).reshape(w.shape)
        return dx, dw, None, None, None


def lane_conv_pallas(x, w, L, stride=(1, 1), padding=(1, 1)):
    """Functional form of :class:`LaneConvPallas`."""
    return LaneConvPallas.apply(x, w, L, tuple(stride), tuple(padding))


__all__ = ["MMA_KERNEL", "build", "grouped_conv_dw",
           "grouped_conv_dw_reference", "LaneConvPallas", "lane_conv_pallas",
           "launches", "mma_launch_info", "route_launches"]
