"""Flash attention -- forward, dq and dk/dv -- as hand-written Hopper
kernels, their plain PyTorch versions, and the autograd Function around
them.

Counterpart of ``fedml_tpu/ops/pallas_attention.py``. The kernels
(``csrc/flash_attention.cu``) replace its three Pallas kernels: the
online-softmax forward ``_fwd_kernel`` emitting O and the per-row
logsumexp (B2), ``_dq_kernel`` (B3) and ``_dkv_kernel`` (B4), which
re-form ``p = exp(s - lse)`` from the saved logsumexp and
``ds = p * (dO v^T - delta)``. ``delta = rowsum(dO * O)`` stays a
PyTorch op in the backward, as the reference computes it outside Pallas.

Layout ``[B, T, H, D]`` at every public function; the kernels read it
through its strides (no transposes, no padded copies) and mask ragged
``Tq``/``Tk`` themselves. Rows that start on 16 bytes (contiguous
tensors, the model's qkv column slices) are staged by 16-byte copies;
rows that do not are read element by element by the same kernels, with
the same results. lse is fp32 ``[B, H, Tq]``. Keys at or past
``k_len`` (default ``Tk``) are masked and, causal, keys after their
query in absolute positions (``kpos <= qpos``). A fully masked row gets
O = 0 and lse = 0.

Each wrapper computes the plain version when its tensors lie on the
CPU; on CUDA tensors it launches its kernel (bf16 or fp32, head dims
:data:`SUPPORTED_HEAD_DIMS`) or raises. The kernels are compiled at
their first launch (``ops/_build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from fedml_tpu_torch.ops._build import CudaLibrary
from fedml_tpu_torch.ops.attention import NEG_INF

#: head dims the kernels are instantiated for
SUPPORTED_HEAD_DIMS = (64, 128)

#: kernel launches per wrapper (``fwd``: B2, ``dq``: B3, ``dkv``: B4);
#: the plain versions on CPU tensors do not count. Exact when several
#: threads launch at once (the control plane's client threads train on
#: one card): every increment holds ``_launch_lock``.
launches = {"fwd": 0, "dq": 0, "dkv": 0}
_launch_lock = threading.Lock()


def _count(name):
    with _launch_lock:
        launches[name] += 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib):
    # is_bf16, B, H, Tq, Tk, k_len, D; strides, scale, causal, stream
    tail = [_I] * 7 + [_P, _F, _I, _P]
    for name, n_ptr in (("fedml_flash_fwd", 5), ("fedml_flash_dq", 7),
                        ("fedml_flash_dkv", 8)):
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [_P] * n_ptr + tail
    lib.fedml_flash_mma_info.restype = _I
    lib.fedml_flash_mma_info.argtypes = [_I, _P]


LIBRARY = CudaLibrary("flash_attention", _bind)


def build():
    """Compile ``csrc/flash_attention.cu`` into ``build/`` (unless this
    source, its headers and flags are built already) and load it.
    Returns the compiler's ``-Xptxas -v`` report."""
    return LIBRARY.build()


#: the bf16 tensor-core kernels by wrapper: B2, B3, B4
MMA_KERNELS = {"fwd": "fwd_mma_kernel", "dq": "dq_mma_kernel",
               "dkv": "dkv_mma_kernel"}


def mma_kernel_tag(name, D):
    """The part of the mangled name of the bf16 kernel of wrapper ``name``
    (a key of :data:`MMA_KERNELS`) at head dim ``D`` that names it alone,
    as ``-Xptxas -v`` reports it: ``14fwd_mma_kernelILi128E``."""
    fn = MMA_KERNELS[name]
    return f"{len(fn)}{fn}ILi{D}E"


def mma_launch_info(D=128):
    """Launch shape of the bf16 forward (B2), dq (B3) and dk/dv (B4)
    kernels at head dim ``D`` on the current card: ``{"fwd": {"threads",
    "smem_bytes", "blocks_per_sm"}, "dq": {...}, "dkv": {...}}``."""
    out = (ctypes.c_int * 9)()
    _raise_on(LIBRARY.lib.fedml_flash_mma_info(D, out), "mma_info")
    return {name: {"threads": out[i], "smem_bytes": out[i + 1],
                   "blocks_per_sm": out[i + 2]}
            for name, i in (("fwd", 0), ("dq", 3), ("dkv", 6))}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _scores(q, k, causal, scale, k_len):
    """Masked fp32 scores ``[B, H, Tq, Tk]`` (the Pallas ``_mask``)."""
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    valid = kpos < k_len
    if causal:
        valid = valid & (kpos <= qpos)
    return torch.where(valid, s, NEG_INF)


def _defaults(q, k, scale, k_len):
    return (q.shape[-1] ** -0.5 if scale is None else scale,
            k.shape[1] if k_len is None else int(k_len))


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None,
                                  k_len=None):
    """Plain version of B2: ``(O [B, Tq, H, D] in q's dtype, lse fp32
    [B, H, Tq])``, with the kernel's guard (p = 0 where s is masked) and
    p rounded to the input type before the PV product."""
    scale, k_len = _defaults(q, k, scale, k_len)
    s = _scores(q, k, causal, scale, k_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
                      0.0)
    return o.to(q.dtype), lse


def _probs_and_ds_reference(q, k, v, do, lse, delta, causal, scale, k_len):
    """``p = exp(s - lse)`` (0 where masked) and ``ds = p * (dO v^T -
    delta)``, fp32 ``[B, H, Tq, Tk]`` (the Pallas ``_probs_and_ds``)."""
    s = _scores(q, k, causal, scale, k_len)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    dov = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dov - delta[..., None])


def flash_attention_dq_reference(q, k, v, do, lse, delta, causal, scale,
                                 k_len):
    """Plain version of B3: dq in the input dtype."""
    _, ds = _probs_and_ds_reference(q, k, v, do, lse, delta, causal, scale,
                                    k_len)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(),
                              k.float())
    return dq.to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, causal, scale,
                                  k_len):
    """Plain version of B4: ``(dk, dv)`` in the input dtype."""
    p, ds = _probs_and_ds_reference(q, k, v, do, lse, delta, causal, scale,
                                    k_len)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                              q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, do, lse, delta, causal=False,
                                  scale=None, k_len=None):
    """Plain version of B3 and B4: ``(dq, dk, dv)`` in the input dtype
    from q, k, v, the output cotangent ``do`` (input dtype), the saved
    ``lse`` and ``delta = rowsum(dO * O)`` (fp32 ``[B, H, Tq]``); ds and
    p are rounded to the input type before their products."""
    scale, k_len = _defaults(q, k, scale, k_len)
    args = (q, k, v, do, lse, delta, causal, scale, k_len)
    return ((flash_attention_dq_reference(*args),)
            + flash_attention_dkv_reference(*args))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_cuda(tensors, stats=()):
    """Raise on what the kernels do not take; returns ``is_bf16``."""
    q = tensors[0]
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash attention kernels take bf16 or fp32, got {dt}")
    for t in tensors:
        if t.device != q.device or t.dtype != dt:
            raise ValueError("q, k, v (and dO) must share device and dtype")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError("q, k, v (and dO) must be [B, T, H, D] with a "
                             "contiguous head dim")
    D = q.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"the flash attention kernels take head dims "
            f"{SUPPORTED_HEAD_DIMS}, got D={D}; use "
            "fedml_tpu_torch.ops.attention.blockwise_attention for other "
            "head dims (same flash semantics, plain PyTorch)")
    for t in stats:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lse and delta must be contiguous fp32 "
                             "[B, H, Tq]")
    return int(dt == torch.bfloat16)


def _check_shapes(q, k, v, k_len):
    if (q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[2:] != q.shape[2:]):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [B, T, H, D] alike")
    if not 0 <= k_len <= k.shape[1]:
        raise ValueError(f"k_len={k_len} outside [0, Tk={k.shape[1]}]")


def _strides(*tensors):
    vals = [s for t in tensors for s in (t.stride(0), t.stride(1),
                                         t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"flash attention {name} launch failed: CUDA "
                           f"error {err}")


def flash_attention_fwd(q, k, v, causal=False, scale=None, k_len=None):
    """B2: ``(O, lse)`` -- the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    scale, k_len = _defaults(q, k, scale, k_len)
    _check_shapes(q, k, v, k_len)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale, k_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    is_bf16 = _check_cuda((q, k, v))
    B, Tq, H, D = q.shape
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _raise_on(LIBRARY.lib.fedml_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), is_bf16, B, H, Tq, k.shape[1], k_len, D,
        _strides(q, k, v, o), scale, int(bool(causal)), _stream(q)), "fwd")
    _count("fwd")
    return o, lse


def flash_attention_dq(q, k, v, do, lse, delta, causal=False, scale=None,
                       k_len=None):
    """B3: dq -- the kernel on CUDA tensors, the plain version on CPU."""
    scale, k_len = _defaults(q, k, scale, k_len)
    _check_shapes(q, k, v, k_len)
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta, causal,
                                            scale, k_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    is_bf16 = _check_cuda((q, k, v, do), (lse, delta))
    B, Tq, H, D = q.shape
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    _raise_on(LIBRARY.lib.fedml_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), is_bf16, B, H, Tq,
        k.shape[1], k_len, D, _strides(q, k, v, do, dq), scale,
        int(bool(causal)), _stream(q)), "dq")
    _count("dq")
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False, scale=None,
                        k_len=None):
    """B4: ``(dk, dv)`` -- the kernel on CUDA tensors, the plain version on
    CPU."""
    scale, k_len = _defaults(q, k, scale, k_len)
    _check_shapes(q, k, v, k_len)
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                             causal, scale, k_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    is_bf16 = _check_cuda((q, k, v, do), (lse, delta))
    B, Tq, H, D = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _raise_on(LIBRARY.lib.fedml_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        is_bf16, B, H, Tq, k.shape[1], k_len, D,
        _strides(q, k, v, do, dk, dv), scale, int(bool(causal)),
        _stream(q)), "dkv")
    _count("dkv")
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Fused attention ``[B, T, H, D] -> [B, T, H, D]``: B2 on the
    forward (saving q, k, v, O and lse); delta, then B3, then B4 on the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.conf = (causal, scale)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.conf
        # delta_i = dO_i . O_i, fp32 (the -sum_j ds_ij term of the softmax
        # backward), computed outside the kernels as the reference does
        delta = (g.float() * o.float()).sum(dim=-1).transpose(1, 2)
        delta = delta.contiguous()
        do = g.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        args = (q, k, v, do, lse, delta, causal, scale)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128):
    """Fused attention ``[B, T, H, D] -> [B, T, H, D]`` with the
    reference's signature. ``block_q``/``block_k`` are accepted for
    parity; the kernels pick their own tiles."""
    del block_q, block_k
    return FlashAttention.apply(q, k, v, causal, scale)


__all__ = ["SUPPORTED_HEAD_DIMS", "MMA_KERNELS", "build", "mma_kernel_tag",
           "mma_launch_info", "launches",
           "flash_attention", "FlashAttention", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_fwd_reference",
           "flash_attention_bwd_reference", "flash_attention_dq_reference",
           "flash_attention_dkv_reference"]
