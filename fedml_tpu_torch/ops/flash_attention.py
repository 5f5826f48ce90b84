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
CPU; on CUDA tensors it launches its kernel (bf16 or fp32, the head
dims :func:`head_dim_supported` takes: 64 and every multiple of 128,
those above 128 through the chunked route, :data:`WIDE_KERNELS`) or
raises. The kernels are compiled at their first launch
(``ops/_build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from fedml_tpu_torch.ops._build import CudaLibrary
from fedml_tpu_torch.ops.attention import NEG_INF


def head_dim_supported(D):
    """Whether the kernels take head dim ``D``: 64, or any multiple of
    128 -- what the reference's Pallas kernels take on the TPU
    (``_require_hw_head_dim``), and D 64 besides. D 64 and 128 have
    kernels of their own; above 128 one chunked kernel a wrapper and
    input type serves every multiple of 128."""
    return D == 64 or (D > 0 and D % 128 == 0)


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
#: the fp32 tensor-core kernels (3xTF32) by wrapper: B2, B3, B4
TF32_KERNELS = {"fwd": "fwd_tf32_kernel", "dq": "dq_tf32_kernel",
                "dkv": "dkv_tf32_kernel"}
#: the kernels of head dims above 128 by wrapper: B2, B3, B4, each a
#: template over the input type (bf16 on mma.m16n8k16, fp32 3xTF32); B2's
#: also over the head-dim columns a block holds (every one at D 256, 384
#: and 512; 512 above, with the rest of the chunks on grid axis z)
WIDE_KERNELS = {"fwd": "fwd_wide_kernel", "dq": "dq_wide_kernel",
                "dkv": "dkv_wide_kernel"}
#: the most head-dim columns one block of ``fwd_wide_kernel`` holds
WIDE_FWD_HELD = 512


def mma_kernel_tag(name, D, kernels=MMA_KERNELS):
    """The part of the mangled name of the kernel of wrapper ``name`` (a
    key of ``kernels``, :data:`MMA_KERNELS` or :data:`TF32_KERNELS`) at
    head dim ``D`` that names it alone, as ``-Xptxas -v`` reports it:
    ``14fwd_mma_kernelILi128E``."""
    fn = kernels[name]
    return f"{len(fn)}{fn}ILi{D}E"


def wide_kernel_tag(name, dtype, D=256):
    """The same for the kernel of wrapper ``name`` above D 128 in
    ``dtype`` ("bf16" or "fp32") at head dim ``D``: dq's and dk/dv's serve
    every such D (``15dq_wide_kernelIfE``), the forward's are instances
    by the columns a block holds and whether chunks lie beyond them
    (``15fwd_wide_kernelIfLi256ELb0EE``)."""
    fn = WIDE_KERNELS[name]
    arg = {"bf16": "13__nv_bfloat16", "fp32": "f"}[dtype]
    if name != "fwd":
        return f"{len(fn)}{fn}I{arg}E"
    held = min(D, WIDE_FWD_HELD)
    return f"{len(fn)}{fn}I{arg}Li{held}ELb{int(D > held)}EE"


#: launch shape fields a kernel in ``fedml_flash_mma_info``'s output
_INFO = ("threads", "smem_bytes", "blocks_per_sm", "rows", "chunks")


def mma_launch_info(D=128):
    """Launch shape of the tensor-core kernels at head dim ``D`` on the
    current card: ``{"fwd": {"threads", "smem_bytes", "blocks_per_sm",
    "rows", "chunks"}, "dq": {...}, "dkv": {...}}`` for bf16 B2-B4 and
    ``"fwd_tf32"``, ``"dq_tf32"``, ``"dkv_tf32"`` for fp32 B2-B4: the
    kernels of D 64 and 128, or above 128 those of head dim ``D``.
    ``rows``: query rows (the forward, dq) or key rows (dk/dv) a block
    owns. ``chunks``: 128-column chunks of the head dim -- for the
    forward those one block holds and forms S over (1 at D 64 and 128,
    every one, D / 128, at D 256-512, :data:`WIDE_FWD_HELD` / 128 above,
    the rest on grid axis z); for dq and dk/dv those on grid axis z, one a
    block (1 at D 64 and 128, D / 128 above)."""
    n = len(_INFO)
    out = (ctypes.c_int * (6 * n))()
    _raise_on(LIBRARY.lib.fedml_flash_mma_info(D, out), "mma_info")
    return {name: dict(zip(_INFO, out[i * n:(i + 1) * n]))
            for i, name in enumerate(("fwd", "dq", "dkv", "dq_tf32",
                                      "dkv_tf32", "fwd_tf32"))}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _scores(q, k, causal, scale, k_len, product=torch.einsum):
    """Masked fp32 scores ``[B, H, Tq, Tk]`` (the Pallas ``_mask``), the
    product ``q k^T`` taken by ``product(eq, q, k)``."""
    Tq, Tk = q.shape[1], k.shape[1]
    s = product("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    valid = kpos < k_len
    if causal:
        valid = valid & (kpos <= qpos)
    return torch.where(valid, s, NEG_INF)


def _defaults(q, k, scale, k_len):
    return (q.shape[-1] ** -0.5 if scale is None else scale,
            k.shape[1] if k_len is None else int(k_len))


def _softmax_out(s, pv):
    """fp32 ``(O [B, Tq, H, D], lse [B, H, Tq])`` from the masked scores
    ``s``, with the kernels' guard (p = 0 where s is masked), ``pv(p)``
    taking the PV product."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1)
    o = pv(p) / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
                      0.0)
    return o, lse


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None,
                                  k_len=None):
    """Plain version of B2: ``(O [B, Tq, H, D] in q's dtype, lse fp32
    [B, H, Tq])``, with the kernel's guard (p = 0 where s is masked) and
    p rounded to the input type before the PV product."""
    scale, k_len = _defaults(q, k, scale, k_len)
    o, lse = _softmax_out(
        _scores(q, k, causal, scale, k_len),
        lambda p: torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                               v.float()))
    return o.to(q.dtype), lse


def _probs_and_ds_reference(q, k, v, do, lse, delta, causal, scale, k_len):
    """``p = exp(s - lse)`` (0 where masked) and ``ds = p * (dO v^T -
    delta)``, fp32 ``[B, H, Tq, Tk]`` (the Pallas ``_probs_and_ds``)."""
    s = _scores(q, k, causal, scale, k_len)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    # dO v^T - delta in float64: where one key takes a row's attention the
    # two cancel exactly, and fp32 leaves each with rounding noise of about
    # eps |dO| |v| sqrt(D), which at D 256 alone reaches the card tests'
    # fp32 tolerance on dk (0.96 of it against float64 on the CPU)
    dov = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
    return p, p * (dov - delta[..., None].double()).float()


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


def tf32_split(x):
    """``(hi, lo)`` of fp32 ``x`` as the fp32 B2-B4 split each operand
    (``tf32_rna`` in ``csrc/hopper_mma.cuh``, the rounding of
    ``cvt.rna.tf32.f32``): ``hi`` is ``x`` rounded to TF32 -- the 13 low
    mantissa bits dropped, to nearest with ties away from zero, inf and
    NaN passed through -- and ``lo`` is ``x - hi`` rounded the same way.
    Both fp32."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _tf32_rna(x):
    bits = x.contiguous().view(torch.int32)
    finite = torch.isfinite(x)
    # on the magnitude, so that adding half the dropped unit rounds ties
    # away from zero; a carry into the exponent is the right rounding
    mag = torch.where(finite, bits & 0x7FFFFFFF, 0)
    rounded = ((mag + 0x1000) & 0x7FFFE000) | (bits & -0x80000000)
    return torch.where(finite, rounded.view(torch.float32), x)


def _tf32_product(eq, a, b, passes):
    """``einsum(eq, a, b)`` in fp32 from TF32 parts: ``passes`` 3 sums
    ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` (3xTF32, the kernels'
    products), 1 takes ``hi_a hi_b`` (plain TF32)."""
    (ahi, alo), (bhi, blo) = tf32_split(a.float()), tf32_split(b.float())
    if passes == 1:
        return torch.einsum(eq, ahi, bhi)
    return (torch.einsum(eq, alo, bhi) + torch.einsum(eq, ahi, blo)
            + torch.einsum(eq, ahi, bhi))


def flash_attention_fwd_tf32_reference(q, k, v, causal=False, scale=None,
                                       k_len=None, passes=3):
    """:func:`flash_attention_fwd_reference` in fp32 with both of its
    products taken from TF32 parts (:func:`tf32_split`), ``passes`` 3 as
    the fp32 B2 takes them (3xTF32) or 1 (plain TF32): the split's
    arithmetic, for the tests. Nothing on the main path calls it."""
    scale, k_len = _defaults(q, k, scale, k_len)
    return _softmax_out(
        _scores(q, k, causal, scale, k_len,
                lambda eq, a, b: _tf32_product(eq, a, b, passes)),
        lambda p: _tf32_product("bhqk,bkhd->bqhd", p, v, passes))


def flash_attention_bwd_tf32_reference(q, k, v, do, lse, delta,
                                       causal=False, scale=None, k_len=None,
                                       passes=3):
    """:func:`flash_attention_bwd_reference` in fp32 with each of its five
    products taken from TF32 parts (:func:`tf32_split`), ``passes`` 3 as
    the fp32 B3 and B4 take them (3xTF32) or 1 (plain TF32): the split's
    arithmetic, for the tests. Nothing on the main path calls it."""
    scale, k_len = _defaults(q, k, scale, k_len)
    s = _scores(q, k, causal, scale, k_len,
                lambda eq, a, b: _tf32_product(eq, a, b, passes))
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    dov = _tf32_product("bqhd,bkhd->bhqk", do, v, passes)
    ds = p * (dov - delta[..., None])
    dq = scale * _tf32_product("bhqk,bkhd->bqhd", ds, k, passes)
    dk = scale * _tf32_product("bhqk,bqhd->bkhd", ds, q, passes)
    dv = _tf32_product("bhqk,bqhd->bkhd", p, do, passes)
    return dq, dk, dv


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
    if not head_dim_supported(D):
        raise ValueError(
            f"the flash attention kernels take head dims 64 and multiples "
            f"of 128, got D={D}; use "
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


__all__ = ["head_dim_supported", "MMA_KERNELS", "TF32_KERNELS",
           "WIDE_KERNELS", "WIDE_FWD_HELD", "build", "mma_kernel_tag",
           "wide_kernel_tag",
           "mma_launch_info", "launches", "tf32_split",
           "flash_attention_fwd_tf32_reference",
           "flash_attention_bwd_tf32_reference",
           "flash_attention", "FlashAttention", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_fwd_reference",
           "flash_attention_bwd_reference", "flash_attention_dq_reference",
           "flash_attention_dkv_reference"]
