"""Times the fp32 flash-attention backward kernels, B3 (dq) and B4
(dk/dv), of this checkout against those built from another tree's
sources, in turns on one card.

``--against DIR`` names another checkout (the parent commit, say,
unpacked by ``git archive`` into a git-ignored directory); its
``fedml_tpu_torch/csrc/flash_attention.cu`` is built into ``DIR/build``
and launched through this checkout's wrappers (the C interface is the
same). At the shape (causal; q, k and v strided views of one qkv
product, as the model hands them over), each library's dq, dk and dv are
held to the plain versions at the card's fp32 tolerance, and so on the
card tests' ``k_len`` cases (their worst error over tolerance is
reported: the one-key case, where ds is all cancellation, sets it).
Then each kernel is timed in the order against, this, this, against
(``flushed_ms``, as ``chip_smoke.py`` times), beside SDPA's backward in
the same call and the bounds: bytes over 3.35 TB/s against operations
over 67 TFLOP/s (fp32 on the CUDA cores) and three times the operations
over 495 TFLOP/s (3xTF32). It also reads how the tensor cores round what
they accumulate (``_tf32_accumulation``). The card only.

Usage: python -m fedml_tpu_torch.scripts.bench_flash_bwd --against DIR
       [--shape 32,512,4,64]
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch

from fedml_tpu_torch.scripts._common import device_record, flushed_ms

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"fp32": 67e12, "3xtf32": 495e12 / 3}
REL, ABS = 1e-4, 1e-5  # the card tests' fp32 tolerance


@contextlib.contextmanager
def launching(fa, lib):
    """The wrappers of ``fa`` launch through ``lib`` inside the block."""
    prev, fa.LIBRARY = fa.LIBRARY, lib
    try:
        yield
    finally:
        fa.LIBRARY = prev


#: (kernel, [B, T, H, D] tensors in and out, fp32 rows in and out,
#: products on each valid (query, key) pair)
KERNELS = {"fwd": (4, 1, 2), "dq": (5, 2, 3), "dkv": (6, 2, 4)}


def bounds(B, T, H, D, names=("dq", "dkv")):
    """Least ms of causal fp32 ``names`` (keys of :data:`KERNELS`) at
    each rate of ``OPS_PER_S``: each input read once and each output
    written once, against the valid (query, key) pairs' products."""
    tensor, row = B * T * H * D * 4, B * H * T * 4
    pairs = B * H * T * (T + 1) // 2
    out = {}
    for name in names:
        n_tensors, n_rows, products = KERNELS[name]
        bytes_ms = ((n_tensors * tensor + n_rows * row) / HBM_BYTES_PER_S
                    * 1e3)
        ops = 2 * products * D * pairs
        out[name] = {rate: max(bytes_ms, ops / per_s * 1e3)
                     for rate, per_s in OPS_PER_S.items()}
    return out


def libraries(fa, against):
    """``{"against": the flash-attention library built from the checkout
    ``against`` into ``against/build``, "this": this checkout's}``, both
    built."""
    from fedml_tpu_torch.ops import _build

    other = _build.CudaLibrary(
        fa.LIBRARY.name, fa._bind,
        csrc=os.path.join(against, "fedml_tpu_torch", "csrc"),
        build_dir=os.path.join(against, "build"))
    _build.build_all([other])
    _build.build_all([fa.LIBRARY])
    return {"against": other, "this": fa.LIBRARY}


def _tf32_accumulation(dev, K=512):
    """How the tensor cores round what they accumulate: a TF32 product
    (cuBLAS, ``allow_tf32``) of positive operands that TF32 holds exactly
    (so every product is exact and every partial sum grows), against
    float64; the mean and the extremes of its error in units of the last
    place of each result. Round to nearest gives a mean near 0;
    truncation a mean below 0 that grows with K."""
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.rand(n, generator=gen, device=dev) + 0.5
            for n in ((256, K), (K, 256)))
    a, b = ((t.view(torch.int32) & -0x2000).view(torch.float32)
            for t in (a, b))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = (a @ b).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    exact = a.double() @ b.double()
    ulp = torch.exp2(torch.floor(torch.log2(exact)) - 23)
    err = (got - exact) / ulp
    return {"K": K, "mean": float(err.mean()), "min": float(err.min()),
            "max": float(err.max())}


def qkv_do(gen, B, T, H, D, views):
    """fp32 q, k, v and dO [B, T, H, D] on ``gen``'s card: q, k and v
    column slices of one qkv product (``views``, as the model hands them
    over) or, as ``tests/test_torch_cuda.py`` ``_qkv_do`` makes them,
    contiguous."""
    dev = gen.device
    if views:
        qkv = torch.randn(B, T, 3 * H * D, generator=gen, device=dev)
        q, k, v = (qkv[..., j * H * D:(j + 1) * H * D].reshape(B, T, H, D)
                   for j in range(3))
        return q, k, v, torch.randn(B, T, H, D, generator=gen, device=dev)
    q, do = (torch.randn(B, T, H, D, generator=gen, device=dev)
             for _ in range(2))
    k, v = (torch.randn(B, T, H, D, generator=gen, device=dev)
            for _ in range(2))
    return q, k, v, do


def worst(got, refs):
    """Largest error of ``got`` over the fp32 tolerance of ``refs``."""
    return max(float((g - r).abs().max())
               / (REL * float(r.abs().max()) + ABS)
               for g, r in zip(got, refs))


def main(argv=None):
    p = argparse.ArgumentParser("bench_flash_bwd")
    p.add_argument("--against", required=True,
                   help="another checkout whose kernels are timed in turns "
                        "with this one's")
    p.add_argument("--shape", default="32,512,4,64", help="B,T,H,D")
    args = p.parse_args(argv)
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    where = device_record(dev)[0]
    libs = libraries(fa, args.against)

    def bwd_args(q, k, v, do, causal=True, k_len=None):
        o, lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                  k_len=k_len)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse, delta, causal

    def kernels(args, k_len=None):
        return ((fa.flash_attention_dq(*args, k_len=k_len),)
                + fa.flash_attention_dkv(*args, k_len=k_len))

    B, T, H, D = (int(x) for x in args.shape.split(","))
    main_args = bwd_args(*qkv_do(torch.Generator(device=dev).manual_seed(5),
                                 B, T, H, D, True))
    refs = fa.flash_attention_bwd_reference(*main_args)
    errs, k_len_ratio = {}, {}
    for who, lib in libs.items():
        with launching(fa, lib):
            got = kernels(main_args)
            if worst(got, refs) > 1:
                raise SystemExit(f"{who}: dq, dk or dv past the tolerance")
            errs[who] = {name: float((g - r).abs().max())
                         for name, g, r in zip(("dq", "dk", "dv"), got,
                                               refs)}
            # the card tests' k_len cases, on their inputs
            k_len_ratio[who] = 0.0
            for k_len in (0, 1, 37, 64):
                gen = torch.Generator(device=dev).manual_seed(17 + k_len)
                inputs = qkv_do(gen, 2, 80, 2, 128, False)
                for causal in (False, True):
                    a2 = bwd_args(*inputs, causal, k_len)
                    k_len_ratio[who] = max(k_len_ratio[who], worst(
                        kernels(a2, k_len),
                        fa.flash_attention_bwd_reference(*a2, k_len=k_len)))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timed = {"dq": lambda: fa.flash_attention_dq(*main_args),
             "dkv": lambda: fa.flash_attention_dkv(*main_args)}
    turns = []
    for who in ("against", "this", "this", "against"):
        with launching(fa, libs[who]):
            turns.append({"lib": who, **{name: flushed_ms(fn, flush)
                                         for name, fn in timed.items()}})
    q, k, v, do = main_args[:4]
    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa_bwd_ms = flushed_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do.transpose(1, 2), retain_graph=True), flush)
    rec = {"metric": "fp32 flash attention backward kernels in turns",
           "shape": [B, T, H, D], "causal": True,
           "against": os.path.abspath(args.against), "turns": turns,
           "max_abs_err": errs, "k_len_err_over_tol": k_len_ratio,
           "tf32_matmul_err_ulps": _tf32_accumulation(dev),
           "sdpa_bwd_ms": sdpa_bwd_ms, "bound_ms": bounds(B, T, H, D),
           **where}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
