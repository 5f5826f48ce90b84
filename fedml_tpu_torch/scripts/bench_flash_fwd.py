"""Times the flash-attention forward kernel, B2, of this checkout against
the one built from another tree's sources, in turns on one card, in fp32
(3xTF32 on the tensor cores) or bf16 (``--dtype``).

``--against DIR`` names another checkout (the parent commit, say,
unpacked by ``git archive`` into a git-ignored directory), built as
``bench_flash_bwd`` builds it (``libraries``: ``DIR/build``) and
launched through this checkout's wrappers (the C interface is the
same). At each ``--shape`` (causal; q, k and v strided views of one qkv
product, as the model hands them over), each library's O and lse are
held to the plain forward at the card tests' tolerance of the type (O
in bf16 at 1.6e-2 * max|ref| + 1e-3; lse, and O in fp32, at 1e-4 *
max|ref| + 1e-5), and so on the card tests' ``k_len`` cases (their
worst error over tolerance is reported). In fp32 the plain 3xTF32
forward (``flash_attention_fwd_tf32_reference``: the same split, its
sums rounded in fp32) is held to the plain forward on the same inputs
(``split_max_abs_err``): what the split alone costs, apart from the
sums the tensor cores truncate. Then B2 is timed in the order against,
this, this, against (``flushed_ms``, as ``chip_smoke.py`` times),
beside SDPA's forward on the same inputs in the same call (the backend
it took named) and the bounds: in fp32, bytes over 3.35 TB/s against
operations over 67 TFLOP/s (fp32 on the CUDA cores) and three times the
operations over 495 TFLOP/s (3xTF32); in bf16, bytes against operations
over 989 TFLOP/s. The card only.

Usage: python -m fedml_tpu_torch.scripts.bench_flash_fwd --against DIR
       [--dtype fp32|bf16] [--shape 32,512,4,64 [--shape ...]]
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from fedml_tpu_torch.scripts._common import device_record, flushed_ms
from fedml_tpu_torch.scripts.bench_flash_bwd import (
    ABS, HBM_BYTES_PER_S, REL, bounds, launching, libraries, qkv_do)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
BF16_OPS_PER_S = 989e12
#: the card tests' tolerance of O (rel, abs) by type; lse's is fp32's
O_TOL = {"fp32": (REL, ABS), "bf16": (1.6e-2, 1e-3)}


def _worst(got, refs, dtype):
    """Largest error of (O, lse) over the card tests' tolerance."""
    return max(float((g.float() - r.float()).abs().max())
               / (rel * float(r.float().abs().max()) + abs_)
               for g, r, (rel, abs_) in zip(got, refs,
                                            (O_TOL[dtype], (REL, ABS))))


def _bounds(B, T, H, D, dtype):
    """Least ms of causal B2: fp32 as ``bench_flash_bwd.bounds``; bf16
    the larger of its bytes (q, k, v and O read or written once, lse) over
    the memory rate and its products' operations on the valid pairs over
    989 TFLOP/s, and which."""
    if dtype == "fp32":
        return bounds(B, T, H, D, ("fwd",))["fwd"]
    nbytes = 4 * B * T * H * D * 2 + B * H * T * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 2 * D * B * H * T * (T + 1) // 2 / BF16_OPS_PER_S * 1e3
    return {"bf16": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _shape_record(fa, libs, dev, flush, dtype, B, T, H, D):
    """Errors, the k_len cases' worst error over tolerance and the times
    in turns of B2 at one causal launch [B, T, H, D] in ``dtype``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    cast = DTYPES[dtype]
    q, k, v, _ = (t.to(cast) for t in qkv_do(
        torch.Generator(device=dev).manual_seed(5), B, T, H, D, True))
    refs = fa.flash_attention_fwd_reference(q, k, v, True)
    errs, k_len_ratio = {}, {}
    for who, lib in libs.items():
        with launching(fa, lib):
            got = fa.flash_attention_fwd(q, k, v, True)
            if _worst(got, refs, dtype) > 1:
                raise SystemExit(f"{who}: O or lse past the tolerance at "
                                 f"{[B, T, H, D]} {dtype}")
            errs[who] = {name: float((g.float() - r.float()).abs().max())
                         for name, g, r in zip(("o", "lse"), got, refs)}
            # the card tests' k_len cases, on their inputs
            k_len_ratio[who] = 0.0
            for k_len in (0, 1, 37, 64):
                gen = torch.Generator(device=dev).manual_seed(17 + k_len)
                q2, k2, v2, _ = (t.to(cast) for t in qkv_do(
                    gen, 2, 80, 2, D, False))
                for causal in (False, True):
                    k_len_ratio[who] = max(k_len_ratio[who], _worst(
                        fa.flash_attention_fwd(q2, k2, v2, causal,
                                               k_len=k_len),
                        fa.flash_attention_fwd_reference(
                            q2, k2, v2, causal, k_len=k_len), dtype))
    split_err = None
    if dtype == "fp32":
        split = fa.flash_attention_fwd_tf32_reference(q, k, v, True)
        split_err = {name: float((g - r).abs().max())
                     for name, g, r in zip(("o", "lse"), split, refs)}
    turns = []
    for who in ("against", "this", "this", "against"):
        with launching(fa, libs[who]):
            turns.append({"lib": who, "fwd": flushed_ms(
                lambda: fa.flash_attention_fwd(q, k, v, True), flush)})
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_fwd_ms = flushed_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), flush)
    return {"shape": [B, T, H, D], "dtype": dtype, "turns": turns,
            "max_abs_err": errs, "split_max_abs_err": split_err,
            "k_len_err_over_tol": k_len_ratio, "sdpa_fwd_ms": sdpa_fwd_ms,
            "sdpa_backend": SDPBackend(torch._fused_sdp_choice(
                qs, ks, vs, None, 0.0, True)).name,
            "bound_ms": _bounds(B, T, H, D, dtype)}


def main(argv=None):
    p = argparse.ArgumentParser("bench_flash_fwd")
    p.add_argument("--against", required=True,
                   help="another checkout whose forward is timed in turns "
                        "with this one's")
    p.add_argument("--shape", action="append",
                   help="B,T,H,D (repeatable; default 32,512,4,64)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="fp32")
    args = p.parse_args(argv)
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    where = device_record(dev)[0]
    libs = libraries(fa, args.against)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    shapes = [tuple(int(x) for x in s.split(","))
              for s in args.shape or ["32,512,4,64"]]
    rec = {"metric": f"{args.dtype} flash attention forward kernel in "
                     "turns",
           "causal": True, "against": os.path.abspath(args.against),
           "shapes": [_shape_record(fa, libs, dev, flush, args.dtype,
                                    *shape) for shape in shapes], **where}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
