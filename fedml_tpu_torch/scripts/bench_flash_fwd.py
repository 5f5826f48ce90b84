"""Times the fp32 flash-attention forward kernel, B2, of this checkout
against the one built from another tree's sources, in turns on one card.

``--against DIR`` names another checkout (the parent commit, say,
unpacked by ``git archive`` into a git-ignored directory), built as
``bench_flash_bwd`` builds it (``libraries``: ``DIR/build``) and
launched through this checkout's wrappers (the C interface is the
same). At each ``--shape`` (causal; q, k and v strided views of one qkv
product, as the model hands them over), each library's O and lse are
held to the plain forward at the card's fp32 tolerance, and so on the
card tests' ``k_len`` cases (their worst error over tolerance is
reported). The plain 3xTF32 forward
(``flash_attention_fwd_tf32_reference``: the same split, its sums
rounded in fp32) is held to the plain forward on the same inputs
(``split_max_abs_err``): what the split alone costs, apart from the
sums the tensor cores truncate. Then B2 is timed in the order against,
this, this, against (``flushed_ms``, as ``chip_smoke.py`` times),
beside SDPA's forward on the same inputs in the same call and the
bounds: bytes over 3.35 TB/s against operations over 67 TFLOP/s (fp32
on the CUDA cores) and three times the operations over 495 TFLOP/s
(3xTF32). The card only.

Usage: python -m fedml_tpu_torch.scripts.bench_flash_fwd --against DIR
       [--shape 32,512,4,64 [--shape 32,80,4,128 ...]]
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from fedml_tpu_torch.scripts._common import device_record, flushed_ms
from fedml_tpu_torch.scripts.bench_flash_bwd import (
    bounds, launching, libraries, qkv_do, worst)


def _shape_record(fa, libs, dev, flush, B, T, H, D):
    """Errors, the k_len cases' worst error over tolerance and the times
    in turns of B2 at one causal launch [B, T, H, D]."""
    import torch.nn.functional as F

    q, k, v, _ = qkv_do(torch.Generator(device=dev).manual_seed(5), B, T,
                        H, D, True)
    refs = fa.flash_attention_fwd_reference(q, k, v, True)
    errs, k_len_ratio = {}, {}
    for who, lib in libs.items():
        with launching(fa, lib):
            got = fa.flash_attention_fwd(q, k, v, True)
            if worst(got, refs) > 1:
                raise SystemExit(f"{who}: O or lse past the tolerance at "
                                 f"{[B, T, H, D]}")
            errs[who] = {name: float((g - r).abs().max())
                         for name, g, r in zip(("o", "lse"), got, refs)}
            # the card tests' k_len cases, on their inputs
            k_len_ratio[who] = 0.0
            for k_len in (0, 1, 37, 64):
                gen = torch.Generator(device=dev).manual_seed(17 + k_len)
                q2, k2, v2, _ = qkv_do(gen, 2, 80, 2, D, False)
                for causal in (False, True):
                    k_len_ratio[who] = max(k_len_ratio[who], worst(
                        fa.flash_attention_fwd(q2, k2, v2, causal,
                                               k_len=k_len),
                        fa.flash_attention_fwd_reference(
                            q2, k2, v2, causal, k_len=k_len)))
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
    return {"shape": [B, T, H, D], "turns": turns, "max_abs_err": errs,
            "split_max_abs_err": split_err,
            "k_len_err_over_tol": k_len_ratio, "sdpa_fwd_ms": sdpa_fwd_ms,
            "bound_ms": bounds(B, T, H, D, ("fwd",))["fwd"]}


def main(argv=None):
    p = argparse.ArgumentParser("bench_flash_fwd")
    p.add_argument("--against", required=True,
                   help="another checkout whose forward is timed in turns "
                        "with this one's")
    p.add_argument("--shape", action="append",
                   help="B,T,H,D (repeatable; default 32,512,4,64)")
    args = p.parse_args(argv)
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    where = device_record(dev)[0]
    libs = libraries(fa, args.against)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    shapes = [tuple(int(x) for x in s.split(","))
              for s in args.shape or ["32,512,4,64"]]
    rec = {"metric": "fp32 flash attention forward kernel in turns",
           "causal": True, "against": os.path.abspath(args.against),
           "shapes": [_shape_record(fa, libs, dev, flush, *shape)
                      for shape in shapes], **where}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
