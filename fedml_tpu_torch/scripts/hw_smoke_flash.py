"""Card smoke of the flash-attention kernels (counterpart of
``scripts/hw_smoke_flash.py``): B2 (forward) and B3/B4 (dq, dk/dv, the
``FlashAttention`` backward) at D 128 in bf16, causal and not, against
the materialising ``ops/attention.py`` ``mha``, with the reference's
bounds (forward 2e-2, gradients of ``sum(out^2)`` 0.3).

The reference's small-D guard (Mosaic takes head dims in multiples of
128 only) has its counterpart in ``head_dim_supported``: the port's
kernels take D 64 and every multiple of 128, so D 64 is held to the
same bounds, and a head dim the kernels do not take (32) must raise
``ValueError`` on the card rather than fall back. On the CPU (``--platform cpu``) the
wrappers run their plain versions and launch nothing.

Usage: python -m fedml_tpu_torch.scripts.hw_smoke_flash [--platform cpu
       --tiny]
Prints a line a case and one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from fedml_tpu_torch.scripts._common import (add_platform_flag, device_of,
                                             device_record)

FWD_TOL, BWD_TOL = 2e-2, 0.3


def _case(fa, mha, q, k, v, causal):
    out = fa.flash_attention(q, k, v, causal)
    ref = mha(q, k, v, causal)
    err = float((out.float() - ref.float()).abs().max())
    grads = []
    for fn in (fa.flash_attention, mha):
        args = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
        (fn(*args, causal).float() ** 2).sum().backward()
        grads.append([a.grad.float() for a in args])
    gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
    return err, gerr


def main(argv=None):
    p = argparse.ArgumentParser("hw_smoke_flash")
    add_platform_flag(p)
    p.add_argument("--tiny", action="store_true",
                   help="T 64: a CPU sanity run")
    args = p.parse_args(argv)
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops.attention import mha

    dev = device_of(args)
    where = device_record(dev)[0]
    print(f"device: {where}", flush=True)
    B, T, H = 2, (64 if args.tiny else 512), 4
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in fa.launches:
        fa.launches[name] = 0
    cases = []
    for D in (128, 64):
        q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        for causal in (False, True):
            err, gerr = _case(fa, mha, q, k, v, causal)
            print(f"D={D} causal={causal}: fwd_err={err:.2e} "
                  f"bwd_err={gerr:.2e}", flush=True)
            if not (err < FWD_TOL and gerr < BWD_TOL):
                raise SystemExit(f"D={D} causal={causal}: fwd err {err}, "
                                 f"bwd err {gerr}")
            cases.append({"D": D, "causal": causal, "fwd_err": err,
                          "bwd_err": gerr})
    launches = dict(fa.launches)
    guard = None
    if dev.type == "cuda":
        if not (launches["fwd"] and launches["dq"] and launches["dkv"]):
            raise SystemExit(f"the kernels did not launch: {launches}")
        q32 = q[..., :32].contiguous()
        try:
            fa.flash_attention(q32, q32, q32)
        except ValueError as e:
            if "head dims" not in str(e):
                raise
            guard = "D=32 raises"
        else:
            raise SystemExit("D=32 should have raised on the card")
        print(f"unsupported-D guard: {guard}", flush=True)
    print("flash_attention hardware smoke: OK", flush=True)
    rec = {"metric": "flash attention card smoke (B2-B4 against mha)",
           "shape": [B, T, H], "cases": cases, "launches": launches,
           "unsupported_d_guard": guard, **where}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
