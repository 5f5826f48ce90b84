"""Times variants of the flash-attention forward above D 128 (B2's
``fwd_wide_kernel``) beside the kernel as this checkout builds it, in
turns on one card: what holds the kernel back, and which geometry pays.

Each variant is a copy of ``fedml_tpu_torch/csrc`` under ``--workdir``
(default ``build/variants``, git-ignored) with one edit to
``flash_attention.cu``, built into its own directory and launched through
this checkout's wrappers (the C interface is the same):

- ``stage_only``: every key tile is staged and nothing is computed
  (O and lse are wrong; its time is the staging's alone);
- ``compute_only``: K and V are staged for the first tile only and every
  tile computes on the buffers as they stand (wrong; the compute's
  alone);
- ``stamps``: lane 0 of each warp reads ``clock64`` around each phase of a
  key tile -- the wait for the tile and the launch of the next one's
  copies (W), the warp's partial S (S), the exchange of partials (X),
  the softmax (M) and P.V (P) -- and the cycles a warp and key tile of
  each are printed (the stamps slow the kernel a few percent);
- ``--geometry NAME=SPEC``: ``FwdWide``'s query rows, keys a tile and
  blocks an SM replaced, SPEC ``dtype:D:rows:keys:blocks[;...]`` (e.g.
  ``bf16:256:64:64:1``), other types and head dims as built.

At each ``--shape`` (causal, q, k and v strided views of one qkv product)
the kernel and the geometry variants are held to the plain forward at the
card tests' tolerance; then every variant is timed in the order given,
then reversed, then again (``flushed_ms``). The edits match the kernel's
source text: a source that no longer has it stops the script. The card
only.

Usage: python -m fedml_tpu_torch.scripts.bench_flash_variants
       [--variant stage_only --variant compute_only --variant stamps]
       [--geometry k64=bf16:256:64:64:1] [--dtype bf16 --dtype fp32]
       [--shape 32,512,4,256 ...]
Prints one JSON line a shape and type, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil

import torch

from fedml_tpu_torch.scripts._common import device_record, flushed_ms
from fedml_tpu_torch.scripts.bench_flash_bwd import launching, qkv_do
from fedml_tpu_torch.scripts.bench_flash_fwd import DTYPES, _worst

_LOOP = "  for (int kt = 0; kt < nkt; ++kt) {\n    hopper::cp_async_wait<0>();"
_STAGED = "    hopper::cp_async_commit();\n    const T* sK"
_EXCHANGE = "    // S of the strip: the partials"
_SOFTMAX = "    // one online-softmax step on the tile's S;"
_PV = "    wide_pv<D, BK>(acc, s, sV, c0, lane);\n  }\n"
_SKIP = "    if (k0 >= kend_w) continue;"
_NEXT = "    if (kt + 1 < nkt) stage_kv(kt + 1);"
_GEOMETRY = re.compile(
    r"  static constexpr int kRows = .*?\n.*?kBlocks = [^;]*;[^\n]*\n",
    re.S)
PHASES = "WSXMP"


def _kernel(src):
    """(start, end) of ``fwd_wide_kernel``'s definition in ``src``."""
    start = src.index("    fwd_wide_kernel(const T* __restrict__ q")
    return start, src.index("\n}\n", start)


def _edit(src, edits):
    """``src`` with each (old, new) of ``edits`` made once inside the
    kernel; raises SystemExit where the kernel lacks ``old``."""
    start, end = _kernel(src)
    body = src[start:end]
    for old, new in edits:
        if old not in body:
            raise SystemExit(f"fwd_wide_kernel has no {old.strip()[:60]!r}")
        body = body.replace(old, new, 1)
    return src[:start] + body + src[end:]


def stage_only(src):
    return _edit(src, [(_SKIP, "    if (k0 >= kend_w || nc > 0) continue;")])


def compute_only(src):
    return _edit(src, [(_NEXT, "")])


def stamps(src):
    src = _edit(src, [
        (_LOOP, "  unsigned long long ph[5] = {0, 0, 0, 0, 0}, nt = 0;\n"
                + _LOOP.replace("{\n", "{\n    long long t0 = clock64();\n",
                                1)),
        (_STAGED, _STAGED.replace(
            "\n    const T* sK",
            "\n    long long t1 = clock64();\n    ph[0] += t1 - t0;"
            "\n    const T* sK")),
        (_EXCHANGE, "    long long t2 = clock64();\n    ph[1] += t2 - t1;\n"
                    + _EXCHANGE),
        (_SOFTMAX, "    long long t3 = clock64();\n    ph[2] += t3 - t2;\n"
                   + _SOFTMAX),
        (_PV, "    long long t4 = clock64();\n    ph[3] += t4 - t3;\n"
              "    wide_pv<D, BK>(acc, s, sV, c0, lane);\n"
              "    ph[4] += clock64() - t4;\n    ++nt;\n  }\n"
              "  if (lane == 0) {\n    for (int i = 0; i < 5; ++i)\n"
              "      atomicAdd(&g_stamps[i], ph[i]);\n"
              "    atomicAdd(&g_stamps[5], nt);\n  }\n")])
    head = '#include "hopper_mma.cuh"\n'
    return (src.replace(head, head + "__device__ unsigned long long "
                        "g_stamps[6];\n", 1)
            + '\nextern "C" int fedml_stamps_read(unsigned long long* out) {\n'
              "  cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n"
              "  unsigned long long z[6] = {0, 0, 0, 0, 0, 0};\n"
              "  return cudaMemcpyToSymbol(g_stamps, z, sizeof(z));\n}\n")


def geometry(src, spec):
    """``FwdWide`` with (rows, keys, blocks) of each ``dtype:D`` in
    ``spec`` replaced, the rest as built."""
    match = _GEOMETRY.search(src)
    if match is None:
        raise SystemExit("FwdWide has no kRows ... kBlocks lines")
    block = re.sub(r"//[^\n]*", "", match.group(0))
    fields = {"kRows": [], "kStep": [], "kBlocks": []}
    for item in spec.split(";"):
        dtype, D, rows, keys, blocks = item.split(":")
        cond = f"({'' if dtype == 'bf16' else '!'}kBf16 && D == {int(D)})"
        for name, value in zip(fields, (rows, keys, blocks)):
            fields[name].append(f"{cond} ? {int(value)} : ")
    built = {name: re.search(rf"{name} =\s*(.*?);", block, re.S).group(1)
             for name in fields}
    lines = "".join(f"  static constexpr int {name} =\n      "
                    f"{''.join(conds)}({built[name]});\n"
                    for name, conds in fields.items())
    return src[:match.start()] + lines + src[match.end():]


def _libraries(fa, workdir, variants):
    """``{name: CudaLibrary}``: this checkout's as ``kernel``, and each
    variant's source written under ``workdir`` and built there."""
    from fedml_tpu_torch.ops import _build

    csrc = os.path.dirname(fa.LIBRARY.source)
    with open(fa.LIBRARY.source) as f:
        src = f.read()
    libs = {"kernel": fa.LIBRARY}
    for name, edit in variants.items():
        d = os.path.join(workdir, name, "csrc")
        shutil.rmtree(os.path.join(workdir, name), ignore_errors=True)
        os.makedirs(d)
        for f in sorted(os.listdir(csrc)):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), d)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(edit(src))
        libs[name] = _build.CudaLibrary(
            fa.LIBRARY.name, fa._bind, csrc=d,
            build_dir=os.path.join(workdir, name, "build"))
    _build.build_all(list(libs.values()))
    if "stamps" in libs:
        fn = libs["stamps"].lib.fedml_stamps_read
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p]
    return libs


def _record(fa, libs, dev, flush, dtype, B, T, H, D):
    q, k, v, _ = (t.to(DTYPES[dtype]) for t in qkv_do(
        torch.Generator(device=dev).manual_seed(5), B, T, H, D, True))
    run = lambda: fa.flash_attention_fwd(q, k, v, True)
    refs = fa.flash_attention_fwd_reference(q, k, v, True)
    err = {}
    for name, lib in libs.items():
        if name in ("stage_only", "compute_only", "stamps"):
            continue
        with launching(fa, lib):
            err[name] = _worst(run(), refs, dtype)
    times = {name: [] for name in libs}
    order = list(libs)
    for seq in (order, order[::-1], order):
        for name in seq:
            with launching(fa, libs[name]):
                times[name].append(flushed_ms(run, flush))
    rec = {"shape": [B, T, H, D], "dtype": dtype, "ms": times,
           "err_over_tol": err}
    if "stamps" in libs:
        out = (ctypes.c_ulonglong * 6)()
        with launching(fa, libs["stamps"]):
            libs["stamps"].lib.fedml_stamps_read(ctypes.addressof(out))
            run()
            torch.cuda.synchronize(dev)
            libs["stamps"].lib.fedml_stamps_read(ctypes.addressof(out))
        tiles = max(out[5], 1)
        rec["stamp_cycles_a_warp_tile"] = {
            p: out[i] / tiles for i, p in enumerate(PHASES)}
        rec["warp_tiles"] = out[5]
    return rec


def main(argv=None):
    p = argparse.ArgumentParser("bench_flash_variants")
    p.add_argument("--variant", action="append", default=[],
                   choices=("stage_only", "compute_only", "stamps"))
    p.add_argument("--geometry", action="append", default=[],
                   help="NAME=dtype:D:rows:keys:blocks[;...] (repeatable)")
    p.add_argument("--dtype", action="append", choices=sorted(DTYPES))
    p.add_argument("--shape", action="append",
                   help="B,T,H,D (repeatable; default 32,512,4,256)")
    p.add_argument("--workdir", default=os.path.join("build", "variants"))
    args = p.parse_args(argv)
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    where = device_record(dev)[0]
    edits = {"stage_only": stage_only, "compute_only": compute_only,
             "stamps": stamps}
    variants = {name: edits[name] for name in args.variant}
    for item in args.geometry:
        name, spec = item.split("=", 1)
        variants[name] = lambda src, spec=spec: geometry(src, spec)
    libs = _libraries(fa, args.workdir, variants)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    recs = []
    for shape in args.shape or ["32,512,4,256"]:
        for dtype in args.dtype or ["bf16", "fp32"]:
            rec = {**_record(fa, libs, dev, flush, dtype,
                             *(int(x) for x in shape.split(","))), **where}
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
