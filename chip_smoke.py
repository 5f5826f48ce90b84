"""On-card smoke test of the PyTorch/CUDA port (``fedml_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build the hand-written kernels from ``fedml_tpu_torch/csrc`` into
   ``build/`` and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes of the main path, and time kernel, plain version, one library
   call computing the same function (a yardstick only) and the bound;
3. drive the main path -- lane-packed FedAvg on full-width ResNet-56
   (bf16, 8 lanes, batch 64, synthetic LDA alpha=0.5 CIFAR-shaped data,
   augmentation on, ``lane_lowering="pallas"``) for 2 rounds through
   ``FedAvgAPI`` -- and show from the launch counters that it ran through
   the kernel (53 stride-1 convs per step);
4. print the ``kernels`` JSON line and, last, the ``ok`` line.

``python3 chip_smoke.py --profile`` adds, before the last lines, one
timed round per lane lowering and a ``torch.profiler`` breakdown of a
``pallas`` round by kernel.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
L, B = 8, 64
# (label, Ci, Co, H, stride-1 convs of this shape in one ResNet-56 step)
DW_SHAPES = [("stem", 3, 16, 32, 1), ("stage1", 16, 16, 32, 18),
             ("stage2", 32, 32, 16, 17), ("stage3", 64, 64, 8, 17)]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, flush, iters=20, warmup=3):
    """Mean device time of ``fn`` per call (CUDA events), with the L2
    cache flushed before each call as the training step would find it."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def phase_kernels(torch, grouped_conv):
    """Kernel vs plain version at the main path's four dW shapes."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for label, ci, co, hw, per_step in DW_SHAPES:
        x = torch.randn((B, L * ci, hw, hw), generator=gen, device=dev
                        ).to(torch.bfloat16)
        dy = torch.randn((B, L * co, hw, hw), generator=gen, device=dev
                         ).to(torch.bfloat16)
        args = (x, dy, L, 3, 3, (1, 1))
        got = grouped_conv.grouped_conv_dw(*args)
        ref = grouped_conv.grouped_conv_dw_reference(x.float(), dy.float(),
                                                     L, 3, 3, (1, 1))
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-3
        if not math.isfinite(err) or err > tol:
            fail(f"grouped_conv_dw {label}: max|err| {err} > tol {tol}")
        w_shape = (L * co, ci, 3, 3)
        ms = timed_ms(lambda: grouped_conv.grouped_conv_dw(*args), flush)
        plain_ms = timed_ms(
            lambda: grouped_conv.grouped_conv_dw_reference(*args), flush)
        library_ms = timed_ms(lambda: torch.nn.grad.conv2d_weight(
            x, w_shape, dy, padding=1, groups=L), flush)
        K = B * hw * hw
        nbytes = x.numel() * 2 + dy.numel() * 2 + L * co * ci * 9 * 4
        ops = 2 * L * ci * co * 9 * K
        row = {"shape": label, "x": list(x.shape), "dy": list(dy.shape),
               "convs_per_step": per_step, "max_abs_err": err, "tol": tol,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "ops_ms": ops / BF16_OPS_PER_S * 1e3}
        print("dw_shape " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def build_api(torch, lowering="pallas"):
    """FedAvgAPI of the main path: ResNet-56 (bf16), 16 clients x 256
    synthetic LDA alpha=0.5 samples, 8 lanes, batch 64, SGD lr 0.001 wd
    0.001, augmentation on, on the card as a user would call it."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.data.augment import make_cifar_augment
    from fedml_tpu_torch.data.synthetic import load_synthetic_images
    from fedml_tpu_torch.models import resnet56

    clients = 16
    dataset = load_synthetic_images(
        client_num=clients, n_train=clients * 256, n_test=256,
        image_size=32, partition="hetero", partition_alpha=0.5, seed=0)
    model = resnet56(class_num=10, dtype=torch.bfloat16)
    spec = make_classification_spec(
        model, augment_fn=make_cifar_augment(pad=4, cutout_length=16),
        lane_lowering=lowering)
    args = types.SimpleNamespace(
        client_num_in_total=clients, client_num_per_round=clients,
        comm_round=2, epochs=1, batch_size=B, lr=0.001, wd=0.001,
        client_optimizer="sgd", frequency_of_the_test=10 ** 9, seed=0,
        client_chunk=L, wave_mode=3, device_resident="auto",
        device_data_cap_gb=4.0, device_dtype=None)
    return FedAvgAPI(dataset, spec, args)


def phase_main_path(torch, grouped_conv):
    """Two rounds of lane-packed FedAvg on full-width ResNet-56."""
    api = build_api(torch)
    if api.device.type != "cuda":
        fail(f"FedAvgAPI chose {api.device}")
    g0 = {k: v.clone() for k, v in api.global_state["params"].items()}
    grouped_conv.launches = 0
    records, trips = [], []
    for _ in range(2):
        records.append(api.train_one_round())
        trips.append(api._last_trip)
    launches = grouped_conv.launches
    records[-1].update(api.evaluate_global())
    for r in records:
        print("round " + json.dumps(r), flush=True)
    expect = 53 * sum(trips)
    if launches != expect:
        fail(f"grouped_conv_dw launched {launches} times, expected 53 x "
             f"{sum(trips)} lane steps = {expect}")
    for r in records:
        if not (math.isfinite(r["Train/Loss"])
                and math.isfinite(r["Test/Loss"] if "Test/Loss" in r
                                  else 0.0)):
            fail(f"non-finite loss in {r}")
    moved = max(float((api.global_state["params"][k] - g0[k]).abs().max())
                for k in g0)
    finite = all(bool(torch.isfinite(v).all())
                 for part in api.global_state.values()
                 for v in part.values())
    if not finite or moved <= 0.0:
        fail(f"global state finite={finite}, max param change {moved}")
    print(f"main_path rounds={len(records)} lane_steps={sum(trips)} "
          f"kernel_launches={launches} max_param_change={moved} "
          f"round_time_s={[r['round_time_s'] for r in records]}",
          flush=True)
    return launches


def phase_profile(torch):
    """``--profile``: one round per lane lowering after a warm-up round
    (round time), then one ``pallas`` round under ``torch.profiler``:
    device time by kernel and the device's busy share of the round."""
    from torch.profiler import ProfilerActivity, profile

    for lowering in ("blockdiag", "bgc", "auto", "pallas"):
        api = build_api(torch, lowering)
        api.train_one_round()
        r = api.train_one_round()
        print(f"profile lowering={lowering} lane_steps={api._last_trip} "
              f"round_time_s={r['round_time_s']}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        api.train_one_round()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    print(f"profile round wall_us={wall_us:.0f} device_busy_us={busy:.0f} "
          f"busy_share={busy / wall_us:.4f} kernels={len(by_name)}",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"profile kernel us={us:.0f} share={us / busy:.4f} "
              f"{name[:110]}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    sys.path.insert(0, HERE)
    from fedml_tpu_torch.ops import grouped_conv

    t0 = time.time()
    report = grouped_conv.build()
    print(report, file=sys.stderr)
    print(f"build_s {time.time() - t0:.1f}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    rows = phase_kernels(torch, grouped_conv)
    launches = phase_main_path(torch, grouped_conv)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch)

    per_step = lambda key: sum(r[key] * r["convs_per_step"] for r in rows)
    bytes_ms, ops_ms = per_step("bytes_ms"), per_step("ops_ms")
    kernels = [{
        "name": "grouped_conv_dw", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/grouped_conv_dw.cu",
        "replaces": "fedml_tpu/ops/pallas_grouped_conv.py:66",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times are per training step: the 53 stride-1 dW calls of one
        # ResNet-56 step at L=8, B=64 (shape times x convs per step)
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_step("library_ms")}]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
