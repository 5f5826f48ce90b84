"""What the measurement scripts share: the platform flag, the device, the
card's name and power limit beside every number, and the timers (CUDA
events on the card, the host clock on the CPU; ``flushed_ms`` for one
kernel, which ``chip_smoke.py`` uses too)."""

from __future__ import annotations

import time

import torch


def add_platform_flag(parser):
    parser.add_argument("--platform", choices=("cpu",), default=None,
                        help="cpu runs on the CPU (the kernels' plain "
                             "versions, the host clock); default the card, "
                             "with no fallback")


def device_of(args) -> torch.device:
    """The card, or the CPU for ``--platform cpu``; raises without a
    card otherwise."""
    from fedml_tpu_torch.utils.device import resolve_device

    return resolve_device("cpu" if args.platform == "cpu" else None)


def device_record(device):
    """The fields every script's JSON line carries about where it ran
    (``bench.device_fields``: the card's name and power limit; the
    platform and the timer), and the card's dense bf16 peak FLOP/s (None
    on the CPU)."""
    from fedml_tpu_torch.bench import device_fields

    fields, peak = device_fields(device)
    on_card = device.type == "cuda"
    return ({**fields, "platform": "gpu" if on_card else "cpu",
             "timer": "cuda_events" if on_card else "host_clock"}, peak)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def call_ms(fn, device, repeats, warmup=2):
    """Milliseconds of each of ``repeats`` calls of ``fn`` after
    ``warmup`` untimed ones: CUDA events around the call on the card
    (after a synchronise), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def flushed_ms(fn, flush, iters=20, warmup=3):
    """Median device time (ms) of ``fn`` a call (CUDA events), with the
    L2 cache flushed before each call (``flush``, a 64 MB buffer, zeroed)
    as a training step would find it. A 10 ms spin on the device after
    the flush covers the host's time to enqueue ``fn`` (autograd's
    backward of one attention call outlasted a spin of half a
    millisecond), so the events time the device's work and not the
    launch path; the median drops a call whose host side stalled past
    the spin. ``chip_smoke.py`` times every kernel with it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return median(times)
