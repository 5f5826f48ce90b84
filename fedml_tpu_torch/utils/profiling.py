"""Device tracing of a block of rounds (counterpart of ``profile_trace``
in ``fedml_tpu/utils/profiling.py``): ``torch.profiler`` in place of
``jax.profiler``, written as a Chrome trace (Perfetto /
``chrome://tracing``)."""

from __future__ import annotations

import contextlib
import logging
import os
import time


@contextlib.contextmanager
def profile_trace(log_dir, enabled=True):
    """Trace the host and, where there is one, the card inside the block,
    then write ``<log_dir>/trace.json``. No-op when ``enabled`` is falsy
    or ``log_dir`` is None, so the flag can be wired straight from
    argparse.

    Yields a dict that is filled when the block ends: ``device_busy_s``,
    the seconds of the card's kernels and copies summed (None without a
    card or a trace), and ``wall_s``, the block's seconds on the host
    clock (None without a trace)."""
    out = {"device_busy_s": None, "wall_s": None}
    if not enabled or log_dir is None:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
    if torch.cuda.is_available():
        # one stream: the device events do not overlap
        out["device_busy_s"] = 1e-6 * sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(str(log_dir), "trace.json")
    prof.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)


__all__ = ["profile_trace"]
