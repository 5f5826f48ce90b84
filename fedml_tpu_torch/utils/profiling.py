"""Profiling and the round loops' end-of-round sync (counterpart of
``fedml_tpu/utils/profiling.py``).

- :func:`profile_trace` traces a block of rounds (``--profile_dir``), and
  :func:`start_trace`/:func:`stop_trace` open and close one capture by
  hand (the perf monitor's ``--xprof_round`` window): ``torch.profiler``
  in place of ``jax.profiler``, written as a Chrome trace (Perfetto /
  ``chrome://tracing``).
- :func:`end_of_round_sync` is the single end-of-round host sync of every
  round loop and :func:`off_round_work` marks work between rounds: the
  interception points of the runtime auditor
  (``fedml_tpu_torch.analysis.runtime``) and the compile watcher
  (``fedml_tpu_torch.observability.compilemon``).
"""

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
            e.time_range.elapsed_us() for e in _device_events(prof))
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(str(log_dir), "trace.json")
    prof.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)


class MissingDeviceTrace(RuntimeError):
    """A capture on a machine with a card recorded no device activity."""


def _device_events(prof):
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


_capture = None  # (profile, log_dir) of the capture start_trace opened


def start_trace(log_dir):
    """Start capturing the host and, where there is one, the card
    (``torch.profiler``; counterpart of ``jax.profiler.start_trace``).
    Raises ``RuntimeError`` when a capture of this module is already
    running, as the reference's does."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a profiler trace is already running")
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _capture = (prof, str(log_dir))


def stop_trace():
    """Stop the capture :func:`start_trace` opened and write it to
    ``<log_dir>/trace.json``; returns the path. With a card, a capture
    without device events raises :class:`MissingDeviceTrace` (after the
    file is written, so it can be read)."""
    global _capture
    if _capture is None:
        raise RuntimeError("no profiler trace is running")
    import torch

    (prof, log_dir), _capture = _capture, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if torch.cuda.is_available() and not _device_events(prof):
        raise MissingDeviceTrace(f"the capture in {path} holds no device "
                                 "events")
    logging.info("profiler trace written to %s", path)
    return path


def end_of_round_sync(state, device=None):
    """The round loops' single end-of-round host sync: wait for the
    round's device work, so ``round_time_s`` measures it, and return
    ``state``. ``device`` is the run's device (that of the state's first
    tensor when None). Under :func:`~fedml_tpu_torch.analysis.runtime.
    audit` the auditor also counts the state's leaves off the device (the
    transfer guard); a compile watcher (which an audit arms or joins)
    closes its round bucket. With neither it only synchronizes."""
    from fedml_tpu_torch.analysis.runtime import (current_auditor,
                                                  state_device, synchronize)
    from fedml_tpu_torch.observability.compilemon import current_watcher

    device = device if device is not None else state_device(state)
    auditor = current_auditor()
    if auditor is not None:
        auditor.check_transfers(state, device)
    synchronize(device)
    watcher = current_watcher()
    if watcher is not None:
        watcher.mark_round()
    return state


@contextlib.contextmanager
def off_round_work():
    """Mark host-driven work between federated rounds (periodic eval,
    checkpoint restore). No-op normally; under an active compile watcher
    (a runtime audit arms one) its kernel loads are booked between
    rounds instead of charging the next round's bucket."""
    from fedml_tpu_torch.observability.compilemon import current_watcher

    watcher = current_watcher()
    if watcher is None:
        yield
        return
    with watcher.off_round():
        yield


__all__ = ["profile_trace", "start_trace", "stop_trace",
           "MissingDeviceTrace", "end_of_round_sync", "off_round_work"]
