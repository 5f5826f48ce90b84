"""Kernel-library enumeration and warmup (see the package docstring).

Design constraints:

- **Nothing of the run is touched.** Warming builds and loads shared
  libraries; it reads no model or optimizer state and draws from no
  random stream, so a warmed run computes bit for bit what a cold one
  does.
- **Only what the run launches.** A kernel wrapper launches its library
  only on a card; on CPU tensors it runs its plain version. So on the
  CPU a run launches nothing and the enumeration is empty
  (:func:`round_kernel_libraries` still names what the same run would
  launch on a card).
- **One batch.** Every library is built at once, one ``nvcc`` each
  (``build_all``), so a program's seconds are the batch's.
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
import time
from typing import Any, Optional

from fedml_tpu_torch.observability.compilemon import watch_compiles
from fedml_tpu_torch.ops import _build

#: kernel library name -> the module holding its ``LIBRARY``
_LIBRARY_MODULES = {"flash_attention": "fedml_tpu_torch.ops.flash_attention",
                    "grouped_conv_dw": "fedml_tpu_torch.ops.grouped_conv"}


@dataclasses.dataclass(frozen=True)
class RoundProgram:
    """One kernel library a run launches, and the step shapes (the
    batches of clients trained at once, and of the evaluation) it
    launches it at. ``library.build()`` is the warmup unit."""

    name: str
    library: Any
    shapes: tuple


def library(name):
    """The ``CudaLibrary`` of a kernel library by name."""
    return importlib.import_module(_LIBRARY_MODULES[name]).LIBRARY


def _packed_lanes(api):
    return (getattr(api, "bucket_runner", None) is None
            and getattr(api, "device_data", None) is not None
            and getattr(api, "packed_lane_runner", None) is not None
            and int(getattr(api.args, "wave_mode", 1)) == 3)


def round_kernel_libraries(api):
    """Names of the kernel libraries ``api``'s rounds and evaluation
    launch on a card: the spec's (its train step and forward), and its
    packed lowering's when the packed lanes run."""
    spec = api.spec
    names = list(spec.kernels)
    if _packed_lanes(api):
        names += [n for n in spec.lane_kernels if n not in names]
    return names


def _step_shapes(api):
    """``(clients trained at once, batch, *sample)`` of the round path's
    steps and ``(batch, *sample)`` of the evaluation's."""
    local = getattr(api, "train_data_local_dict", None)
    if local is None:  # the centralized trainer: the pooled set, one client
        shards, k = [api.train_data_global], 1
    else:
        shards = [d for d in local.values() if d is not None and len(d["y"])]
        runner = getattr(api, "bucket_runner", None)
        if runner is not None:
            k = runner.client_chunk
        elif getattr(api, "device_data", None) is not None:
            k = int(getattr(api.args, "client_chunk", 8) or 8)
        else:
            k = int(api.args.client_num_per_round)
    sample = tuple(shards[0]["x"].shape[1:])
    bs = int(api.args.batch_size)
    if bs in (-1, 0):
        bs = max(len(d["y"]) for d in shards)
    return ((k, bs) + sample, (bs,) + sample)


def enumerate_round_programs(api) -> list:
    """Every kernel library a run of ``api`` will launch on its device,
    with the step shapes; empty on the CPU, where the wrappers run their
    plain versions."""
    if api.device.type != "cuda":
        logging.info("warmup: %s runs no kernel library (plain versions "
                     "on the CPU)", api.device)
        return []
    shapes = _step_shapes(api)
    return [RoundProgram(name, library(name), shapes)
            for name in round_kernel_libraries(api)]


def warmup_programs(programs) -> dict:
    """Build (or load) every program's library at once. Returns the
    warmup report: seconds, a program's seconds (the batch's) and the
    compile watcher's build/hit/miss tallies for exactly this warmup."""
    t0 = time.time()
    with watch_compiles() as watcher:
        before = watcher.totals()
        if programs:
            _build.build_all([p.library for p in programs])
        builds, build_s, hits, misses = (
            now - was for now, was in zip(watcher.totals(), before))
    seconds = round(time.time() - t0, 4)
    report = {
        "warmup/programs": len(programs),
        "warmup/seconds": seconds,
        "warmup/per_program_s": {p.name: seconds for p in programs},
        "warmup/compile_count": builds,
        "warmup/compile_seconds": round(build_s, 4),
        "warmup/cache_hits": hits,
        "warmup/cache_misses": misses,
    }
    logging.info("warmup: %d programs in %.2fs (%d builds %.2fs, %d cache "
                 "hits / %d misses)", len(programs), seconds, builds,
                 build_s, hits, misses)
    return report


def warmup_api(api) -> dict:
    """Enumerate and warm every kernel library of a constructed API."""
    return warmup_programs(enumerate_round_programs(api))


def warm_restart(api, cache_dir: Optional[str] = None) -> dict:
    """The recovery hook: point the build directory at the run's
    ``--compile_cache_dir`` and warm every library before the server
    re-enters the round loop. Over a built directory every library is a
    cache hit: no ``nvcc`` runs."""
    from fedml_tpu_torch.utils.compile_cache import enable_compilation_cache

    used = enable_compilation_cache(cache_dir)
    report = warmup_api(api)
    report["warmup/cache_dir"] = used
    return report


__all__ = ["RoundProgram", "library", "round_kernel_libraries",
           "enumerate_round_programs", "warmup_programs", "warmup_api",
           "warm_restart"]
