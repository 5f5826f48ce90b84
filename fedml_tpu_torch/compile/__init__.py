"""Round-program warmup of the port (counterpart of
``fedml_tpu/compile``).

The reference compiles every jitted round program ahead of time through
XLA's persistent cache, so a restarted server starts in cache-load time.
The port's compiled programs are its kernel libraries
(``ops/_build.py``); eager PyTorch compiles nothing else:

- :func:`~fedml_tpu_torch.compile.warmup.enumerate_round_programs` names
  the libraries a constructed API's rounds will launch on its device and
  the step shapes they train at (``flash_attention`` for the LM
  families, ``grouped_conv_dw`` under ``--lane_lowering pallas`` on the
  packed lanes);
- :func:`~fedml_tpu_torch.compile.warmup.warmup_api` builds or loads them
  all at once through ``build_all`` before the round loop, reporting
  seconds and the compile watcher's hit/miss split;
- :func:`~fedml_tpu_torch.compile.warmup.warm_restart` is the recovery
  hook: point the build directory at the run's ``--compile_cache_dir``
  and warm every library, so a restarted server over a built directory
  runs no ``nvcc``.

Exposed as ``--warmup`` on the FedAvg-family mains and the port's bench.
"""

from fedml_tpu_torch.compile.warmup import (RoundProgram,
                                            enumerate_round_programs,
                                            round_kernel_libraries,
                                            warm_restart, warmup_api,
                                            warmup_programs)

__all__ = ["RoundProgram", "enumerate_round_programs",
           "round_kernel_libraries", "warmup_programs", "warmup_api",
           "warm_restart"]
