"""Persistent build cache of the port's kernel libraries (counterpart of
``fedml_tpu/utils/compile_cache.py``).

The reference persists XLA executables across processes. The port's
compiled programs are its kernel libraries (``ops/_build.py``): each is
built by ``nvcc`` into the build directory under a key that hashes its
sources and flags, and a later process loads it from there instead of
building it again. :func:`enable_compilation_cache` points that
directory at ``--compile_cache_dir``, and :func:`compilation_cache` does
so for one run and puts the previous directory back after it; the
default stays ``build/`` at the root of the checkout.

``FEDML_TPU_COMPILE_CACHE=/path`` names the directory when no argument
does, as in the reference. ``FEDML_TPU_COMPILE_CACHE=0`` is the
reference's opt-out as far as it applies: nothing is redirected and the
function returns None, but the kernels still build into the default
directory, since the port cannot run them unbuilt.
"""

from __future__ import annotations

import contextlib
import os

from fedml_tpu_torch.ops import _build

ENV = "FEDML_TPU_COMPILE_CACHE"


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Build and look for kernel libraries in ``cache_dir`` (else the
    environment's directory, else ``build/``). Returns the directory in
    use, or None when ``FEDML_TPU_COMPILE_CACHE=0`` opts out. Safe to
    call more than once; an explicit argument beats the environment."""
    if cache_dir is None:
        env = os.environ.get(ENV)
        if env == "0":
            _build.set_build_dir(None)
            return None
        cache_dir = env or None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    return _build.build_dir()


@contextlib.contextmanager
def compilation_cache(cache_dir: str | None = None):
    """:func:`enable_compilation_cache` for the block (yields the
    directory in use); the previous build directory is restored on
    exit."""
    prev = _build.build_dir()
    try:
        yield enable_compilation_cache(cache_dir)
    finally:
        _build.set_build_dir(prev)


__all__ = ["enable_compilation_cache", "compilation_cache", "ENV"]
