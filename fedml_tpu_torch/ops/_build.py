"""Build and load the port's hand-written CUDA kernels.

Every ``fedml_tpu_torch/csrc/<name>.cu`` has a plain C interface. It is
compiled by ``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` at the
root of the checkout (git-ignored) when the library is missing or older
than its source, and loaded with ``ctypes``; every pointer and the
stream cross as ``c_void_p``. Nothing is compiled when a module is
imported: a wrapper builds its library at its first launch, and
:func:`build_all` builds several at once, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_REPO, "fedml_tpu_torch", "csrc")
_BUILD_DIR = os.path.join(_REPO, "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc():
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source with the CUDA toolkit")


class CudaLibrary:
    """One kernel source and the shared library built from it.

    ``bind(lib)`` declares ``argtypes``/``restype`` of the library's C
    functions once it is loaded. :attr:`lib` builds on first use."""

    def __init__(self, name, bind):
        self.name = name
        self.source = os.path.join(_CSRC, f"{name}.cu")
        self.path = os.path.join(_BUILD_DIR, f"lib{name}.so")
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def _stale(self):
        return (not os.path.exists(self.path)
                or os.path.getmtime(self.path) < os.path.getmtime(self.source))

    def _start(self):
        """Start ``nvcc`` when the library is stale; returns the process
        and its output path, or None."""
        if not self._stale():
            return None
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc(), *_NVCC_FLAGS, "-o", tmp, self.source],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        return proc, tmp

    def _finish(self, started, output):
        """Load and bind after the compiler (if it ran) has exited with
        ``output``. Returns the compiler's ``-Xptxas -v`` report, or
        ``""``."""
        report = ""
        if started is not None:
            proc, tmp = started
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"({proc.returncode}):\n{output}")
            os.replace(tmp, self.path)
            report = output
            self._lib = None
        if self._lib is None:
            lib = ctypes.CDLL(self.path)
            self._bind(lib)
            self._lib = lib
        return report

    def build(self):
        """Compile (when stale) and load; returns the compiler's report."""
        return build_all([self])[self.name]

    @property
    def lib(self):
        if self._lib is None:
            self.build()
        return self._lib


def build_all(libraries):
    """Compile every stale library at once, one ``nvcc`` each, then load
    them all. Returns ``{name: compiler report}``."""
    libraries = sorted(libraries, key=lambda lib: lib.name)
    for lib in libraries:
        lib._lock.acquire()
    try:
        started = [lib._start() for lib in libraries]
        # every compiler has exited before any result is judged
        outputs = ["".join(s[0].communicate()) if s else "" for s in started]
        return {lib.name: lib._finish(s, out)
                for lib, s, out in zip(libraries, started, outputs)}
    finally:
        for lib in libraries:
            lib._lock.release()


__all__ = ["CudaLibrary", "build_all", "nvcc"]
