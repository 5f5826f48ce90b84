"""Build and load the port's hand-written CUDA kernels.

Every ``fedml_tpu_torch/csrc/<name>.cu`` has a plain C interface. It is
compiled by ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<key>.so`` at
the root of the checkout (git-ignored) and loaded with ``ctypes``; every
pointer and the stream cross as ``c_void_p``. The key is a hash of the
source, of every ``csrc/*.cuh`` header and of the compiler flags, so an
edit to any of them builds a new library and nothing stale is loaded.
The compiler's ``-Xptxas -v`` report is kept beside the library
(``.log``). Nothing is compiled when a module is imported: a wrapper
builds its library at its first launch, and :func:`build_all` builds
several at once, one ``nvcc`` per source, all started together.
:data:`build_stats` counts this process's ``nvcc`` runs (the bench's
compile fields).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_REPO, "fedml_tpu_torch", "csrc")
_BUILD_DIR = os.path.join(_REPO, "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: this process's builds: ``nvcc`` runs, the wall seconds spent waiting on
#: them, and libraries loaded as already built (a cache hit)
build_stats = {"builds": 0, "seconds": 0.0, "cached": 0}


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

    def __init__(self, name, bind, csrc=_CSRC, build_dir=_BUILD_DIR):
        self.name = name
        self.csrc = csrc
        self.build_dir = build_dir
        self.source = os.path.join(csrc, f"{name}.cu")
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def key(self):
        """Hash of the source, the ``csrc/*.cuh`` headers and the flags."""
        h = hashlib.sha256()
        for path in [self.source,
                     *sorted(glob.glob(os.path.join(self.csrc, "*.cuh")))]:
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + b"\0" + f.read()
                         + b"\0")
        h.update("\0".join(_NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def path(self):
        """``build/lib<name>-<key>.so``: the library of the files as they
        stand now."""
        return os.path.join(self.build_dir, f"lib{self.name}-{self.key()}.so")

    def _start(self, path):
        """Start ``nvcc`` when ``path`` is not built yet; returns the
        process and its output path, or None."""
        if os.path.exists(path):
            return None
        os.makedirs(self.build_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc(), *_NVCC_FLAGS, "-o", tmp, self.source],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        return proc, tmp

    def _finish(self, path, started, output):
        """Load and bind ``path`` after the compiler (if it ran) has exited
        with ``output``. Returns the compiler's report for this library."""
        log = path + ".log"
        if started is not None:
            proc, tmp = started
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"({proc.returncode}):\n{output}")
            with open(log, "w") as f:
                f.write(output)
            os.replace(tmp, path)
            self._lib = None
        if self._lib is None:
            lib = ctypes.CDLL(path)
            self._bind(lib)
            self._lib = lib
        if not os.path.exists(log):
            return ""
        with open(log) as f:
            return f.read()

    def build(self):
        """Compile (when not built yet) and load; returns the compiler's
        report."""
        return build_all([self])[self.name]

    @property
    def lib(self):
        if self._lib is None:
            self.build()
        return self._lib


def build_all(libraries):
    """Compile every library not built yet at once, one ``nvcc`` each,
    then load them all. Returns ``{name: compiler report}``."""
    libraries = sorted(libraries, key=lambda lib: lib.name)
    for lib in libraries:
        lib._lock.acquire()
    try:
        paths = [lib.path() for lib in libraries]
        t0 = time.perf_counter()
        started = [lib._start(p) for lib, p in zip(libraries, paths)]
        # every compiler has exited before any result is judged
        outputs = ["".join(s[0].communicate()) if s else "" for s in started]
        built = sum(s is not None for s in started)
        if built:
            build_stats["builds"] += built
            build_stats["seconds"] += time.perf_counter() - t0
        build_stats["cached"] += sum(s is None and lib._lib is None
                                     for lib, s in zip(libraries, started))
        return {lib.name: lib._finish(p, s, out)
                for lib, p, s, out in zip(libraries, paths, started, outputs)}
    finally:
        for lib in libraries:
            lib._lock.release()


def ptxas_usage(report):
    """Per kernel of a ``-Xptxas -v`` report: ``{mangled name:
    {"registers", "spill_stores", "spill_loads"}}`` (bytes for spills)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


__all__ = ["CudaLibrary", "build_all", "build_stats", "nvcc",
           "ptxas_usage"]
