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

The build directory is :func:`build_dir` (``build/`` by default;
``utils/compile_cache.py`` points it at ``--compile_cache_dir``), and
every build and every first load of a library in this process is
announced to the listeners of :func:`add_build_listener`: the compile
watcher (``observability/compilemon.py``) books them per round, and the
runtime auditor (``analysis/runtime.py``) reads its rounds.
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
_build_dir = _BUILD_DIR
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: this process's builds: ``nvcc`` runs, the wall seconds spent waiting on
#: them, and libraries loaded as already built (a cache hit)
build_stats = {"builds": 0, "seconds": 0.0, "cached": 0}
_listeners = []


def build_dir():
    """Where libraries are built and looked for: ``build/`` at the root
    of the checkout unless :func:`set_build_dir` moved it."""
    return _build_dir


def set_build_dir(path):
    """Build and look for libraries in ``path`` (None: ``build/`` at the
    root of the checkout); returns the previous directory."""
    global _build_dir
    prev, _build_dir = _build_dir, path or _BUILD_DIR
    return prev


def add_build_listener(fn):
    """Call ``fn(event, **fields)`` on every build and every first load:
    ``("build", names=[...], seconds=wall)`` once per ``nvcc`` batch
    (the batch's compilers run at once, so it carries their common wall
    seconds) and ``("load", name=..., cached=bool)`` when a library is
    loaded into this process, ``cached`` when it was already built."""
    _listeners.append(fn)


def remove_build_listener(fn):
    if fn in _listeners:
        _listeners.remove(fn)


def _notify(event, **fields):
    for fn in list(_listeners):
        fn(event, **fields)


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

    def __init__(self, name, bind, csrc=_CSRC, build_dir=None):
        self.name = name
        self.csrc = csrc
        self._build_dir = build_dir
        self.source = os.path.join(csrc, f"{name}.cu")
        self._bind = bind
        self._lib = None
        self._loaded = None
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

    @property
    def build_dir(self):
        """The directory given at construction, else :func:`build_dir`."""
        return self._build_dir or _build_dir

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
        with ``output``. Returns the compiler's report for this library.
        A library this process had loaded from another path (another
        build directory) is loaded again."""
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
        if self._lib is None or self._loaded != path:
            lib = ctypes.CDLL(path)
            self._bind(lib)
            self._lib, self._loaded = lib, path
            _notify("load", name=self.name, cached=started is None)
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
            seconds = time.perf_counter() - t0
            build_stats["builds"] += built
            build_stats["seconds"] += seconds
            _notify("build", seconds=seconds,
                    names=[lib.name for lib, s in zip(libraries, started)
                           if s is not None])
        build_stats["cached"] += sum(
            s is None and lib._loaded != p
            for lib, p, s in zip(libraries, paths, started))
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


__all__ = ["CudaLibrary", "build_all", "build_stats", "build_dir",
           "set_build_dir", "add_build_listener", "remove_build_listener",
           "nvcc", "ptxas_usage"]
