"""The native packing shim (counterpart of ``fedml_tpu/native``): the
port's own copy of ``packing.cpp``, built with ``g++`` at first use and
loaded with ``ctypes``.

The library is built into ``build/libpacking-<key>.so`` at the root of
the checkout (git-ignored), the key a hash of the source and the
compiler flags, so an edit builds a new library and nothing stale is
loaded; a build writes a temporary file and renames it, so concurrent
processes never load half a library. Nothing is built when the module is
imported. :func:`load_native` returns the library or None (and
:func:`native_error` says why); :func:`require_native` raises with the
compiler's output instead, for callers that asked for the native backend
by name. ``FEDML_TPU_NO_NATIVE`` set makes the shim unavailable, as in
the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "packing.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
CXX = "g++"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_state = {"lib": None, "error": None, "tried": False}


def library_path():
    """``build/libpacking-<key>.so`` of the source and flags as they are."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update("\0".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpacking-{h.hexdigest()[:16]}.so")


def reset():
    """Forget the loaded library and the last failure (the next call
    builds or loads again)."""
    with _lock:
        _state.update(lib=None, error=None, tried=False)


def _bind(lib):
    i64, f32, i32 = (ctypes.POINTER(ctypes.c_int64),
                     ctypes.POINTER(ctypes.c_float),
                     ctypes.POINTER(ctypes.c_int32))
    lib.pack_schedule.argtypes = [i64, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_uint64, i64, f32]
    lib.pack_gather.argtypes = [ctypes.POINTER(ctypes.c_void_p), i64, f32,
                                ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_void_p]
    lib.pack_lanes_fill.argtypes = [i32, f32, f32, i64, i64, i64,
                                    *([ctypes.c_int64] * 5),
                                    i32, f32, i32, i32, f32, f32, f32]
    for fn in (lib.pack_schedule, lib.pack_gather, lib.pack_lanes_fill):
        fn.restype = None
    return lib


def _build(path):
    """Compile the shim into ``path``; returns None or the failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([CXX, *FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{CXX} could not run: {e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return (f"{CXX} failed on {SOURCE} ({proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, path)
    return None


def load_native():
    """The bound library, building it when it is not built yet; None
    when the shim is unavailable (:func:`native_error` says why)."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        if os.environ.get("FEDML_TPU_NO_NATIVE"):
            _state["error"] = "FEDML_TPU_NO_NATIVE is set"
            return None
        path = library_path()
        err = None if os.path.exists(path) else _build(path)
        if err is None:
            try:
                _state["lib"] = _bind(ctypes.CDLL(path))
            except OSError as e:
                err = f"could not load {path}: {e}"
        _state["error"] = err
        return _state["lib"]


def native_available() -> bool:
    """True iff the shim builds (or is built) and loads here."""
    return load_native() is not None


def native_error():
    """Why the shim is unavailable (the compiler's output for a failed
    build), or None."""
    load_native()
    return _state["error"]


def require_native():
    """The library, or ``RuntimeError`` with the reason it is
    unavailable: the native backend asked for by name never falls back
    to numpy."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native packing backend was asked for but "
                           f"the shim is unavailable: {_state['error']}")
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _schedule(lib, n, S, B, epochs, seed):
    C = len(n)
    idx = np.zeros((C, S, B), np.int64)
    mask = np.zeros((C, S, B), np.float32)
    lib.pack_schedule(_ptr(n, ctypes.c_int64), C, S, B, epochs,
                      ctypes.c_uint64(seed), _ptr(idx, ctypes.c_int64),
                      _ptr(mask, ctypes.c_float))
    return idx, mask


def native_pack_schedule(ns, batch_size, epochs, S, seed):
    """The C++ schedule (no data movement): ``{"idx", "mask", "n"}``."""
    lib = require_native()
    n = np.asarray(ns, np.int64)
    idx, mask = _schedule(lib, n, S, batch_size, epochs, seed)
    return {"idx": idx.astype(np.int32), "mask": mask,
            "n": n.astype(np.float32)}


def native_pack_lanes_fill(idx, mask, ns, steps_pc, members, offsets, K, L):
    """The C++ lane relayout (the ``[K, L, B]`` fill of
    ``packing.pack_lanes``; the LPT membership comes in as CSR
    ``members``/``offsets``)."""
    lib = require_native()
    C, S, B = idx.shape
    idx = np.ascontiguousarray(idx, np.int32)
    mask = np.ascontiguousarray(mask, np.float32)
    ns = np.ascontiguousarray(ns, np.float32)
    steps_pc = np.ascontiguousarray(steps_pc, np.int64)
    members = np.ascontiguousarray(members, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    out = {"idx": np.zeros((K, L, B), np.int32),
           "mask": np.zeros((K, L, B), np.float32),
           "slot": np.zeros((K, L), np.int32),
           "local_step": np.zeros((K, L), np.int32),
           "flush": np.zeros((K, L), np.float32),
           "flush_n": np.zeros((K, L), np.float32),
           "flush_steps": np.zeros((K, L), np.float32)}
    i32, f32, i64 = ctypes.c_int32, ctypes.c_float, ctypes.c_int64
    lib.pack_lanes_fill(
        _ptr(idx, i32), _ptr(mask, f32), _ptr(ns, f32), _ptr(steps_pc, i64),
        _ptr(members, i64), _ptr(offsets, i64), C, S, B, K, L,
        _ptr(out["idx"], i32), _ptr(out["mask"], f32),
        _ptr(out["slot"], i32), _ptr(out["local_step"], i32),
        _ptr(out["flush"], f32), _ptr(out["flush_n"], f32),
        _ptr(out["flush_steps"], f32))
    return out


def native_pack_cohort(client_datasets, batch_size, epochs, S, seed):
    """The C++ schedule and the gather of ``x``/``y`` into ``[C, S, B,
    ...]``: ``{"x", "y", "mask", "n", "idx"}``."""
    lib = require_native()
    C, B = len(client_datasets), batch_size
    n = np.asarray([len(d["y"]) for d in client_datasets], np.int64)
    idx, mask = _schedule(lib, n, S, B, epochs, seed)
    out = {"mask": mask, "n": n.astype(np.float32),
           "idx": idx.astype(np.int32)}
    for key in ("x", "y"):
        proto = np.asarray(client_datasets[0][key])
        arrs = [np.ascontiguousarray(np.asarray(d[key], proto.dtype))
                for d in client_datasets]
        row_bytes = int(np.prod(proto.shape[1:], dtype=np.int64)
                        * proto.dtype.itemsize)
        dst = np.zeros((C, S, B) + proto.shape[1:], proto.dtype)
        ptrs = (ctypes.c_void_p * C)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs])
        lib.pack_gather(ptrs, _ptr(idx, ctypes.c_int64),
                        _ptr(mask, ctypes.c_float), C, S, B, row_bytes,
                        dst.ctypes.data_as(ctypes.c_void_p))
        out[key] = dst
    return out


__all__ = ["load_native", "native_available", "native_error",
           "require_native", "reset", "library_path",
           "native_pack_schedule", "native_pack_lanes_fill",
           "native_pack_cohort"]
