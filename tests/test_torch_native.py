"""The port's native packing shim (``fedml_tpu_torch/native``, its own
copy of ``packing.cpp`` built with ``g++`` into ``build/``) against the
JAX package's: the schedules, the gathered cohorts and the lane
relayouts byte for byte from the same seeds; ``packing_backend``
resolving as the reference's under each ``FEDML_TPU_PACKING`` value and
argument; and the native backend asked for by name raising with the
compiler's output, never falling back to numpy, when the build fails.
Skipped where there is no ``g++``."""

import os
import shutil

import numpy as np
import pytest

from fedml_tpu.parallel import packing as jpacking
from fedml_tpu_torch import native
from fedml_tpu_torch.parallel import packing

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the native shim is built with g++")


@pytest.fixture(autouse=True)
def _fresh_shim():
    native.reset()
    yield
    native.reset()


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _shards(seed=0, ns=(7, 1, 0, 12, 33, 5)):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((n, 3, 2)).astype(np.float32),
             "y": rng.integers(0, 5, n).astype(np.int64)} for n in ns]


def test_shim_builds_into_the_checkout_from_the_ports_source():
    assert native.native_available(), native.native_error()
    path = native.library_path()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(native.__file__))))
    assert os.path.dirname(path) == native.BUILD_DIR == os.path.join(
        root, "build")
    assert os.path.exists(path)
    assert native.SOURCE.startswith(os.path.dirname(native.__file__))


@pytest.mark.parametrize("bs,epochs,s_max", [(4, 1, None), (3, 2, 32),
                                             (-1, 1, None), (16, 3, None)])
def test_schedule_is_byte_equal_to_the_reference_shim(bs, epochs, s_max):
    ns = [len(d["y"]) for d in _shards()]
    kw = dict(native=True, s_max=s_max)
    _equal(packing.pack_schedule(ns, bs, epochs,
                                 rng=np.random.default_rng(9), **kw),
           jpacking.pack_schedule(ns, bs, epochs,
                                  rng=np.random.default_rng(9), **kw))


@pytest.mark.parametrize("bs,epochs,indices", [(4, 1, True), (5, 2, False),
                                               (-1, 1, True)])
def test_cohort_is_byte_equal_to_the_reference_shim(bs, epochs, indices):
    _equal(packing.pack_cohort(_shards(1), bs, epochs,
                               rng=np.random.default_rng(2), native=True,
                               return_indices=indices),
           jpacking.pack_cohort(_shards(1), bs, epochs,
                                rng=np.random.default_rng(2), native=True,
                                return_indices=indices))


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_lanes_are_byte_equal_to_the_reference_shim_and_to_numpy(lanes):
    ns = [len(d["y"]) for d in _shards()]
    sched = packing.pack_schedule(ns, 4, 2, rng=np.random.default_rng(5),
                                  native=True)
    got = packing.pack_lanes(sched, lanes, native=True)
    _equal(got, jpacking.pack_lanes(sched, lanes, native=True))
    _equal(got, packing.pack_lanes(sched, lanes, native=False))


@pytest.mark.parametrize("env", [None, "python", "native", "auto", "PYTHON"])
@pytest.mark.parametrize("arg", ["auto", True, False])
def test_backend_resolves_as_the_reference(monkeypatch, env, arg):
    if env is None:
        monkeypatch.delenv("FEDML_TPU_PACKING", raising=False)
    else:
        monkeypatch.setenv("FEDML_TPU_PACKING", env)
    assert packing.packing_backend(arg) == jpacking.packing_backend(arg)


def test_native_asked_for_by_name_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", shutil.which("false") or "false")
    native.reset()
    assert not native.native_available()
    assert "failed" in native.native_error()
    with pytest.raises(RuntimeError, match="shim is unavailable"):
        packing.pack_schedule([4, 2], 2, 1, native=True)
    monkeypatch.setenv("FEDML_TPU_PACKING", "native")
    with pytest.raises(RuntimeError, match="shim is unavailable"):
        packing.pack_cohort(_shards(), 2, 1)
    with pytest.raises(RuntimeError, match="shim is unavailable"):
        packing.pack_lanes(packing.pack_schedule([4, 2], 2, 1, native=False),
                           2)
    # auto resolves to numpy where the shim cannot be had
    monkeypatch.delenv("FEDML_TPU_PACKING")
    assert packing.packing_backend() == "python"
    assert os.listdir(tmp_path) == []   # nothing half-built is left


def test_no_native_env_makes_the_shim_unavailable(monkeypatch):
    monkeypatch.setenv("FEDML_TPU_NO_NATIVE", "1")
    monkeypatch.delenv("FEDML_TPU_PACKING", raising=False)
    assert packing.packing_backend() == "python"
    assert native.native_error() == "FEDML_TPU_NO_NATIVE is set"
