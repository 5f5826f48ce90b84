"""The port's kernel build helper (``fedml_tpu_torch/ops/_build.py``)
without a compiler: the key that names a built library follows the
source, every ``csrc/*.cuh`` header and the flags, and the ``-Xptxas -v``
report parses into registers and spills per kernel."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import os

import pytest

from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.ops._build import CudaLibrary


def _library(tmp_path):
    return CudaLibrary("kern", bind=None, csrc=str(tmp_path / "csrc"),
                       build_dir=str(tmp_path / "build"))


SOURCE = '#include "mma.cuh"\nint f() {{ return {}; }}\n'


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "kern.cu").write_text(SOURCE.format(1))
    (d / "mma.cuh").write_text("// v1\n")
    return d


def test_key_stays_put_when_nothing_changes(tmp_path, csrc):
    lib = _library(tmp_path)
    key = lib.key()
    assert lib.key() == key == _library(tmp_path).key()
    # touching a file without changing it keeps the library
    os.utime(csrc / "mma.cuh", (1, 1))
    assert lib.key() == key
    assert lib.path() == os.path.join(str(tmp_path / "build"),
                                      f"libkern-{key}.so")


@pytest.mark.parametrize("edit", ["header", "new_header", "source", "flags"])
def test_key_follows_sources_headers_and_flags(tmp_path, csrc, edit,
                                              monkeypatch):
    before = _library(tmp_path)
    key, path = before.key(), before.path()
    if edit == "header":
        (csrc / "mma.cuh").write_text("// v2\n")
    elif edit == "new_header":
        (csrc / "tiles.cuh").write_text("// tiles\n")
    elif edit == "source":
        (csrc / "kern.cu").write_text(SOURCE.format(2))
    else:
        monkeypatch.setattr(_build, "_NVCC_FLAGS",
                            [*_build._NVCC_FLAGS, "-lineinfo"])
    changed = _library(tmp_path)
    assert changed.key() != key and changed.path() != path


def test_key_returns_when_a_header_edit_is_undone(tmp_path, csrc):
    key = _library(tmp_path).key()
    (csrc / "mma.cuh").write_text("// v2\n")
    assert _library(tmp_path).key() != key
    (csrc / "mma.cuh").write_text("// v1\n")
    assert _library(tmp_path).key() == key


def test_a_built_library_is_not_compiled_again(tmp_path, csrc):
    """``_start`` launches no compiler when the keyed library exists."""
    lib = _library(tmp_path)
    os.makedirs(lib.build_dir)
    open(lib.path(), "wb").close()
    assert lib._start(lib.path()) is None


REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z9dq_kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z9dq_kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_Z10dkv_kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z10dkv_kernelILi128EEvv
    16 bytes stack frame, 12 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 432 bytes cmem[0]
"""

# the bf16 and the fp32 (3xTF32) tensor-core forwards at D = 128, mangled
# as the Itanium ABI mangles their signatures in csrc/flash_attention.cu
FWD_MMA = ("_ZN12_GLOBAL__N_114fwd_mma_kernelILi128EEEvPK13__nv_bfloat16"
           "S3_S3_PS1_PfNS_7StridesES6_S6_S6_iiiifb")
FWD_F32 = ("_ZN12_GLOBAL__N_115fwd_tf32_kernelILi128EEEvPKfS2_S2_PfS3_NS_"
           "7StridesES4_S4_S4_iiiifb")
FWD_REPORT = f"""\
ptxas info    : Compiling entry function '{FWD_F32}' for 'sm_90a'
ptxas info    : Function properties for {FWD_F32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '{FWD_MMA}' for 'sm_90a'
ptxas info    : Function properties for {FWD_MMA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 440 bytes cmem[0]
"""


@pytest.mark.parametrize("report,want,tagged", [
    (REPORT, {"_Z9dq_kernelILi128EEvv": {"spill_stores": 0, "spill_loads": 0,
                                         "registers": 126},
              "_Z10dkv_kernelILi128EEvv": {"spill_stores": 12,
                                           "spill_loads": 28,
                                           "registers": 128}}, None),
    (FWD_REPORT, {FWD_F32: {"spill_stores": 0, "spill_loads": 0,
                            "registers": 90},
                  FWD_MMA: {"spill_stores": 0, "spill_loads": 0,
                            "registers": 168}}, FWD_MMA)],
    ids=["bwd", "fwd_mma"])
def test_ptxas_usage_reads_registers_and_spills_per_kernel(report, want,
                                                           tagged):
    """Registers and spills per mangled name; the tags by which
    ``chip_smoke.py`` finds the bf16 and the fp32 forward each name it
    alone."""
    usage = _build.ptxas_usage(report)
    assert usage == want
    assert _build.ptxas_usage("") == {}
    if tagged:
        tag = fa.mma_kernel_tag("fwd", 128)
        assert [k for k in usage if tag in k] == [tagged]
        tag = fa.mma_kernel_tag("fwd", 128, fa.TF32_KERNELS)
        assert [k for k in usage if tag in k] == [FWD_F32]
