"""The source edits of ``scripts/bench_flash_variants.py`` without a
compiler: each applies to the committed forward kernel above D 128
(``fwd_wide_kernel`` in ``csrc/flash_attention.cu``) and changes only
what it names, and a source without its marker stops the script."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import pytest

from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.scripts import bench_flash_variants as bv


@pytest.fixture(scope="module")
def src():
    with open(fa.LIBRARY.source) as f:
        return f.read()


def _kernel_body(src):
    start, end = bv._kernel(src)
    return src[start:end]


@pytest.mark.parametrize("edit,gone,added", [
    ("stage_only", "    if (k0 >= kend_w) continue;",
     "if (k0 >= kend_w || nc > 0) continue;"),
    ("compute_only", "if (kt + 1 < nkt) stage_kv(kt + 1);", None),
    ("stamps", None, "atomicAdd(&g_stamps[i], ph[i]);"),
])
def test_edits_change_only_the_kernel(src, edit, gone, added):
    out = getattr(bv, edit)(src)
    body = _kernel_body(out)
    if gone is not None:
        assert gone in _kernel_body(src) and gone not in body
    if added is not None:
        assert added in body
    # nothing before the kernel changes but the stamps' counters
    start = bv._kernel(src)[0]
    head = out[:bv._kernel(out)[0]]
    assert head.replace("__device__ unsigned long long g_stamps[6];\n",
                        "") == src[:start]


def test_stamps_time_every_phase_of_a_tile(src):
    body = _kernel_body(bv.stamps(src))
    for i, t in enumerate(("t0", "t1", "t2", "t3", "t4")):
        assert f"long long {t} = clock64();" in body
        if i:
            assert f"ph[{i - 1}] += {t} - t{i - 1};" in body
    assert 'extern "C" int fedml_stamps_read' in bv.stamps(src)


def test_geometry_overrides_only_the_named_instances(src):
    out = bv.geometry(src, "bf16:256:64:64:1;fp32:384:32:16:1")
    struct = out[out.index("struct FwdWide"):out.index("kSmem")]
    assert "(kBf16 && D == 256) ? 64 : (!kBf16 && D == 384) ? 32 :" in struct
    assert "(kBf16 && D == 256) ? 1 : (!kBf16 && D == 384) ? 1 :" in struct
    assert "//" not in struct.split("kRows =", 1)[1]
    # the instances not named keep the built expressions
    built = src[src.index("struct FwdWide"):src.index("kSmem")]
    assert "(D == 512 ? 32 : 64)" in struct and "D == 512 ? 32 : 64" in built
    assert _kernel_body(out) == _kernel_body(src)


def test_a_source_without_the_marker_stops_the_script(src):
    moved = src.replace("    if (k0 >= kend_w) continue;",
                        "    if (kend_w <= k0) continue;")
    with pytest.raises(SystemExit, match="fwd_wide_kernel has no"):
        bv.stage_only(moved)
