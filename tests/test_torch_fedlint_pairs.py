"""The port's fedlint held against the reference's on the same inputs.

One case for each test of the reference's ``tests/test_analysis.py``
that checks a rule with a torch meaning (``TestLintRules``, the FL109
and FL112 cases of ``TestShardingScanRules``, ``TestFl113Captures``,
``TestFl114WallclockTiming``): the reference's snippet goes through
``fedml_tpu.analysis.lint_source``, its torch translation through
``fedml_tpu_torch.analysis.lint_source``, and both must report the same
codes on the same lines -- the ones the reference's test asserts.

The translations: ``@jax.jit`` is ``@torch.compile`` (or
``torch.jit.script``), ``jnp`` is ``torch``, ``static_argnums`` over an
int parameter is ``dynamic=True``, ``jax.debug.print`` is
``breakpoint()``, ``jax.block_until_ready`` is
``torch.cuda.synchronize()``, and a ``shard_map`` whose ``in_specs``
are all ``P()`` is a step whose every ``global_put`` places with the
replicating spec ``()``. Left out, for want of a torch meaning: the
FL104 (donation) and FL111 (``lax.scan`` carry) cases, and
``test_fl102_static_argname_params_exempt`` (torch has no static
argument names)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

from fedml_tpu.analysis import lint_source as ref_lint_source
from fedml_tpu_torch.analysis import lint_source

REF_LIB = "fedml_tpu/core/fake.py"
PORT_LIB = "fedml_tpu_torch/core/fake.py"
REF_COMM = "fedml_tpu/core/comm/fake.py"
PORT_COMM = "fedml_tpu_torch/core/comm/fake.py"

_JAX_STEP = ("import time\n"
             "import jax\n"
             "@jax.jit\n"
             "def step(x):\n"
             "    return x * 2\n")
_TORCH_STEP = ("import time\n"
               "import torch\n"
               "@torch.compile\n"
               "def step(x):\n"
               "    return x * 2\n")

_SHARD = ("import jax\n"
          "from jax.sharding import PartitionSpec as P\n")
_PUT = ("import torch\n"
        "from fedml_tpu_torch.parallel.multihost import global_put\n")

#: (id, reference source, torch source, expected [(line, code)],
#:  reference path, port path)
CASES = [
    # -- TestLintRules ---------------------------------------------------
    ("fl101_host_sync",
     "import jax\n@jax.jit\ndef f(x):\n    return float(x) + x.item()\n",
     "import torch\n@torch.compile\ndef f(x):\n"
     "    return float(x) + x.item()\n",
     [(4, "FL101"), (4, "FL101")]),
    ("fl101_np_asarray",
     "import jax\nimport numpy as np\n@jax.jit\ndef f(x):\n"
     "    return np.asarray(x)\n",
     "import torch\nimport numpy as np\n@torch.compile\ndef f(x):\n"
     "    return np.asarray(x)\n",
     [(5, "FL101")]),
    ("fl101_negative_outside_and_literals",
     "import jax\ndef g(x):\n    return float(x)\n@jax.jit\ndef f(x):\n"
     "    return x * float(2)\n",
     "import torch\ndef g(x):\n    return float(x)\n@torch.compile\n"
     "def f(x):\n    return x * float(2)\n",
     []),
    ("fl102_if_on_tracer",
     "import jax\n@jax.jit\ndef f(x):\n    if x > 0:\n        return x\n"
     "    return -x\n",
     "import torch\n@torch.compile\ndef f(x):\n    if x > 0:\n"
     "        return x\n    return -x\n",
     [(4, "FL102")]),
    ("fl102_for_over_tracer",
     "import jax\n@jax.jit\ndef f(xs):\n    acc = 0\n    for x in xs:\n"
     "        acc = acc + x\n    return acc\n",
     "import torch\n@torch.compile\ndef f(xs):\n    acc = 0\n"
     "    for x in xs:\n        acc = acc + x\n    return acc\n",
     [(5, "FL102")]),
    ("fl102_negative_structural_and_none",
     "import jax\n@jax.jit\ndef f(x, mask=None):\n    if mask is None:\n"
     "        return x\n    if x.shape[0] > 2:\n        return x + 1\n"
     "    for i in range(3):\n        x = x + i\n    return x\n",
     "import torch\n@torch.compile\ndef f(x, mask=None):\n"
     "    if mask is None:\n        return x\n    if x.shape[0] > 2:\n"
     "        return x + 1\n    for i in range(3):\n        x = x + i\n"
     "    return x\n",
     []),
    ("fl103_scalar_params",
     "import jax\ndef g(x, n=4):\n    return x * n\nstep = jax.jit(g)\n",
     "import torch\ndef g(x, n=4):\n    return x * n\n"
     "step = torch.compile(g)\n",
     [(4, "FL103")]),
    ("fl103_negative_static",
     "import jax\ndef g(x, n=4):\n    return x * n\n"
     "step = jax.jit(g, static_argnums=(1,))\n",
     "import torch\ndef g(x, n=4):\n    return x * n\n"
     "step = torch.compile(g, dynamic=True)\n",
     []),
    ("fl105_numpy_compute",
     "import jax\nimport numpy as np\n@jax.jit\ndef f(x):\n"
     "    return np.mean(x)\n",
     "import torch\nimport numpy as np\n@torch.compile\ndef f(x):\n"
     "    return np.mean(x)\n",
     [(5, "FL105")]),
    ("fl105_float64_dtype",
     "import jax\nimport jax.numpy as jnp\nimport numpy as np\n@jax.jit\n"
     "def f(x):\n    return jnp.zeros((2,), dtype=np.float64) + x\n",
     "import torch\nimport torch.nn.functional as F\nimport numpy as np\n"
     "@torch.compile\ndef f(x):\n"
     "    return torch.zeros((2,), dtype=np.float64) + x\n",
     [(6, "FL105")]),
    ("fl105_negative_torch_inside_np_outside",
     "import jax\nimport jax.numpy as jnp\nimport numpy as np\n@jax.jit\n"
     "def f(x):\n    return jnp.mean(x)\ndef pack(x):\n"
     "    return np.mean(x)\n",
     "import torch\nimport torch.nn.functional as F\nimport numpy as np\n"
     "@torch.compile\ndef f(x):\n    return torch.mean(x)\ndef pack(x):\n"
     "    return np.mean(x)\n",
     []),
    ("fl106_dict_values_into_stack",
     "import jax.numpy as jnp\ndef f(d):\n"
     "    return jnp.stack(list(d.values()))\n",
     "import torch\ndef f(d):\n    return torch.stack(list(d.values()))\n",
     [(3, "FL106")]),
    ("fl106_negative_sorted",
     "import jax.numpy as jnp\ndef f(d):\n"
     "    return jnp.stack([v for _, v in sorted(d.items())])\n",
     "import torch\ndef f(d):\n"
     "    return torch.stack([v for _, v in sorted(d.items())])\n",
     []),
    ("fl107_broad_except_in_comm",
     "def recv(sock):\n    try:\n        return sock.recv(4)\n"
     "    except Exception:\n        pass\n",
     None, [(4, "FL107")], REF_COMM, PORT_COMM),
    ("fl107_scoped_models",
     "def f():\n    try:\n        return 1\n    except Exception:\n"
     "        pass\n",
     None, [], "fedml_tpu/models/cnn.py", "fedml_tpu_torch/models/cnn.py"),
    ("fl107_scoped_common",
     "def f():\n    try:\n        return 1\n    except Exception:\n"
     "        pass\n",
     None, [], "fedml_tpu/experiments/common.py",
     "fedml_tpu_torch/experiments/common.py"),
    ("fl107_negative_specific_types",
     "import logging\ndef recv(sock):\n    try:\n"
     "        return sock.recv(4)\n    except (OSError, ConnectionError):\n"
     "        logging.warning('peer died')\n",
     None, [], REF_COMM, PORT_COMM),
    ("fl108_debug_output",
     "import jax\ndef f(x):\n    print('x =', x)\n"
     "    jax.debug.print('traced {}', x)\n    return x\n",
     "import torch\ndef f(x):\n    print('x =', x)\n    breakpoint()\n"
     "    return x\n",
     [(3, "FL108"), (4, "FL108")]),
    ("fl108_negative_main",
     "def main():\n    print('usage: ...')\n", None, [],
     "fedml_tpu/experiments/main_fedavg.py",
     "fedml_tpu_torch/experiments/main_fedavg.py"),
    ("fl108_negative_prepare",
     "def main():\n    print('usage: ...')\n", None, [],
     "fedml_tpu/data/prepare.py", "fedml_tpu_torch/data/prepare.py"),
    ("syntax_error", "def f(:\n", None, [(1, "FL100")]),
    # -- TestShardingScanRules: FL109 ------------------------------------
    ("fl109_all_replicated",
     _SHARD + "def build(f, mesh):\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(P(), P()),\n"
     "                         out_specs=P())\n",
     _PUT + "def build(f, mesh, a, b):\n"
     "    return f(global_put(mesh, a, ()), global_put(mesh, b, ()),\n"
     "             mesh)\n",
     [(4, "FL109")]),
    ("fl109_negative_partitioned",
     _SHARD + "def build(f, mesh):\n    return jax.shard_map(f, mesh=mesh,\n"
     "                         in_specs=(P(), P('clients')),\n"
     "                         out_specs=P())\n",
     _PUT + "def build(f, mesh, a, b):\n"
     "    return f(global_put(mesh, a, ()),\n"
     "             global_put(mesh, b, ('clients',)),\n"
     "             mesh)\n",
     []),
    ("fl109_negative_parameter_spec",
     _SHARD + "def build(f, mesh, spec):\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(spec, P()),\n"
     "                         out_specs=P())\n",
     _PUT + "def build(f, mesh, a, b, spec):\n"
     "    return f(global_put(mesh, a, spec), global_put(mesh, b, ()),\n"
     "             mesh)\n",
     []),
    ("fl109_one_hop",
     _SHARD + "def build(f, mesh):\n    spec = P()\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(spec, spec),\n"
     "                         out_specs=spec)\n",
     _PUT + "def build(f, mesh, a, b):\n    spec = ()\n"
     "    return f(global_put(mesh, a, spec), global_put(mesh, b, spec),\n"
     "             mesh)\n",
     [(5, "FL109")]),
    ("fl109_module_binding",
     _SHARD + "SPEC = P()\ndef build(f, mesh):\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(SPEC,),\n"
     "                         out_specs=SPEC)\n",
     _PUT + "SPEC = ()\ndef build(f, mesh, a):\n"
     "    return f(global_put(mesh, a, SPEC),\n"
     "             mesh)\n",
     [(5, "FL109")]),
    ("fl109_name_bound_partitioned",
     _SHARD + "def build(f, mesh, axis):\n"
     "    spec = P('seq', axis, None, None)\n"
     "    return jax.shard_map(f, mesh=mesh,\n"
     "                         in_specs=(spec, spec, spec),\n"
     "                         out_specs=spec)\n",
     _PUT + "def build(f, mesh, axis, a, b, c):\n"
     "    spec = ('seq', axis, None, None)\n"
     "    return f(global_put(mesh, a, spec),\n"
     "             global_put(mesh, b, spec), global_put(mesh, c, spec),\n"
     "             mesh)\n",
     []),
    ("fl109_two_hops",
     _SHARD + "def build(f, mesh):\n    a = P()\n    spec = a\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(spec,),\n"
     "                         out_specs=a)\n",
     _PUT + "def build(f, mesh, x):\n    a = ()\n    spec = a\n"
     "    return f(global_put(mesh, x, spec),\n"
     "             mesh)\n",
     [(6, "FL109")]),
    ("fl109_two_hops_partitioned",
     _SHARD + "def build(f, mesh):\n    a = P('clients')\n    spec = a\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(spec,),\n"
     "                         out_specs=a)\n",
     _PUT + "def build(f, mesh, x):\n    a = ('clients',)\n    spec = a\n"
     "    return f(global_put(mesh, x, spec),\n"
     "             mesh)\n",
     []),
    ("fl109_three_hops_unjudged",
     _SHARD + "def build(f, mesh):\n    b = P()\n    a = b\n    spec = a\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(spec,),\n"
     "                         out_specs=spec)\n",
     _PUT + "def build(f, mesh, x):\n    b = ()\n    a = b\n    spec = a\n"
     "    return f(global_put(mesh, x, spec),\n"
     "             mesh)\n",
     []),
    ("fl109_rebound_unjudged",
     _SHARD + "def build(f, mesh, flag):\n    spec = P()\n    if flag:\n"
     "        spec = P('clients')\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(spec,),\n"
     "                         out_specs=spec)\n",
     _PUT + "def build(f, mesh, flag, x):\n    spec = ()\n    if flag:\n"
     "        spec = ('clients',)\n"
     "    return f(global_put(mesh, x, spec),\n"
     "             mesh)\n",
     []),
    ("fl109_first_hop_rebound_unjudged",
     _SHARD + "def build(f, mesh, flag):\n    a = P()\n    if flag:\n"
     "        a = P('clients')\n    spec = a\n"
     "    return jax.shard_map(f, mesh=mesh, in_specs=(spec,),\n"
     "                         out_specs=spec)\n",
     _PUT + "def build(f, mesh, flag, x):\n    a = ()\n    if flag:\n"
     "        a = ('clients',)\n    spec = a\n"
     "    return f(global_put(mesh, x, spec),\n"
     "             mesh)\n",
     []),
    # -- TestShardingScanRules: FL112 ------------------------------------
    ("fl112_large_captured_constant",
     "import jax\nimport jax.numpy as jnp\ntable = jnp.zeros((512, 512))\n"
     "@jax.jit\ndef f(x):\n    return x + table\n",
     "import torch\nimport numpy as np\ntable = torch.zeros(512, 512)\n"
     "@torch.jit.script\ndef f(x):\n    return x + table\n",
     [(5, "FL112")]),
    ("fl112_negative_small_or_passed",
     "import jax\nimport jax.numpy as jnp\nsmall = jnp.zeros((8,))\n"
     "@jax.jit\ndef f(x, table):\n    return x + table + small\n",
     "import torch\nimport numpy as np\nsmall = torch.zeros(8)\n"
     "@torch.jit.script\ndef f(x, table):\n    return x + table + small\n",
     []),
    # -- TestFl113Captures -----------------------------------------------
    ("fl113_asarray_capture",
     "import jax\nimport jax.numpy as jnp\n"
     "table = jnp.asarray(make_table())\n@jax.jit\ndef f(x):\n"
     "    return x + table\n",
     "import torch\nimport numpy as np\n"
     "table = torch.as_tensor(make_table())\n@torch.compile\ndef f(x):\n"
     "    return x + table\n",
     [(5, "FL113")]),
    ("fl113_load_capture",
     "import jax\nimport numpy as np\nweights = np.load('weights.npy')\n"
     "@jax.jit\ndef f(x):\n    return x + weights\n",
     "import torch\nimport numpy as np\nweights = torch.load('weights.pt')\n"
     "@torch.compile\ndef f(x):\n    return x + weights\n",
     [(5, "FL113")]),
    ("fl113_negative_literal_table_and_argument",
     "import jax\nimport jax.numpy as jnp\n"
     "lut = jnp.asarray([1.0, 2.0, 3.0])\n@jax.jit\ndef f(x, table):\n"
     "    return x + lut + table\n",
     "import torch\nimport numpy as np\n"
     "lut = torch.tensor([1.0, 2.0, 3.0])\n@torch.compile\n"
     "def f(x, table):\n    return x + lut + table\n",
     []),
    ("fl113_negative_scalar_constant",
     "import jax\nimport jax.numpy as jnp\neps = jnp.asarray(1e-6)\n"
     "@jax.jit\ndef f(x):\n    return x + eps\n",
     "import torch\nimport numpy as np\neps = torch.tensor(1e-6)\n"
     "@torch.compile\ndef f(x):\n    return x + eps\n",
     []),
    ("fl112_still_wins_on_static_size",
     "import jax\nimport jax.numpy as jnp\ntable = jnp.zeros((512, 512))\n"
     "@jax.jit\ndef f(x):\n    return x + table\n",
     "import torch\nimport numpy as np\n"
     "table = torch.zeros((512, 512))\n@torch.compile\ndef f(x):\n"
     "    return x + table\n",
     [(5, "FL112")]),
    # -- TestFl114WallclockTiming ----------------------------------------
    ("fl114_unsynced_delta",
     _JAX_STEP + "def measure(x):\n    t0 = time.time()\n    y = step(x)\n"
     "    dt = time.time() - t0\n    return y, dt\n",
     _TORCH_STEP + "def measure(x):\n    t0 = time.time()\n"
     "    y = step(x)\n    dt = time.time() - t0\n    return y, dt\n",
     [(9, "FL114")]),
    ("fl114_wrap_form_and_perf_counter",
     "from time import perf_counter\nimport jax\n"
     "f = jax.jit(lambda x: x + 1)\ndef measure(x):\n"
     "    t0 = perf_counter()\n    y = f(x)\n"
     "    return perf_counter() - t0\n",
     "from time import perf_counter\nimport torch\n"
     "f = torch.compile(lambda x: x + 1)\ndef measure(x):\n"
     "    t0 = perf_counter()\n    y = f(x)\n"
     "    return perf_counter() - t0\n",
     [(7, "FL114")]),
    ("fl114_negative_synchronize",
     _JAX_STEP + "def measure(x):\n    t0 = time.time()\n"
     "    y = jax.block_until_ready(step(x))\n"
     "    return time.time() - t0\n",
     _TORCH_STEP + "def measure(x):\n    t0 = time.time()\n"
     "    y = step(x)\n    torch.cuda.synchronize()\n"
     "    return time.time() - t0\n",
     []),
    ("fl114_negative_end_of_round_sync",
     _JAX_STEP + "from fedml_tpu.utils.profiling import end_of_round_sync\n"
     "def measure(x):\n    t0 = time.time()\n    y = step(x)\n"
     "    end_of_round_sync(y)\n    return time.time() - t0\n",
     _TORCH_STEP
     + "from fedml_tpu_torch.utils.profiling import end_of_round_sync\n"
     "def measure(x):\n    t0 = time.time()\n    y = step(x)\n"
     "    end_of_round_sync(y)\n    return time.time() - t0\n",
     []),
    ("fl114_negative_value_fetch",
     _JAX_STEP + "def measure(x):\n    t0 = time.perf_counter()\n"
     "    loss = float(step(x))\n    return time.perf_counter() - t0\n",
     _TORCH_STEP + "def measure(x):\n    t0 = time.perf_counter()\n"
     "    loss = float(step(x))\n    return time.perf_counter() - t0\n",
     []),
    ("fl114_negative_no_async_call",
     _JAX_STEP + "def measure(x):\n    t0 = time.time()\n"
     "    y = host_work(x)\n    return time.time() - t0\n",
     _TORCH_STEP + "def measure(x):\n    t0 = time.time()\n"
     "    y = host_work(x)\n    return time.time() - t0\n",
     []),
    ("fl114_inner_reassignment_once",
     _JAX_STEP + "def measure(x):\n    t0 = time.time()\n"
     "    for _ in range(3):\n        t0 = time.perf_counter()\n"
     "        y = step(x)\n        dt_in = time.perf_counter() - t0\n",
     _TORCH_STEP + "def measure(x):\n    t0 = time.time()\n"
     "    for _ in range(3):\n        t0 = time.perf_counter()\n"
     "        y = step(x)\n        dt_in = time.perf_counter() - t0\n",
     [(11, "FL114")]),
]


def _case(entry):
    name, ref_src, port_src, expected = entry[:4]
    ref_path, port_path = entry[4:] or (REF_LIB, PORT_LIB)
    return pytest.param(ref_src, port_src or ref_src, expected, ref_path,
                        port_path, id=name)


@pytest.mark.parametrize("ref_src,port_src,expected,ref_path,port_path",
                         [_case(c) for c in CASES])
def test_same_codes_on_the_same_lines(ref_src, port_src, expected,
                                      ref_path, port_path):
    ref = [(f.line, f.code)
           for f in ref_lint_source(ref_src, path=ref_path)]
    port = [(f.line, f.code) for f in lint_source(port_src, path=port_path)]
    assert ref == expected
    assert port == ref


def test_fl107_swallow_message_in_both():
    src = ("def recv(sock):\n    try:\n        return sock.recv(4)\n"
           "    except Exception:\n        pass\n")
    for lint, path in ((ref_lint_source, REF_COMM),
                       (lint_source, PORT_COMM)):
        assert "swallows" in lint(src, path=path)[0].message
