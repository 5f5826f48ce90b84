"""The torch meanings of the project-wide passes held against the
reference's rules on the same inputs.

Three rules of these passes read framework calls: FL133 (cohort, fault
and trace paths), FL150 (raw update material reaching telemetry) and
FL151 (the DP leg's noise stream). Each case's reference snippet goes
through ``fedml_tpu.analysis.lint_source``, its torch translation
through ``fedml_tpu_torch.analysis.lint_source``, and both must report
the same codes on the same lines.

The translations: numpy's and ``random``'s global draws are torch's
draws with no ``generator=`` (``np.random.choice`` is
``torch.randperm``, ``np.random.standard_normal(x.shape)`` is
``torch.randn_like(x)``, ...), ``np.random.seed(s)`` is
``torch.manual_seed(s)`` (or ``torch.cuda.manual_seed[_all](s)``), a
seeded ``Generator``'s ``rng.choice(...)`` is ``torch.randperm(...,
generator=g)``, and ``jax.random.PRNGKey(0)`` is
``torch.Generator().manual_seed(0)``; a payload read on the server is
logged through torch's copies, moves, views and conversions where the
reference logs it as it is or through ``np.asarray``; a
``default_rng(<key>)`` noise stream is a ``torch.Generator`` bound by
``.manual_seed(<key>)`` and drawn from through ``generator=``."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

from fedml_tpu.analysis import lint_source as ref_lint_source
from fedml_tpu_torch.analysis import lint_source

REF_COHORT = "fedml_tpu/program/fake_cohort.py"
PORT_COHORT = "fedml_tpu_torch/program/fake_cohort.py"
REF_LIB = "fedml_tpu/core/fake.py"
PORT_LIB = "fedml_tpu_torch/core/fake.py"
REF_PRIV = "fedml_tpu/program/privacy_fake.py"
PORT_PRIV = "fedml_tpu_torch/program/privacy_fake.py"

_NP = "import numpy as np\n"
_TORCH = "import torch\n"


def _draw(body):
    return "def draw(x, n, s, g):\n" + body


#: (id, reference source, torch source, expected [(line, code)],
#:  reference path, port path)
CASES = [
    # -- FL133: torch's global stream ------------------------------------
    ("fl133_global_randperm",
     _NP + _draw("    return np.random.choice(n, 3)\n"),
     _TORCH + _draw("    return torch.randperm(n)[:3]\n"),
     [(3, "FL133")]),
    ("fl133_global_randn",
     _NP + _draw("    return np.random.standard_normal(x.shape)\n"),
     _TORCH + _draw("    return torch.randn(x.shape)\n"),
     [(3, "FL133")]),
    ("fl133_global_randn_like",
     _NP + _draw("    return np.random.standard_normal(x.shape)\n"),
     _TORCH + _draw("    return torch.randn_like(x)\n"),
     [(3, "FL133")]),
    ("fl133_global_rand",
     _NP + _draw("    return np.random.random(n)\n"),
     _TORCH + _draw("    return torch.rand(n)\n"),
     [(3, "FL133")]),
    ("fl133_global_rand_like",
     _NP + _draw("    return np.random.uniform(size=x.shape)\n"),
     _TORCH + _draw("    return torch.rand_like(x)\n"),
     [(3, "FL133")]),
    ("fl133_global_randint",
     _NP + _draw("    return np.random.randint(0, n, 3)\n"),
     _TORCH + _draw("    return torch.randint(0, n, (3,))\n"),
     [(3, "FL133")]),
    ("fl133_global_randint_like",
     _NP + _draw("    return np.random.randint(0, n, x.shape)\n"),
     _TORCH + _draw("    return torch.randint_like(x, 0, n)\n"),
     [(3, "FL133")]),
    ("fl133_global_normal",
     _NP + _draw("    return np.random.normal(0.0, 1.0, n)\n"),
     _TORCH + _draw("    return torch.normal(0.0, 1.0, (n,))\n"),
     [(3, "FL133")]),
    ("fl133_global_bernoulli",
     _NP + _draw("    return np.random.binomial(1, x)\n"),
     _TORCH + _draw("    return torch.bernoulli(x)\n"),
     [(3, "FL133")]),
    ("fl133_global_multinomial",
     _NP + _draw("    return np.random.choice(n, 3, p=x)\n"),
     _TORCH + _draw("    return torch.multinomial(x, 3)\n"),
     [(3, "FL133")]),
    ("fl133_aliased_torch_module",
     _NP + _draw("    return np.random.choice(n, 3)\n"),
     "import torch as th\n" + _draw("    return th.randperm(n)[:3]\n"),
     [(3, "FL133")]),
    ("fl133_generator_draw_clean",
     _NP + _draw("    return g.choice(n, 3)\n"),
     _TORCH + _draw("    return torch.randperm(n, generator=g)[:3]\n"),
     []),
    ("fl133_derived_reseed_idiom_clean",
     _NP + _draw("    np.random.seed(attempt_seed(s))\n"
                 "    return np.random.choice(n, 3)\n"),
     _TORCH + _draw("    torch.manual_seed(attempt_seed(s))\n"
                    "    return torch.randperm(n)[:3]\n"),
     []),
    ("fl133_draw_before_the_reseed",
     _NP + _draw("    first = np.random.choice(n, 3)\n"
                 "    np.random.seed(attempt_seed(s))\n"
                 "    return first\n"),
     _TORCH + _draw("    first = torch.randperm(n)[:3]\n"
                    "    torch.manual_seed(attempt_seed(s))\n"
                    "    return first\n"),
     [(3, "FL133")]),
    ("fl133_outside_the_cohort_paths",
     _NP + _draw("    return np.random.choice(n, 3)\n"),
     _TORCH + _draw("    return torch.randperm(n)[:3]\n"),
     [], REF_LIB, PORT_LIB),
    # -- FL133: constant seeding ------------------------------------------
    ("fl133_constant_manual_seed",
     _NP + _draw("    np.random.seed(42)\n"
                 "    return np.random.choice(n, 3)\n"),
     _TORCH + _draw("    torch.manual_seed(42)\n"
                    "    return torch.randperm(n)[:3]\n"),
     [(3, "FL133")]),
    ("fl133_constant_cuda_manual_seed",
     _NP + _draw("    np.random.seed(42)\n"),
     _TORCH + _draw("    torch.cuda.manual_seed(42)\n"),
     [(3, "FL133")]),
    ("fl133_constant_cuda_manual_seed_all",
     _NP + _draw("    np.random.seed(-1)\n"),
     _TORCH + _draw("    torch.cuda.manual_seed_all(-1)\n"),
     [(3, "FL133")]),
    ("fl133_constant_generator_in_place_of_prngkey",
     "import jax\n" + _draw("    return jax.random.PRNGKey(0)\n"),
     _TORCH + _draw("    return torch.Generator().manual_seed(0)\n"),
     [(3, "FL133")]),
    ("fl133_constant_seed_on_a_bound_generator",
     _NP + _draw("    return np.random.default_rng(7)\n"),
     _TORCH + _draw("    return g.manual_seed(7)\n"),
     [(3, "FL133")]),
    ("fl133_derived_generator_seed_clean",
     _NP + _draw("    return np.random.default_rng(attempt_seed(s))\n"),
     _TORCH + _draw("    return torch.Generator().manual_seed("
                    "attempt_seed(s))\n"),
     []),
]

#: the server FSM every FL150 case logs from; line 4 holds the import
#: that differs (numpy against torch), line 10 the log call
_FSM = ("import logging\n"
        "from fedml_tpu{pkg}.core.managers import ServerManager\n"
        "from fedml_tpu{pkg}.core.message import Message\n"
        "{imp}"
        "class Srv(ServerManager):\n"
        "    def register_message_receive_handlers(self):\n"
        "        pass\n"
        "    def _on_report(self, msg):\n"
        "        payload = msg.get('params')\n"
        "        logging.info('report %r', {logged})\n")


def _fsm(pkg, imp, logged):
    return _FSM.format(pkg=pkg, imp=imp, logged=logged)


#: (id, reference expression, torch expression, leaks)
FL150_CASES = [
    ("detach_cpu", "payload", "payload.detach().cpu()", True),
    ("detach", "payload", "payload.detach()", True),
    ("cpu", "np.asarray(payload)", "payload.cpu()", True),
    ("clone", "dict(payload)", "payload.clone()", True),
    ("numpy", "np.asarray(payload)", "payload.detach().numpy()", True),
    ("tolist", "list(payload)", "payload.tolist()", True),
    ("to", "payload", "payload.to('cpu')", True),
    ("float", "payload.astype(np.float32)", "payload.float()", True),
    ("contiguous", "payload", "payload.contiguous()", True),
    ("view", "payload.reshape(-1)", "payload.view(-1)", True),
    ("as_tensor", "np.asarray(payload)", "torch.as_tensor(payload)", True),
    ("tensor", "np.array(payload)", "torch.tensor(payload)", True),
    ("from_numpy", "np.asarray(payload)", "torch.from_numpy(payload)",
     True),
    ("cat", "np.stack([payload])", "torch.cat([payload])", True),
    ("sanitized_scalar_clean", "float(np.linalg.norm(payload))",
     "payload.norm().item()", False),
    ("shape_metadata_clean", "len(payload)", "payload.numel()", False),
]

#: (id, reference body, torch body, expected) in a ``*privacy*`` module
#: under ``program/``: FL133 reads the binding, FL151 the draw
FL151_CASES = [
    ("constant_generator",
     "    rng = np.random.default_rng(0)\n"
     "    return x + rng.standard_normal(x.shape)\n",
     "    rng = torch.Generator().manual_seed(0)\n"
     "    return x + torch.randn(x.shape, generator=rng)\n",
     [(3, "FL133"), (4, "FL151")]),
    ("constant_generator_normal",
     "    rng = np.random.default_rng(3)\n"
     "    return x + rng.normal(0.0, sigma, x.shape)\n",
     "    rng = torch.Generator().manual_seed(3)\n"
     "    return x + torch.normal(0.0, sigma, x.shape, generator=rng)\n",
     [(3, "FL133"), (4, "FL151")]),
    ("derived_generator_seed_clean",
     "    rng = np.random.default_rng((rank, round_idx))\n"
     "    return x + rng.standard_normal(x.shape)\n",
     "    rng = torch.Generator().manual_seed(rank * 7919 + round_idx)\n"
     "    return x + torch.randn(x.shape, generator=rng)\n",
     []),
    ("derived_rng_family_clean",
     "    rng = noise_rng(rank, round_idx)\n"
     "    return x + rng.standard_normal(x.shape)\n",
     "    rng = noise_rng(rank, round_idx)\n"
     "    return x + torch.randn(x.shape, generator=rng)\n",
     []),
]


def _case(entry):
    name, ref_src, port_src, expected = entry[:4]
    ref_path, port_path = entry[4:] or (REF_COHORT, PORT_COHORT)
    return pytest.param(ref_src, port_src, expected, ref_path, port_path,
                        id=name)


def _fl150_case(entry):
    name, ref_expr, port_expr, leaks = entry
    return pytest.param(
        _fsm("", _NP, ref_expr), _fsm("_torch", _TORCH, port_expr),
        [(10, "FL150")] if leaks else [], REF_LIB, PORT_LIB,
        id="fl150_" + name)


def _fl151_case(entry):
    name, ref_body, port_body, expected = entry
    head = "def noise(x, rank, round_idx, sigma):\n"
    return pytest.param(_NP + head + ref_body, _TORCH + head + port_body,
                        expected, REF_PRIV, PORT_PRIV, id="fl151_" + name)


@pytest.mark.parametrize(
    "ref_src,port_src,expected,ref_path,port_path",
    [_case(c) for c in CASES] + [_fl150_case(c) for c in FL150_CASES]
    + [_fl151_case(c) for c in FL151_CASES])
def test_same_codes_on_the_same_lines(ref_src, port_src, expected,
                                      ref_path, port_path):
    ref = [(f.line, f.code)
           for f in ref_lint_source(ref_src, path=ref_path)]
    port = [(f.line, f.code) for f in lint_source(port_src, path=port_path)]
    assert ref == expected
    assert port == ref


def test_every_torch_draw_and_seed_has_a_case():
    from fedml_tpu_torch.analysis.determinism import (_TORCH_DRAW_ATTRS,
                                                      _TORCH_SEED_ATTRS)
    torch_srcs = " ".join(c[2] for c in CASES)
    for attr in _TORCH_DRAW_ATTRS | _TORCH_SEED_ATTRS:
        assert f".{attr}(" in torch_srcs, attr


def test_every_torch_preserve_has_a_case():
    port_exprs = " ".join(c[2] for c in FL150_CASES)
    for name in ("detach", "cpu", "clone", "numpy", "tolist", "to",
                 "float", "contiguous", "view", "as_tensor", "tensor",
                 "from_numpy", "cat"):
        assert f".{name}(" in port_exprs, name
