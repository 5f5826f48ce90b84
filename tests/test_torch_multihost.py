"""The port's multi-rank control plane (``parallel/multihost.py``,
``utils/logging_utils.py``) against the reference's.

- One process: ``maybe_initialize_distributed`` is ``(0, 1)``,
  ``is_primary``, ``sync`` a no-op, ``global_cohort`` on a one-rank mesh
  places the whole cohort and ``gather_metrics`` reads numpy (the
  reference's ``test_multihost.py:184`` case), and ``init_logging``
  formats as the reference's does.
- A dead coordinator fails fast, in a fresh process: the connect error
  is raised after the timeout, not swallowed.
- Two processes launched by environment (the reference's
  ``FEDML_TPU_*`` variables, and torchrun's) form one group and run the
  reference's two-process case (``test_multihost.py:52``): the sharded
  LR round is the same on both ranks and equals this process's
  single-device round, every sample trained once, and one seq-parallel
  LM step, one tensor-parallel step (8 heads over the two ranks) and one
  two-stage pipeline step (the reference's ``test_multihost.py:137-185``
  legs) over both ranks each match the unsharded step.
- In a spawned gloo group of 2 and of 4 ranks: re-initialisation is
  tolerated, each rank places its padded block of a host-replicated
  cohort (int64 labels), ``gather_metrics`` gathers the blocks back,
  ``global_put`` splits a grid over a ``(data, seq)`` mesh, the fused
  ``all_reduce_sum`` sums, rank 0 alone is primary, and every log line
  starts with the rank."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_reference
import torch_dist
import torch_dist_cases as cases
from fedml_tpu import models
from fedml_tpu.algorithms.specs import make_classification_spec as jax_spec
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.utils.logging_utils import init_logging as jax_init_logging
from fedml_tpu_torch.models.transformer import TransformerLM, lm_loss
from fedml_tpu_torch.parallel import multihost
from fedml_tpu_torch.parallel.seq_parallel import shift_targets
from fedml_tpu_torch.utils.logging_utils import init_logging
from fedml_tpu_torch.utils.torch_import import lm_variables_to_state

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")


@pytest.fixture(scope="module", params=[2, 4])
def group(request):
    g = torch_dist.RankGroup(request.param)
    try:
        yield g
    finally:
        g.close()


def test_multihost_helpers_single_process():
    """Single-process semantics: initialise is a no-op, global_cohort
    places on the device, gather_metrics is numpy conversion."""
    from fedml_tpu_torch.parallel.mesh import make_client_mesh

    idx, count = multihost.maybe_initialize_distributed("cpu")
    assert (idx, count) == (0, 1)
    assert multihost.is_primary()
    multihost.sync("test")  # no-op
    mesh = make_client_mesh(1, device="cpu")
    data = {"x": np.arange(16, dtype=np.float32).reshape(8, 2)}
    placed = multihost.global_cohort(mesh, data)
    np.testing.assert_array_equal(placed.local["x"].numpy(), data["x"])
    got = multihost.gather_metrics({"a": torch.ones(3)})
    assert isinstance(got["a"], np.ndarray)


def test_init_logging_matches_the_reference():
    jax_init_logging(process_id=3)
    want = logging.getLogger().handlers[0].formatter._fmt
    init_logging(process_id=3)
    assert logging.getLogger().handlers[0].formatter._fmt == want
    init_logging()
    assert logging.getLogger().handlers[0].formatter._fmt.startswith("0 - ")


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("FEDML_TPU_", "MASTER_", "WORLD_SIZE",
                                "RANK", "LOCAL_RANK"))}
    env.update({k: str(v) for k, v in kw.items()})
    env["PYTHONPATH"] = os.path.dirname(HERE)
    return env


def test_dead_coordinator_fails_fast():
    """A rank whose coordinator never answers raises after the timeout
    (3 s here) instead of training alone as rank 0."""
    code = ("from fedml_tpu_torch.parallel.multihost import "
            "maybe_initialize_distributed as m; m('cpu', timeout_s=3)")
    port = torch_dist.free_port()
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=_env(FEDML_TPU_COORDINATOR=f"127.0.0.1:{port}",
                              FEDML_TPU_NUM_PROCESSES=2,
                              FEDML_TPU_PROCESS_ID=1))
    assert proc.returncode != 0
    assert "timed out" in proc.stderr.lower(), proc.stderr[-2000:]


def _reference_lr_init():
    spec = jax_spec(models.LogisticRegression(num_classes=10,
                                              apply_sigmoid=False),
                    jnp.zeros((1, 60)))
    return jax.tree.map(np.array, spec.init_fn(jax.random.PRNGKey(7)))


@pytest.mark.parametrize("launcher", ["fedml_tpu", "torchrun"])
def test_two_process_round_matches_single_process(launcher, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    lm = JaxLM(vocab_size=50, n_layers=1, n_heads=2, d_model=32,
               max_len=32).init(jax.random.PRNGKey(12),
                                jnp.zeros((1, 32), jnp.int32))
    lm_params = {k: v.numpy() for k, v in
                 lm_variables_to_state(lm)["params"].items()}
    idx = np.random.default_rng(11).integers(0, 50, (4, 32))
    tp_params = parallel_reference.port_params(
        parallel_reference.lm_params(cases.MULTIHOST_TP, 22, 32))
    pp_params = parallel_reference.port_params(parallel_reference.lm_params(
        dict(cases.MULTIHOST_PP, n_layers=2), 32, 32))
    tp_idx = np.random.default_rng(21).integers(0, 50, (4, 32))
    pp_idx = np.random.default_rng(31).integers(0, 50, (4, 32))
    init = {"lr": _reference_lr_init(), "lm": lm_params, "idx": idx,
            "tp": tp_params, "tp_idx": tp_idx, "pp": pp_params,
            "pp_idx": pp_idx}
    path = tmp_path / "init.npy"
    np.save(path, np.array(init, dtype=object), allow_pickle=True)
    port = torch_dist.free_port()
    procs = []
    for rank in range(2):
        env = (dict(FEDML_TPU_COORDINATOR=f"127.0.0.1:{port}",
                    FEDML_TPU_NUM_PROCESSES=2, FEDML_TPU_PROCESS_ID=rank)
               if launcher == "fedml_tpu" else
               dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=2,
                    RANK=rank, LOCAL_RANK=rank))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=_env(FEDML_TPU_PACKING="python", **env)))
    results = {}
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert line, out[-3000:]
        parts = dict(kv.split("=") for kv in line[0].split()[1:])
        results[int(parts["process"])] = {k: float(v)
                                          for k, v in parts.items()}
    assert set(results) == {0, 1}
    a, b = results[0], results[1]
    assert a == dict(b, process=0.0)
    assert a["world"] == 2 and a["count"] == 112.0
    one = cases.sharded_round_lr(init["lr"], cases.MULTIHOST_SIZES, 3, 0.3,
                                 5)
    ref = sum(float(np.float64(v).sum()) for part in one["sim"].values()
              for v in part.values())
    np.testing.assert_allclose(a["checksum"], ref, rtol=1e-6)
    model = TransformerLM(vocab_size=50, n_layers=1, n_heads=2, d_model=32,
                          max_len=32)
    p = {k: torch.tensor(v, requires_grad=True)
         for k, v in lm_params.items()}
    loss = lm_loss(model.apply_params(p, torch.as_tensor(idx)),
                   torch.as_tensor(shift_targets(idx)))
    grads = torch.autograd.grad(loss, list(p.values()))
    sp_ref = sum(float((v - 0.1 * g).detach().double().sum())
                 for v, g in zip(p.values(), grads))
    np.testing.assert_allclose(a["sp_loss"], float(loss.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(a["sp_checksum"], sp_ref, rtol=1e-5)
    for name, params, kw, lm_idx, block in (
            ("tp", tp_params, cases.MULTIHOST_TP, tp_idx, 16),
            ("pp", pp_params, dict(cases.MULTIHOST_PP, n_layers=2), pp_idx,
             None)):
        want_loss, want_sum = _unsharded_step(params, lm_idx, kw, block)
        np.testing.assert_allclose(a[f"{name}_loss"], want_loss, rtol=1e-5)
        np.testing.assert_allclose(a[f"{name}_checksum"], want_sum,
                                   rtol=1e-5)


def _unsharded_step(params, idx, kw, block):
    """One unsharded SGD step (lr 0.1) of the port's LM: ``(loss, sum of
    the new parameters)``."""
    from fedml_tpu_torch.parallel.tensor_parallel import tp_attention

    model = TransformerLM(attention_fn=tp_attention(block) if block
                          else None, **kw)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    loss = lm_loss(model.apply_params(p, torch.as_tensor(idx)),
                   torch.as_tensor(shift_targets(idx)))
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), sum(
        float((v - 0.1 * g).detach().double().sum())
        for v, g in zip(p.values(), grads))


def test_helpers_over_ranks(group):
    n = group.n
    outs = group.run(cases.multihost_helpers)
    block = -(-7 // n)
    data = np.arange(14, dtype=np.float32).reshape(7, 2)
    padded = np.concatenate([data, np.zeros((block * n - 7, 2),
                                            np.float32)])
    grid = np.arange(24).reshape(4, 6)
    for rank, out in enumerate(outs):
        assert out["init"] == ((rank, n), (rank, n))
        assert out["primary"] == (rank == 0)
        assert out["start"] == rank * block and out["total"] == block * n
        np.testing.assert_array_equal(out["local_x"],
                                      padded[rank * block:(rank + 1) * block])
        assert out["y_dtype"] == "torch.int64"
        np.testing.assert_array_equal(out["gathered"]["x"], padded)
        d, s = out["coord"]
        rows, cols = 4 // 2, 6 // (n // 2)
        np.testing.assert_array_equal(
            out["put"], grid[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols])
        np.testing.assert_array_equal(out["rep"], grid)
        np.testing.assert_array_equal(
            out["rows"], grid[rank * (4 // n):(rank + 1) * (4 // n)])
        np.testing.assert_array_equal(out["sum"],
                                      np.full(3, n * (n + 1) / 2))


def test_log_lines_carry_the_rank(group):
    for rank, line in enumerate(group.run(cases.logging_line)):
        assert line.startswith(f"{rank} - ") and line.endswith("hello")
