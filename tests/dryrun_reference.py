"""The reference's dry-run cases 1-9 (``__graft_entry__.py:72``
``dryrun_multichip``; the port's 1-10, its seventh case split in two)
in this process, on conftest's forced CPU devices, and the checks the
port's dry-run tests (``test_torch_dryrun*.py``) hold over a spawned
group.

The ResNet cases run at depth 8 (the same ``CifarResNet`` code path as
the dry run's ResNet-20, whose sharded-round compiles take about 8 s a
case here, against about 4 s) in float64 under ``jax.enable_x64``, with
float64 weights drawn by ``seeded_variables``: the port's dry run
computes in float64 (``fedml_tpu_torch/parallel/dryrun.py`` says why),
and an fp32 reference would stray from it by BatchNorm's amplification
of its own rounding. The LM cases run in fp32, as in the reference:
dp x sp, and tp, pp and ep (``tests/parallel_reference.py``) at the
reference's sizes from flax's weights drawn from keys 5, 7 and 9."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import parallel_reference as preference
import torch_dist_cases as cases
from fedml_tpu_torch.utils.torch_import import (lm_variables_to_state,
                                                variables_to_state)
from seeded_variables import seeded_variables

DEPTH = 8
#: the port's dry-run states against the reference's: the fp32
#: aggregation's reassociation on either side, and the LM's fp32 step
TOL = {"resnet": 1e-5, "seqpar": 1e-4}
#: the LM cases, held to the reference's LM bound
LM_CASES = ("seqpar", "tp", "pp", "ep")


def _cohort(n_clients, seed):
    from fedml_tpu.parallel.packing import pack_cohort

    rng = np.random.default_rng(seed)
    clients = [{"x": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                "y": rng.integers(0, 10, 8).astype(np.int64)}
               for _ in range(n_clients)]
    return pack_cohort(clients, batch_size=4, epochs=1, step_bucket=2)


def resnet_variables():
    """Float64-valued ResNet-8 variables (numpy) from seed 0."""
    from fedml_tpu import models

    model = models.CifarResNet(depth=DEPTH, num_classes=10)
    return seeded_variables(model, np.zeros((1, 16, 16, 3), np.float32),
                            seed=0)


def lm_case(n):
    """The seqpar case's grid, weights (fp32, flax's initialisers from
    key 3) and tokens (from numpy seed 2)."""
    from fedml_tpu.models.transformer import TransformerLM

    n_seq = 4 if n % 4 == 0 else n
    n_data = n // n_seq
    B, T = 2 * n_data, 8 * n_seq
    kw = dict(vocab_size=50, n_layers=1, n_heads=2, d_model=32, max_len=T)
    params = TransformerLM(**kw).init(jax.random.PRNGKey(3),
                                      jnp.zeros((1, T), jnp.int32))["params"]
    idx = np.random.default_rng(2).integers(0, 50, (B, T))
    return n_data, n_seq, kw, jax.tree.map(np.asarray, params), idx


def parallel_cases(n):
    """The tp, pp and ep cases' meshes, models, weights (flax's, numpy)
    and tokens at the reference's sizes: ``{case: (grid, kw, params,
    idx)}``."""
    n_tp = 4 if n % 4 == 0 else n
    tp_kw = dict(vocab_size=50, n_layers=1, n_heads=n_tp, d_model=8 * n_tp,
                 max_len=32)
    pp_kw = dict(vocab_size=50, n_heads=2, d_model=32, max_len=32)
    ep_kw = dict(vocab_size=50, n_layers=1, n_heads=2, d_model=16,
                 max_len=32, n_experts=n_tp)
    return {
        "tp": ((n // n_tp, n_tp), tp_kw, preference.lm_params(tp_kw, 5, 32),
               np.random.default_rng(4).integers(0, 50,
                                                 (2 * (n // n_tp), 32))),
        "pp": ((n,), pp_kw, preference.lm_params(
            dict(pp_kw, n_layers=2 * n), 7, 32),
            np.random.default_rng(6).integers(0, 50, (4, 16))),
        "ep": ((n // n_tp, n_tp), ep_kw,
               preference.lm_params(ep_kw, 9, 32, moe=True),
               np.random.default_rng(8).integers(0, 50,
                                                 (2 * (n // n_tp), 16)))}


def parallel_reference_cases(n):
    """The reference's tp, pp and ep steps of :func:`parallel_cases`:
    ``{case: (new params, loss)}``."""
    cases_ = parallel_cases(n)
    (d, m), kw, params, idx = cases_["tp"]
    out = {"tp": preference.tp_step(params, idx, d, m, kw, 32)}
    _, kw, params, idx = cases_["pp"]
    out["pp"] = preference.pp_step(params, idx, n, kw, 2, 16)
    (d, m), kw, params, idx = cases_["ep"]
    out["ep"] = preference.ep_step(params, idx, d, m, kw, 16)
    return out


def reference_cases(n, variables):
    """The reference's sharded rounds of cases 1-6 on an ``n``-device
    mesh from ``variables`` (float64), and its sp step of case 7:
    ``{case: new state (numpy tree)}``."""
    from fedml_tpu import models
    from fedml_tpu.algorithms.fedavg_robust import make_robust_hooks
    from fedml_tpu.algorithms.fedopt import (get_server_optimizer,
                                             make_fedopt_hooks)
    from fedml_tpu.algorithms.specs import make_classification_spec
    from fedml_tpu.models.transformer import TransformerLM
    from fedml_tpu.parallel.engine import (ClientUpdateConfig,
                                           ShardedLaneRunner,
                                           make_sharded_round)
    from fedml_tpu.parallel.mesh import make_client_mesh, shard_cohort
    from fedml_tpu.parallel.multihost import global_cohort
    from fedml_tpu.parallel.packing import pack_schedule, stack_clients
    from fedml_tpu.parallel.seq_parallel import (
        make_seq_mesh, make_seq_parallel_lm_step, place_lm_batch,
        seq_parallel_model, shift_targets)

    out = {}
    devices = jax.devices()[:n]
    with jax.enable_x64(True):
        model = models.CifarResNet(depth=DEPTH, num_classes=10,
                                   dtype=jnp.float64)
        spec = make_classification_spec(model,
                                        jnp.zeros((1, 16, 16, 3),
                                                  jnp.float64))
        state = {k: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
                 for k, v in variables.items()}
        fresh = lambda t: jax.tree.map(jnp.copy, t)  # noqa: E731
        cfg = ClientUpdateConfig(optimizer="sgd", lr=0.1)
        rng = jax.random.PRNGKey(1)
        mesh = make_client_mesh(n, devices=devices)
        server_tx = get_server_optimizer("sgd", lr=0.5)
        cases = [("fedavg", 2 * n, (None, None), ()),
                 ("fedavg-uneven", 2 * n - 3, (None, None), ()),
                 ("fedopt", n, make_fedopt_hooks(server_tx),
                  server_tx.init(state["params"])),
                 ("robust", n, make_robust_hooks(5.0, 0.0), ())]
        for i, (name, clients, (pay, srv), sstate) in enumerate(cases):
            fn = make_sharded_round(spec, cfg, mesh, pay, srv)
            new, _, _ = fn(fresh(state), fresh(sstate),
                           shard_cohort(mesh, _cohort(clients, i)), rng)
            out[name] = jax.tree.map(np.asarray, new)
        r = np.random.default_rng(99)
        sl = [{"x": r.normal(size=(m, 16, 16, 3)).astype(np.float32),
               "y": r.integers(0, 10, m).astype(np.int64)}
              for m in ([8, 12, 6, 10] * ((2 * n + 3) // 4 + 1))[
                  :2 * n - 3]]
        r = np.random.default_rng(101)
        pl = [{"x": r.normal(size=(4, 16, 16, 3)).astype(np.float32),
               "y": r.integers(0, 10, 4).astype(np.int64)}
              for _ in range(2 * n - 3)]
        for name, clients, packed in (("sharded-lanes", sl, False),
                                      ("sharded-mxu-lanes", pl, True)):
            st = stack_clients(clients)
            sched = pack_schedule([len(c["y"]) for c in clients], 4, 1,
                                  rng=np.random.default_rng(7))
            new, _, _ = ShardedLaneRunner(
                spec, cfg, mesh, n_lanes=2, packed=packed).run_round(
                fresh(state), (),
                global_cohort(mesh, {"x": st["x"], "y": st["y"]}),
                list(range(len(clients))), sched, rng)
            out[name] = jax.tree.map(np.asarray, new)
    n_data, n_seq, kw, params, idx = lm_case(n)
    sp_mesh = make_seq_mesh(n_data, n_seq, devices=devices)
    sp_model = seq_parallel_model(TransformerLM, sp_mesh, block_size=8,
                                  **kw)
    tx = optax.sgd(0.1)
    _, step_fn = make_seq_parallel_lm_step(sp_model, sp_mesh, tx)
    p = jax.tree.map(jnp.asarray, params)
    new, _, loss = step_fn(p, tx.init(p), *place_lm_batch(
        sp_mesh, jnp.asarray(idx), shift_targets(jnp.asarray(idx))))
    out["seqpar"] = {"params": jax.tree.map(np.asarray, new)}
    out["seqpar_loss"] = float(loss)
    return out


def port_state(flat, lm=False):
    """A dry-run report's flat ``{"part/name": numpy}`` state as the
    reference's variables (numpy)."""
    from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                    state_to_variables)

    if lm:
        return lm_state_to_variables({"params": {
            k: torch.as_tensor(v) for k, v in flat.items()}})
    tree = {}
    for key, v in flat.items():
        part, name = key.split("/", 1)
        tree.setdefault(part, {})[name] = torch.as_tensor(v)
    return state_to_variables(tree, DEPTH)


def assert_matches(report, ref):
    """Every case of the port's report within :data:`TOL` of the
    reference's."""
    for case, state in report["states"].items():
        lm = case in LM_CASES
        got = dict(jax.tree_util.tree_leaves_with_path(
            port_state(state, lm)))
        want = jax.tree_util.tree_leaves_with_path(ref[case])
        assert len(got) == len(want), case
        tol = TOL["seqpar" if lm else "resnet"]
        for path, leaf in want:
            np.testing.assert_allclose(got[path], leaf, atol=tol,
                                       err_msg=f"{case} {path}")
    assert abs(report["losses"]["seqpar"] - ref["seqpar_loss"]) < TOL[
        "seqpar"]
    for case in ("tp", "pp", "ep"):
        np.testing.assert_allclose(report["losses"][case],
                                   ref[f"{case}_loss"], rtol=1e-5,
                                   err_msg=case)


def check_reference_sizes(group):
    """The port's dry run at the reference's sizes over ``group``: its
    ten cases within their bounds, the LM cases' grids, and the same
    states on every rank."""
    outs = group.run(cases.dryrun)
    rep = outs[0]
    assert rep["n"] == group.n and len(rep["errors"]) == 10
    assert max(v for k, v in rep["errors"].items()
               if k not in LM_CASES) < 1e-5
    assert max(rep["errors"][k] for k in LM_CASES) < 1e-4
    n4 = 4 if group.n % 4 == 0 else group.n
    assert {k: tuple(v) for k, v in rep["meshes"].items()} == {
        "seqpar": (group.n // n4, n4), "tp": (group.n // n4, n4),
        "pp": (group.n,), "ep": (group.n // n4, n4)}
    for other in outs[1:]:
        for case, state in rep["states"].items():
            for k, v in state.items():
                np.testing.assert_array_equal(other["states"][case][k], v)


def check_reference_values(group, monkeypatch):
    """The port's dry run at :data:`DEPTH` from the reference's weights
    over ``group``, against :func:`reference_cases` on a mesh of the
    same size."""
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    variables = resnet_variables()
    state = variables_to_state(variables, DEPTH)
    _, _, _, lm_params, idx = lm_case(group.n)
    lm = lm_variables_to_state({"params": lm_params})["params"]
    parallel = {case: (preference.port_params(params), tokens)
                for case, (_, _, params, tokens)
                in parallel_cases(group.n).items()}
    rep = group.run(
        cases.dryrun, DEPTH,
        {part: {k: v.numpy() for k, v in leaves.items()}
         for part, leaves in state.items()},
        {k: v.numpy() for k, v in lm.items()}, idx, parallel)[0]
    ref = reference_cases(group.n, variables)
    for case, (new, loss) in parallel_reference_cases(group.n).items():
        ref[case], ref[f"{case}_loss"] = {"params": new}, loss
    assert_matches(rep, ref)
