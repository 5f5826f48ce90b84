"""Rank-side bodies of the port's multi-rank tests: each runs on every
rank of a :class:`torch_dist.RankGroup` (gloo, the CPU) and returns
numpy. This module imports no JAX, so the ranks load torch and the port
only; the test modules compute the reference's side in the test process
and compare."""

import numpy as np
import torch

#: the reference's two-process case's LR shard sizes
#: (``tests/test_multihost.py:36``)
MULTIHOST_SIZES = (16, 8, 24, 12, 16, 8, 8, 20)
#: its tp and pp legs' LMs (``tests/test_multihost.py:137``, ``:161``):
#: the tp model's 8 heads split over every rank, the pp model a block a
#: rank (``n_layers`` from the weights)
MULTIHOST_TP = dict(vocab_size=50, n_layers=1, n_heads=8, d_model=32,
                    max_len=32)
MULTIHOST_PP = dict(vocab_size=50, n_heads=2, d_model=32, max_len=32)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_np(v) for v in tree)
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _lr_spec():
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.models.linear import LogisticRegression

    return make_classification_spec(LogisticRegression(60, 10,
                                                       apply_sigmoid=False))


def _lr_state(init):
    from fedml_tpu_torch.utils.torch_import import cv_variables_to_state

    state = cv_variables_to_state(init)
    del state["batch_stats"]
    return state


def lr_clients(sizes, seed):
    """The reference engine tests' LR shards: ``x [n, 60]`` normal, 10
    classes, from ``default_rng(seed)``."""
    rnd = np.random.default_rng(seed)
    return [{"x": rnd.normal(size=(n, 60)).astype(np.float32),
             "y": rnd.integers(0, 10, n).astype(np.int64)} for n in sizes]


def _mesh():
    from fedml_tpu_torch.parallel.mesh import make_client_mesh

    return make_client_mesh(device="cpu")


def sharded_round_lr(init, sizes, seed, lr, round_seed):
    """``make_sharded_round`` on LR over the group's ``clients`` mesh and
    the port's single-device ``make_sim_round`` on the same cohort:
    ``{"sharded", "sim", "count", "blocks"}``."""
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 make_sharded_round,
                                                 make_sim_round)
    from fedml_tpu_torch.parallel.multihost import gather_metrics
    from fedml_tpu_torch.parallel.packing import pack_cohort

    spec, cfg = _lr_spec(), ClientUpdateConfig(lr=lr)
    packed = pack_cohort(lr_clients(sizes, seed), batch_size=8, epochs=1)
    mesh = _mesh()
    got, _, info = make_sharded_round(spec, cfg, mesh)(
        _lr_state(init), (), packed, round_seed)
    dev = {k: torch.as_tensor(v) for k, v in packed.items()}
    dev["y"] = dev["y"].long()
    want, _, _ = make_sim_round(spec, cfg)(_lr_state(init), (), dev,
                                           round_seed)
    return {"sharded": _np(got), "sim": _np(want),
            "count": float(gather_metrics(info["metrics"])["count"].sum()),
            "blocks": int(info["metrics"].local["count"].shape[0])}


def _delta_hooks():
    """The reference test's FedOpt-style hooks: the payload is
    ``global - local``, the server steps half of the mean delta."""
    def payload_fn(local_state, global_state, aux):
        return {k: global_state["params"][k] - v
                for k, v in local_state["params"].items()}

    def server_fn(global_state, avg_delta, server_state, rng):
        new = dict(global_state)
        new["params"] = {k: v - 0.5 * avg_delta[k]
                         for k, v in global_state["params"].items()}
        return new, server_state

    return payload_fn, server_fn


def sharded_lanes_lr(init, sizes, seed, cohort, sched_ns, epochs,
                     sched_seed, round_seed, hooks, packed=False):
    """``ShardedLaneRunner`` over LR rows sharded on the group's mesh
    (rows ``sizes`` from ``seed``, cohort ``cohort`` with schedule
    ``pack_schedule(sched_ns, 8, epochs, default_rng(sched_seed))``)
    against the port's flat round over the cohort's rows:
    ``{"lanes", "flat", "count", "trip"}``."""
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 ShardedLaneRunner,
                                                 make_indexed_sim_round)
    from fedml_tpu_torch.parallel.multihost import global_cohort
    from fedml_tpu_torch.parallel.packing import (pack_schedule,
                                                  stack_clients)

    spec, cfg = _lr_spec(), ClientUpdateConfig(lr=0.2)
    payload_fn, server_fn = _delta_hooks() if hooks else (None, None)
    stacked = stack_clients(lr_clients(sizes, seed))
    sched = pack_schedule(sched_ns, 8, epochs=epochs,
                          rng=np.random.default_rng(sched_seed))
    mesh = _mesh()
    placed = global_cohort(mesh, {"x": stacked["x"], "y": stacked["y"]})
    runner = ShardedLaneRunner(spec, cfg, mesh, payload_fn, server_fn,
                               n_lanes=2, packed=packed)
    got, _, info = runner.run_round(_lr_state(init), (), placed, cohort,
                                    sched, round_seed)
    sel = np.asarray(cohort)
    dd = {"x": torch.as_tensor(stacked["x"][sel]),
          "y": torch.as_tensor(stacked["y"][sel]).long()}
    js = {k: torch.as_tensor(v) for k, v in sched.items()}
    js["idx"] = js["idx"].long()
    want, _, _ = make_indexed_sim_round(spec, cfg, payload_fn, server_fn)(
        _lr_state(init), (), dd, js, round_seed)
    return {"lanes": _np(got), "flat": _np(want),
            "count": float(info["metrics"]["count"]), "trip": info["trip"]}


def api_mesh_rounds(init, wave_mode):
    """``FedAvgAPI`` on LEAF synthetic (8 clients) over the group's mesh
    for 2 rounds: ``(state, history, sharded_lanes)``."""
    import types

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.data.synthetic import load_synthetic_federated

    ds = load_synthetic_federated(client_num=8, n_train=640, n_test=160,
                                  seed=0)
    args = types.SimpleNamespace(
        client_num_per_round=8, comm_round=2, epochs=1, batch_size=16,
        lr=0.3, client_optimizer="sgd", wd=0.0, frequency_of_the_test=100,
        ci=0, seed=0, wave_mode=wave_mode, client_chunk=2,
        device_resident="auto")
    api = FedAvgAPI(ds, _lr_spec(), args, mesh=_mesh())
    api.global_state = _lr_state(init)
    for _ in range(2):
        api.train_one_round()
    return (_np(api.global_state), [dict(m) for m in api.history],
            api.sharded_lane_runner is not None)


def run_main(main, argv):
    """``fedml_tpu_torch.experiments.<main>.main(argv)`` on every rank:
    ``(state, history, api.mesh shape, whether this rank's sink writes
    files)``."""
    import importlib

    module = importlib.import_module(f"fedml_tpu_torch.experiments.{main}")
    api, state = module.main(argv)
    return (_np(state), [{k: v for k, v in m.items()
                          if k != "round_time_s"} for m in api.history],
            None if api.mesh is None else dict(api.mesh.shape),
            type(api.metrics_logger).__name__)


def ring_case(seed, causal, T, block, B=2, H=2, D=8):
    """Ring attention over the group (one ``seq`` axis) against the
    plain ``mha`` of the whole sequence, forward and gradients of this
    rank's shard, with the largest K/V tensor any ring hop moved and the
    rank's output shard: ``{"errs": [o, dq, dk, dv], "hop_rows": ...,
    "n": ..., "rows": (start, stop), "o": ...}``."""
    from fedml_tpu_torch.ops import ring_attention as ra
    from fedml_tpu_torch.ops.attention import mha
    from fedml_tpu_torch.parallel.mesh import make_2d_mesh

    mesh = make_2d_mesh(1, torch.distributed.get_world_size(),
                        ("data", "seq"), device="cpu")
    n, me = mesh.shape["seq"], mesh.index("seq")
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, T, H, D)),
                                   dtype=torch.float32) for _ in range(4))
    Tl = T // n
    sl = slice(me * Tl, (me + 1) * Tl)
    rows = []
    rotate = ra._rotate

    def spy(tensors, *a):
        rows.extend(int(t.shape[1]) for t in tensors)
        return rotate(tensors, *a)

    ra._rotate = spy
    try:
        ql, kl, vl = (t[:, sl].clone().requires_grad_(True)
                      for t in (q, k, v))
        o = ra.ring_attention(ql, kl, vl, mesh, causal=causal,
                              block_size=block)
        o.backward(do[:, sl])
    finally:
        ra._rotate = rotate
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = mha(qr, kr, vr, causal=causal)
    ref.backward(do)
    errs = [float((a - b).abs().max()) for a, b in (
        (o.detach(), ref.detach()[:, sl]), (ql.grad, qr.grad[:, sl]),
        (kl.grad, kr.grad[:, sl]), (vl.grad, vr.grad[:, sl]))]
    return {"errs": errs, "hop_rows": max(rows, default=0), "n": n,
            "rows": (sl.start, sl.stop), "o": o.detach().numpy()}


def sp_step(params, idx, n_data):
    """One ``make_seq_parallel_lm_step`` SGD step of a 1-layer LM
    (vocab 50, 2 heads, d_model 32, T = idx's) on an ``(n_data,
    world / n_data)`` mesh from ``params`` (torch names, numpy):
    ``(new params, loss, mesh shape)``."""
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel.seq_parallel import (
        make_seq_mesh, make_seq_parallel_lm_step, place_lm_batch,
        seq_parallel_model, shift_targets)

    n_seq = torch.distributed.get_world_size() // n_data
    mesh = make_seq_mesh(n_data, n_seq, device="cpu")
    model = seq_parallel_model(TransformerLM, mesh, block_size=8,
                               vocab_size=50, n_layers=1, n_heads=2,
                               d_model=32, max_len=idx.shape[1])
    init_fn, step_fn = make_seq_parallel_lm_step(
        model, mesh, lambda ps: torch.optim.SGD(ps, lr=0.1))
    p, opt = init_fn(3)
    with torch.no_grad():
        for k, t in p.items():
            t.copy_(torch.as_tensor(params[k]))
    new, _, loss = step_fn(p, opt, *place_lm_batch(mesh, idx,
                                                   shift_targets(idx)))
    return _np(new), float(loss), dict(mesh.shape)


def longcontext_main(argv):
    """``main_longcontext.main(argv)`` on every rank: ``(params,
    losses)``."""
    from fedml_tpu_torch.experiments import main_longcontext

    params, losses = main_longcontext.main(argv)
    return _np({k: v.detach() for k, v in params.items()}), losses


def dryrun(depth=20, resnet_state=None, lm_params=None, lm_idx=None,
           parallel=None):
    """The port's dry run over the group: its report with the states."""
    from fedml_tpu_torch.parallel.dryrun import dryrun_multichip

    state = None
    if resnet_state is not None:
        state = {part: {k: torch.as_tensor(v) for k, v in leaves.items()}
                 for part, leaves in resnet_state.items()}
    return dryrun_multichip(device="cpu", resnet_state=state,
                            lm_params=lm_params, lm_idx=lm_idx,
                            depth=depth, parallel=parallel)


def multihost_helpers():
    """The control plane's helpers on every rank: rank and world, the
    primary flag, this rank's cohort block, the gathered metrics, the
    ``global_put`` blocks and one all-reduced sum."""
    from fedml_tpu_torch.parallel.multihost import (
        all_reduce_sum, gather_metrics, global_cohort, global_put,
        is_primary, maybe_initialize_distributed, sync)

    first = maybe_initialize_distributed("cpu")
    again = maybe_initialize_distributed("cpu")
    mesh = _mesh()
    data = {"x": np.arange(14, dtype=np.float32).reshape(7, 2),
            "y": np.arange(7)}
    sh = global_cohort(mesh, data)
    metrics = gather_metrics(sh)
    grid = np.arange(24).reshape(4, 6)
    from fedml_tpu_torch.parallel.mesh import (client_sharding,
                                               make_2d_mesh,
                                               replicated_sharding)
    m2 = make_2d_mesh(2, mesh.size // 2, ("data", "seq"), device="cpu")
    put = global_put(m2, grid, ("data", "seq"))
    rep = global_put(m2, grid, replicated_sharding(m2))
    rows = global_put(mesh, grid, client_sharding(mesh))
    total = all_reduce_sum({"a": torch.ones(3) * (mesh.index("clients")
                                                  + 1)}, mesh.group())
    sync("test")
    return {"init": (first, again), "primary": is_primary(),
            "start": sh.start, "total": sh.total,
            "local_x": sh.local["x"].numpy(), "y_dtype": str(
                sh.local["y"].dtype), "gathered": metrics,
            "put": put.numpy(), "rep": rep.numpy(), "rows": rows.numpy(),
            "coord": (m2.index("data"), m2.index("seq")),
            "sum": total["a"].numpy()}


def logging_line():
    """The first line ``init_logging`` formats on this rank."""
    import logging

    from fedml_tpu_torch.utils.logging_utils import init_logging

    root = init_logging()
    record = logging.LogRecord("t", logging.INFO, "x.py", 7, "hello", None,
                               None)
    return root.handlers[0].format(record)


def compat_call(name, mesh):
    """``FedML_<name>_distributed`` the reference's way on every rank,
    with ``args.mesh = mesh``: ``(init triple, state, history)``."""
    import types

    from fedml_tpu_torch import compat
    from fedml_tpu_torch.data.synthetic import load_synthetic_federated
    from fedml_tpu_torch.models.linear import LogisticRegression

    comm, rank, world = compat.FedML_init(device="cpu")
    ds = load_synthetic_federated(client_num=4, n_train=400, n_test=80,
                                  seed=0)
    args = types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=2,
        epochs=1, batch_size=16, lr=0.3, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=100, seed=0, class_num=ds[7],
        server_optimizer="sgd", server_lr=0.5, mesh=mesh)
    fn = getattr(compat, f"FedML_{name}_distributed")
    api = fn(rank, world, "cpu", comm,
             LogisticRegression(60, ds[7], apply_sigmoid=False), ds[0],
             ds[2], ds[3], ds[4], ds[5], ds[6], args)
    return ((comm, rank, world), _np(api.global_state),
            [{k: v for k, v in m.items() if k != "round_time_s"}
             for m in api.history])



def _sgd(lr=0.1):
    return lambda ps: torch.optim.SGD(ps, lr=lr)


def _assign(params, values):
    with torch.no_grad():
        for k, t in params.items():
            t.copy_(torch.as_tensor(values[k]))


def tp_step(params, idx, n_data, kw, block):
    """One ``make_tp_lm_step`` SGD step (lr 0.1) of ``TransformerLM(**kw)``
    under ``tp_attention(block)`` on an ``(n_data, world / n_data)`` mesh
    from the whole ``params`` (torch names, numpy): ``{"local", "gathered",
    "loss", "coord", "mesh"}`` -- this rank's shards after the step, every
    leaf gathered whole on the rank, the loss, the rank's (data, model)
    coordinate and the mesh's shape."""
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel import tensor_parallel as tp
    from fedml_tpu_torch.parallel.seq_parallel import shift_targets
    from fedml_tpu_torch.utils.torch_import import tp_shard_params

    n_model = torch.distributed.get_world_size() // n_data
    mesh = tp.make_tp_mesh(n_data, n_model, device="cpu")
    model = TransformerLM(attention_fn=tp.tp_attention(block), **kw)
    init_fn, step_fn = tp.make_tp_lm_step(model, mesh, _sgd())
    p, opt = init_fn(0)
    full = {k: torch.as_tensor(v) for k, v in params.items()}
    _assign(p, tp_shard_params(full, tp.tp_param_shardings(full, mesh),
                               n_model, mesh.index("model")))
    new, _, loss = step_fn(p, opt, idx, shift_targets(idx))
    return {"local": _np({k: v.detach() for k, v in new.items()}),
            "gathered": _np(tp.gather_tp_params(new, mesh)),
            "loss": float(loss), "mesh": dict(mesh.shape),
            "coord": (mesh.index("data"), mesh.index("model"))}


def pp_step(params, idx, kw, n_micro, block=None):
    """One ``make_pp_lm_step`` SGD step (lr 0.1) over a stage a rank from
    the whole ``params`` (torch names, numpy; ``n_layers`` from them):
    ``{"stage", "params", "loss"}`` -- this rank's stacked blocks after
    the step, every stage gathered and unstacked, the loss."""
    from fedml_tpu_torch.parallel import pipeline_parallel as pp
    from fedml_tpu_torch.parallel.seq_parallel import shift_targets
    from fedml_tpu_torch.parallel.tensor_parallel import tp_attention

    S = torch.distributed.get_world_size()
    mesh = pp.make_pp_mesh(S, device="cpu")
    n_layers = len({k.split(".")[1] for k in params
                    if k.startswith("blocks.")})
    _, model = pp.init_pp_params(
        mesh, 0, n_layers=n_layers,
        attention_fn=tp_attention(block) if block else None, **kw)
    p = pp.place_pp_params(pp.stack_pp_params(
        {k: torch.as_tensor(v) for k, v in params.items()}, S), mesh)
    prep_fn, step_fn = pp.make_pp_lm_step(model, mesh, n_micro)
    new, _, loss = step_fn(p, _sgd()(pp.pp_leaves(p)),
                           *prep_fn(idx, shift_targets(idx)))
    return {"stage": _np({k: v.detach() for k, v in new["stages"].items()}),
            "params": _np(pp.unstack_pp_params(pp.gather_pp_params(new,
                                                                   mesh))),
            "loss": float(loss)}


def pp_refusals():
    """The pp builders' refusals over a stage a rank: ``{case: message}``
    (ragged layers at init, a ragged model at the step builder, a ragged
    stacking, a batch that does not split into the microbatches)."""
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel import pipeline_parallel as pp

    S = torch.distributed.get_world_size()
    mesh = pp.make_pp_mesh(S, device="cpu")
    kw = dict(vocab_size=10, n_heads=2, d_model=8, max_len=8)
    out = {}
    calls = {
        "init": lambda: pp.init_pp_params(mesh, 0, n_layers=S + 1, **kw),
        "step": lambda: pp.make_pp_lm_step(
            TransformerLM(n_layers=S + 1, **kw), mesh),
        "stack": lambda: pp.stack_pp_params(dict(
            TransformerLM(n_layers=S + 1, **kw).named_parameters()), S),
        "micro": lambda: pp.make_pp_lm_step(
            TransformerLM(n_layers=S, **kw), mesh, n_micro=3)[0](
                np.zeros((4, 8)), np.zeros((4, 8)))}
    for name, fn in calls.items():
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)
    return out


def ep_step(params, idx, n_data, kw, block):
    """One ``make_ep_lm_step`` SGD step (lr 0.1) of
    ``MoETransformerLM(**kw)`` under ``tp_attention(block)`` on an
    ``(n_data, world / n_data)`` mesh from the whole ``params``:
    ``{"local", "gathered", "loss", "coord", "mesh"}`` as
    :func:`tp_step`."""
    from fedml_tpu_torch.models.moe import MoETransformerLM
    from fedml_tpu_torch.parallel import expert_parallel as ep
    from fedml_tpu_torch.parallel.seq_parallel import shift_targets
    from fedml_tpu_torch.parallel.tensor_parallel import tp_attention
    from fedml_tpu_torch.utils.torch_import import tp_shard_params

    n_ep = torch.distributed.get_world_size() // n_data
    mesh = ep.make_ep_mesh(n_data, n_ep, device="cpu")
    model = MoETransformerLM(attention_fn=tp_attention(block), **kw)
    init_fn, step_fn = ep.make_ep_lm_step(model, mesh, _sgd())
    p, opt = init_fn(0)
    full = {k: torch.as_tensor(v) for k, v in params.items()}
    _assign(p, tp_shard_params(full, ep.ep_param_shardings(full, mesh),
                               n_ep, mesh.index("expert"), "expert"))
    new, _, loss = step_fn(p, opt, idx, shift_targets(idx))
    return {"local": _np({k: v.detach() for k, v in new.items()}),
            "gathered": _np(ep.gather_ep_params(new, mesh)),
            "loss": float(loss), "mesh": dict(mesh.shape),
            "coord": (mesh.index("data"), mesh.index("expert"))}


class MLPServer(torch.nn.Module):
    """The reference test's BN-free FedGKT server
    (``tests/test_split_vertical_mpc.py:104``): flatten, Dense 32, ReLU,
    Dense to the classes."""

    def __init__(self, in_features, num_classes=10):
        super().__init__()
        self.fc1 = torch.nn.Linear(in_features, 32)
        self.fc2 = torch.nn.Linear(32, num_classes)

    def forward(self, features, train=False):
        x = features.reshape(features.shape[0], -1)
        return self.fc2(torch.relu(self.fc1(x)))


def gkt_round(n_model, bn, batch_size=8):
    """One FedGKT round (the reference test's 2 clients of synthetic 8x8
    images, ``resnet5_56`` edges, batch 8) with the server phase over a
    ``(1, n_model)`` mesh of the group's first ranks (None: unsharded),
    the server :class:`MLPServer` or, with ``bn``, ``GKTServerResNet``
    at ``n`` 1; then ``evaluate``: ``{"sharded", "record", "server",
    "logits", "eval"}``."""
    import types

    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.data.synthetic import load_synthetic_images
    from fedml_tpu_torch.models.gkt import GKTServerResNet, resnet5_56
    from fedml_tpu_torch.parallel.mesh import make_client_mesh

    mesh = (None if n_model is None
            else make_client_mesh(1, n_model, device="cpu"))
    ds = load_synthetic_images(client_num=2, n_train=64, n_test=32,
                               image_size=8, seed=0)
    args = types.SimpleNamespace(
        client_num_per_round=2, comm_round=1, epochs=1,
        batch_size=batch_size, lr=0.3, client_optimizer="sgd", wd=0.0,
        frequency_of_the_test=100, ci=0, seed=0, device="cpu")
    server = (GKTServerResNet(n=1, num_classes=10) if bn
              else MLPServer(8 * 8 * 16))
    api = FedGKTAPI(ds, resnet5_56(class_num=10), server, args, mesh=mesh)
    record = api.train_one_round()
    return {"sharded": api.mesh is not None, "record": record,
            "server": _np(api.server_state["params"]),
            "logits": api.server_logits.numpy(), "eval": api.evaluate()}
