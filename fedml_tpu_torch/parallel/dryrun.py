"""The multi-rank dry run (counterpart of the reference's
``__graft_entry__.dryrun_multichip``): sharded rounds over the ranks of
the group it runs in, each held to the single-device round of the same
inputs.

Cases, at the reference's sizes and bounds:

1. ``fedavg``: ResNet-20 on 16x16x3 images, 2n clients of 8 samples,
   batch 4, the host-packed sharded round against the single-device
   simulation, within 1e-5;
2. ``fedavg-uneven``: 2n - 3 clients, padded with zero-weight dummies;
3. ``fedopt``: n clients, a server SGD at 0.5;
4. ``robust``: n clients, the norm clip at 5;
5. ``sharded-lanes``: resident rows sharded over the ranks, vmap lanes,
   against the flat round;
6. ``sharded-mxu-lanes``: the packed lanes on a one-step cohort;
7. ``seqpar``: one dp x sp LM step (``n_seq`` 4 when it divides n, else
   n) against the unsharded step, loss and parameters within 1e-4;
8. ``tp``: one dp x tp LM step (``n_model`` 4 when it divides n, else
   n; as many heads, d_model 8 a head) against the unsharded step;
9. ``pp``: one GPipe LM step over n stages of two blocks each, 2
   microbatches, against the unsharded step;
10. ``ep``: one dp x ep step of the MoE LM (``n_expert`` 4 when it
   divides n, else n; as many experts) against the unsharded step.

Cases 8-10 are the reference's cases 7-9 (``__graft_entry__.py:273``,
``:311``, ``:346``), at its sizes and with its 1e-4 bound.

The ResNet's state and compute are float64 (:data:`DTYPE`).
Torch's convolutions over K clients at once are grouped convolutions
whose sums associate differently for different K (a rank trains its
block of the cohort, the single-device round all of it), and two SGD
steps through batch-4 BatchNorm amplify a difference of one rounding by
up to about 1e4 (the reference's note on its packed case): on the CPU a
client's fp32 weights after its round moved by 1.5e-2 between K = 2 and
K = 1, and with float64 compute over fp32 weights by 1.9e-4. XLA runs
one per-client program whatever the cohort, so the reference holds fp32
to 1e-5; in float64 what is left is the fp32 aggregation's
reassociation.

Run it under a launcher, one process a device::

    torchrun --nproc_per_node 4 -m fedml_tpu_torch.parallel.dryrun \
        --platform cpu
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

FEDAVG_TOL, SEQPAR_TOL = 1e-5, 1e-4
DTYPE = torch.float64


def _fresh(tree):
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_fresh(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _cast(tree, dtype):
    """A copy of ``tree`` with its floating leaves in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return (tree.to(dtype) if tree.is_floating_point()
            else tree.clone())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def max_abs_diff(a, b):
    """The largest absolute difference between two same-shaped trees."""
    bl = dict(_leaves(b))
    return max(float((x.detach().cpu().double()
                      - bl[k].detach().cpu().double()).abs().max())
               for k, x in _leaves(a))


def to_numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in _leaves(tree)}


def _cohort(n_clients, seed):
    from fedml_tpu_torch.parallel.packing import pack_cohort

    rng = np.random.default_rng(seed)
    clients = [{"x": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                "y": rng.integers(0, 10, 8).astype(np.int64)}
               for _ in range(n_clients)]
    return pack_cohort(clients, batch_size=4, epochs=1, step_bucket=2)


def _on(device, packed):
    out = {k: torch.as_tensor(v, device=device) for k, v in packed.items()}
    out["y"] = out["y"].long()
    return out


def _lane_case(spec, cfg, mesh, state, clients, sched, packed, seed):
    """Sharded lanes over ``clients`` against the flat round."""
    from fedml_tpu_torch.parallel.engine import (ShardedLaneRunner,
                                                 make_indexed_sim_round)
    from fedml_tpu_torch.parallel.multihost import global_cohort
    from fedml_tpu_torch.parallel.packing import stack_clients

    stacked = stack_clients(clients)
    placed = global_cohort(mesh, {"x": stacked["x"], "y": stacked["y"]})
    runner = ShardedLaneRunner(spec, cfg, mesh, n_lanes=2, packed=packed)
    got, _, info = runner.run_round(_fresh(state), (), placed,
                                    list(range(len(clients))), sched, seed)
    dev = mesh.device
    dd = {"x": torch.as_tensor(stacked["x"], device=dev),
          "y": torch.as_tensor(stacked["y"], device=dev).long()}
    js = {k: torch.as_tensor(v, device=dev) for k, v in sched.items()}
    js["idx"] = js["idx"].long()
    want, _, _ = make_indexed_sim_round(spec, cfg)(_fresh(state), (), dd,
                                                   js, seed)
    return got, max_abs_diff(got, want)


def _seqpar(n, device, lm_params=None, lm_idx=None):
    """One dp x sp SGD step of a 1-layer LM against the unsharded step:
    ``(new params, loss, param err, loss err, mesh shape)``."""
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel.seq_parallel import (
        make_seq_mesh, make_seq_parallel_lm_step, place_lm_batch,
        seq_parallel_model, shift_targets)

    n_seq = 4 if n % 4 == 0 else n
    n_data = n // n_seq
    B, T = 2 * n_data, 8 * n_seq
    mesh = make_seq_mesh(n_data, n_seq, device=device)
    kw = dict(vocab_size=50, n_layers=1, n_heads=2, d_model=32, max_len=T)
    model = seq_parallel_model(TransformerLM, mesh, block_size=8, **kw)
    idx = (np.asarray(lm_idx) if lm_idx is not None
           else np.random.default_rng(2).integers(0, 50, (B, T)))
    tgt = shift_targets(idx)
    init_fn, step_fn = make_seq_parallel_lm_step(
        model, mesh, lambda ps: torch.optim.SGD(ps, lr=0.1))
    params, opt = init_fn(3)
    _overwrite(params, lm_params)
    params0 = {k: p.detach().clone() for k, p in params.items()}
    new, _, loss = step_fn(params, opt, *place_lm_batch(mesh, idx, tgt))
    ref_new, ref_loss = unsharded_step(TransformerLM(**kw), params0, idx)
    new = {k: p.detach() for k, p in new.items()}
    return (new, float(loss), max_abs_diff(new, ref_new),
            abs(float(loss) - ref_loss), (n_data, n_seq))


def unsharded_step(model, params0, idx, aux_weight=0.0):
    """The single-device SGD step (lr 0.1) of ``model`` from ``params0``
    on ``idx``: ``(new params, loss)``."""
    from fedml_tpu_torch.models.transformer import lm_loss
    from fedml_tpu_torch.parallel.seq_parallel import shift_targets

    dev = next(iter(params0.values())).device
    ref = {k: p.clone().requires_grad_(True) for k, p in params0.items()}
    logits, aux = model.apply_params(
        ref, torch.as_tensor(idx, device=dev).long(), with_sown=True)
    loss = lm_loss(logits, torch.as_tensor(shift_targets(idx),
                                           device=dev).long())
    loss = loss + aux_weight * aux
    grads = dict(zip(ref, torch.autograd.grad(loss, list(ref.values()))))
    return ({k: ref[k].detach() - 0.1 * grads[k] for k in ref},
            float(loss.detach()))


def _overwrite(params, values):
    if values is not None:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(torch.as_tensor(np.asarray(values[k])))


def _model_parallel(n, device, given=None):
    """Cases 8-10: ``{case: (new params, loss, param err, loss err,
    mesh shape)}``; ``given`` maps a case to ``(params, idx)`` replacing
    its weights (torch names, whole) and tokens."""
    from fedml_tpu_torch.models.moe import MoETransformerLM
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel import expert_parallel as ep
    from fedml_tpu_torch.parallel import pipeline_parallel as pp
    from fedml_tpu_torch.parallel import tensor_parallel as tp
    from fedml_tpu_torch.parallel.seq_parallel import shift_targets
    from fedml_tpu_torch.utils.torch_import import tp_shard_params

    given = given or {}
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731
    out = {}

    def tokens(case, seed, shape):
        if case in given:
            return np.asarray(given[case][1])
        return np.random.default_rng(seed).integers(0, 50, shape)

    def finish(case, new, loss, model, full0, idx, shape, aux_weight=0.0):
        want, want_loss = unsharded_step(model, full0, idx, aux_weight)
        out[case] = (new, float(loss), max_abs_diff(new, want),
                     abs(float(loss) - want_loss), shape)

    n_tp = 4 if n % 4 == 0 else n
    mesh = tp.make_tp_mesh(n // n_tp, n_tp, device=device)
    kw = dict(vocab_size=50, n_layers=1, n_heads=n_tp, d_model=8 * n_tp,
              max_len=32)
    model = TransformerLM(attention_fn=tp.tp_attention(block_size=32), **kw)
    init_fn, step_fn = tp.make_tp_lm_step(model, mesh, sgd)
    params, opt = init_fn(5)
    full0 = tp.gather_tp_params(params, mesh)
    if "tp" in given:
        full0 = {k: torch.as_tensor(np.asarray(v), device=mesh.device)
                 for k, v in given["tp"][0].items()}
        _overwrite(params, tp_shard_params(
            full0, tp.tp_param_shardings(full0, mesh), n_tp,
            mesh.index("model")))
    idx = tokens("tp", 4, (2 * (n // n_tp), 32))
    params, _, loss = step_fn(params, opt, idx, shift_targets(idx))
    finish("tp", tp.gather_tp_params(params, mesh), loss, model, full0, idx,
           (n // n_tp, n_tp))

    mesh = pp.make_pp_mesh(n, device=device)
    params, model = pp.init_pp_params(
        mesh, 7, vocab_size=50, n_heads=2, d_model=32, max_len=32,
        attention_fn=tp.tp_attention(block_size=16), n_layers=2 * n)
    if "pp" in given:
        params = pp.place_pp_params(pp.stack_pp_params(
            {k: torch.as_tensor(np.asarray(v))
             for k, v in given["pp"][0].items()}, n), mesh)
    full0 = pp.unstack_pp_params(pp.gather_pp_params(params, mesh))
    idx = tokens("pp", 6, (4, 16))
    prep_fn, step_fn = pp.make_pp_lm_step(model, mesh, n_micro=2)
    params, _, loss = step_fn(params, sgd(pp.pp_leaves(params)),
                              *prep_fn(idx, shift_targets(idx)))
    finish("pp", pp.unstack_pp_params(pp.gather_pp_params(params, mesh)),
           loss, model, full0, idx, (n,))

    n_ep = 4 if n % 4 == 0 else n
    mesh = ep.make_ep_mesh(n // n_ep, n_ep, device=device)
    model = MoETransformerLM(
        vocab_size=50, n_layers=1, n_heads=2, d_model=16, max_len=32,
        n_experts=n_ep, attention_fn=tp.tp_attention(block_size=16))
    init_fn, step_fn = ep.make_ep_lm_step(model, mesh, sgd)
    params, opt = init_fn(9)
    full0 = ep.gather_ep_params(params, mesh)
    if "ep" in given:
        full0 = {k: torch.as_tensor(np.asarray(v), device=mesh.device)
                 for k, v in given["ep"][0].items()}
        _overwrite(params, tp_shard_params(
            full0, ep.ep_param_shardings(full0, mesh), n_ep,
            mesh.index("expert"), "expert"))
    idx = tokens("ep", 8, (2 * (n // n_ep), 16))
    params, _, loss = step_fn(params, opt, idx, shift_targets(idx))
    finish("ep", ep.gather_ep_params(params, mesh), loss, model, full0, idx,
           (n // n_ep, n_ep), ep.MOE_AUX_WEIGHT)
    return out


def dryrun_multichip(device=None, resnet_state=None, lm_params=None,
                     lm_idx=None, depth=20, parallel=None):
    """Cases 1-10 over the ranks of the current group (one rank alone
    when there is none), each asserted within its bound. ``device`` is
    ``"cpu"`` or None for the card; ``resnet_state`` and ``lm_params``
    replace the initial weights drawn from seeds 0 and 3, ``lm_idx`` the
    LM's tokens; ``parallel`` maps ``"tp"``, ``"pp"`` and ``"ep"`` to
    ``(params, idx)`` replacing theirs (drawn from seeds 5, 7 and 9;
    tokens from 4, 6 and 8); ``depth`` is the ResNet's. Returns ``{"n",
    "errors", "states", "losses", "meshes"}``: each case's divergence
    from its single-device round, its new state as numpy, and the LM
    cases' losses and mesh shapes."""
    import torch.distributed as dist

    from fedml_tpu_torch.algorithms.fedavg_robust import make_robust_hooks
    from fedml_tpu_torch.algorithms.fedopt import (get_server_optimizer,
                                                   make_fedopt_hooks)
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.models.resnet import CifarResNet
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 make_sharded_round,
                                                 make_sim_round)
    from fedml_tpu_torch.parallel.mesh import make_client_mesh
    from fedml_tpu_torch.parallel.multihost import gather_metrics
    from fedml_tpu_torch.parallel.packing import pack_schedule

    mesh = make_client_mesh(device=device)
    dev = mesh.device
    n = mesh.shape["clients"]
    spec = make_classification_spec(
        CifarResNet(depth=depth, num_classes=10, dtype=DTYPE))
    state = _cast(spec.init_fn(0, dev) if resnet_state is None
                  else resnet_state, DTYPE)
    cfg = ClientUpdateConfig(optimizer="sgd", lr=0.1)
    seed = 1
    server_tx = get_server_optimizer("sgd", lr=0.5)
    cases = [("fedavg", 2 * n, (None, None), ()),
             ("fedavg-uneven", max(2 * n - 3, 1), (None, None), ()),
             ("fedopt", n, make_fedopt_hooks(server_tx),
              server_tx.init(state["params"])),
             ("robust", n, make_robust_hooks(5.0, 0.0), ())]
    errors, states = {}, {}

    rng = np.random.default_rng(99)
    sl_clients = [{"x": rng.normal(size=(m, 16, 16, 3)).astype(np.float32),
                   "y": rng.integers(0, 10, m).astype(np.int64)}
                  for m in ([8, 12, 6, 10] * ((2 * n + 3) // 4 + 1))[
                      :max(2 * n - 3, 1)]]
    sched = pack_schedule([len(c["y"]) for c in sl_clients], 4, 1,
                          rng=np.random.default_rng(7))
    got, errors["sharded-lanes"] = _lane_case(spec, cfg, mesh, state,
                                              sl_clients, sched, False, seed)
    states["sharded-lanes"] = to_numpy(got)
    # packed lanes on a one-step cohort: through batch-4 BatchNorm a
    # longer trajectory amplifies reassociation far past the bound
    rng = np.random.default_rng(101)
    p_clients = [{"x": rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
                  "y": rng.integers(0, 10, 4).astype(np.int64)}
                 for _ in range(max(2 * n - 3, 1))]
    p_sched = pack_schedule([4] * len(p_clients), 4, 1,
                            rng=np.random.default_rng(7))
    got, errors["sharded-mxu-lanes"] = _lane_case(
        spec, cfg, mesh, state, p_clients, p_sched, True, seed)
    states["sharded-mxu-lanes"] = to_numpy(got)

    for i, (name, clients, (payload_fn, server_fn), server_state) in (
            enumerate(cases)):
        packed = _cohort(clients, seed=i)
        got, _, info = make_sharded_round(spec, cfg, mesh, payload_fn,
                                          server_fn)(
            _fresh(state), _fresh(server_state), packed, seed)
        counts = gather_metrics(info["metrics"])["count"]
        if counts.sum() != 8 * clients:
            raise AssertionError(f"{name}: trained {counts.sum()} samples, "
                                 f"expected {8 * clients}")
        if not all(bool(torch.isfinite(v).all()) for _, v in _leaves(got)):
            raise AssertionError(f"{name}: non-finite state")
        want, _, _ = make_sim_round(spec, cfg, payload_fn, server_fn)(
            _fresh(state), _fresh(server_state), _on(dev, packed), seed)
        errors[name] = max_abs_diff(got, want)
        states[name] = to_numpy(got)
    for name, err in errors.items():
        if not err < FEDAVG_TOL:
            raise AssertionError(f"{name}: sharded/single-device "
                                 f"divergence {err}")

    new, loss, sp_err, loss_err, shape = _seqpar(n, device, lm_params,
                                                 lm_idx)
    if not (loss_err < SEQPAR_TOL and sp_err < SEQPAR_TOL):
        raise AssertionError(f"seqpar {shape}: loss off by {loss_err}, "
                             f"params by {sp_err}")
    errors["seqpar"] = sp_err
    states["seqpar"] = to_numpy(new)
    losses, meshes = {"seqpar": loss}, {"seqpar": shape}
    for case, (new, loss, err, loss_err, shape) in _model_parallel(
            n, device, parallel).items():
        if not (loss_err < SEQPAR_TOL and err < SEQPAR_TOL):
            raise AssertionError(f"{case} {shape}: loss off by {loss_err}, "
                                 f"params by {err}")
        errors[case], states[case] = err, to_numpy(new)
        losses[case], meshes[case] = loss, shape
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == 0:
        logging.info("dryrun_multichip(%d): OK -- %s", n, ", ".join(
            f"{k}={v:.2e}" for k, v in errors.items()))
    return {"n": n, "errors": errors, "states": states, "losses": losses,
            "meshes": meshes}


def main(argv=None):
    from fedml_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed)
    from fedml_tpu_torch.utils.logging_utils import init_logging

    p = argparse.ArgumentParser("dryrun-torch")
    p.add_argument("--platform", type=str, default=None,
                   help="cpu runs on the CPU; default the card")
    args = p.parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    maybe_initialize_distributed(device)
    init_logging()
    return dryrun_multichip(device=device)


__all__ = ["dryrun_multichip", "unsharded_step", "max_abs_diff",
           "FEDAVG_TOL", "SEQPAR_TOL"]


if __name__ == "__main__":
    main()
