"""A ``RoundProgram`` lowered onto the port's simulation engine
(counterpart of ``fedml_tpu/program/sim.py``): the host-packed round
function (plain or compressed: the one decision the codec leg implies)
and the bucketed streaming runner, with the program's privacy legs on
the per-client payload hook; on a ``clients`` mesh, the sharded
round."""

from __future__ import annotations


def _clipped_payload(inner, bound):
    """Per-client norm clip of ``local - global`` as a ``payload_fn``
    wrapper, then the inner payload transform."""
    def fn(local_state, global_state, aux):
        from fedml_tpu_torch.core.robust import norm_diff_clipping
        clipped = norm_diff_clipping(local_state, global_state, bound)
        if inner is None:
            return clipped
        return inner(clipped, global_state, aux)
    return fn


def _apply_privacy_legs(program, payload_fn):
    """The program's dp/robust legs on the per-client payload hook: a DP
    clip (``noise_multiplier == 0``) and the robust ``norm_clip`` are
    per-client transforms before the average. DP noise needs a
    per-(client, round) stream the hook does not carry, and the
    order-statistic folds are not weighted averages: both run on the
    host plane (``host_view()``), and asking the simulation for them
    raises."""
    dp, robust = program.dp, program.robust
    if dp is not None:
        if dp.noise_multiplier:
            raise ValueError(
                "compile_sim cannot lower the DP noise leg (the simulated "
                "round has no per-client noise stream); drive the "
                "program's host_view, or set noise_multiplier=0 for "
                "clip-only")
        payload_fn = _clipped_payload(payload_fn, dp.clip_norm)
    if robust is not None:
        if robust.mode != "norm_clip":
            raise ValueError(
                f"compile_sim cannot lower the {robust.mode!r} robust "
                "fold (order statistics are not a weighted average); "
                "drive the program's host_view")
        payload_fn = _clipped_payload(payload_fn, robust.clip_bound)
    return payload_fn


def compile_sim(program, spec, cfg, payload_fn=None, server_fn=None,
                mesh=None, compressed=None, compressor=None):
    """Program -> the host-packed round function: with ``mesh`` the
    sharded round over its ``clients`` axis
    (:func:`~fedml_tpu_torch.parallel.engine.make_sharded_round`; the
    codec leg is not lowered there, mesh aggregation being collectives
    with no wire, and the caller refuses a compressor on a mesh); with
    the codec leg enabled (or ``compressed=True``) the compressed round
    with per-client error feedback
    (:func:`~fedml_tpu_torch.compression.integration.make_compressed_sim_round`),
    else the plain one
    (:func:`~fedml_tpu_torch.parallel.engine.make_sim_round`).
    ``compressed=False`` forces the plain lowering; ``compressor``
    overrides ``program.codec.device()`` (a resolved instance keeps its
    configuration)."""
    payload_fn = _apply_privacy_legs(program, payload_fn)
    if mesh is not None:
        from fedml_tpu_torch.parallel.engine import make_sharded_round
        return make_sharded_round(spec, cfg, mesh, payload_fn, server_fn)
    if compressed is None:
        compressed = program.codec.enabled
    if not compressed:
        from fedml_tpu_torch.parallel.engine import make_sim_round
        return make_sim_round(spec, cfg, payload_fn, server_fn)
    from fedml_tpu_torch.compression.integration import (
        make_compressed_sim_round)
    comp = compressor if compressor is not None else program.codec.device()
    if comp is None:
        raise ValueError("compile_sim(compressed=True) on a program whose "
                         "codec leg is disabled")
    return make_compressed_sim_round(spec, cfg, comp, payload_fn,
                                     server_fn)


def compile_bucketed(program, spec, cfg, payload_fn=None, server_fn=None,
                     compressor=None, **kwargs):
    """Program -> :class:`~fedml_tpu_torch.parallel.engine.
    BucketedStreamRunner`; ``kwargs`` pass through (``client_chunk``,
    ``batch_size``, ``epochs``, ``edges``)."""
    from fedml_tpu_torch.parallel.engine import BucketedStreamRunner
    payload_fn = _apply_privacy_legs(program, payload_fn)
    return BucketedStreamRunner(spec, cfg, payload_fn, server_fn,
                                compressor=compressor, **kwargs)


__all__ = ["compile_sim", "compile_bucketed"]
