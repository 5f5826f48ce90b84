"""A ``RoundProgram`` lowered onto the port's simulation engine
(counterpart of ``fedml_tpu/program/sim.py``): the host-packed round
function and the bucketed streaming runner. Mesh rounds wait for ROADMAP
A15, the compressed lowering for A12."""

from __future__ import annotations


def compile_sim(program, spec, cfg, payload_fn=None, server_fn=None,
                mesh=None, compressed=None, compressor=None):
    """Program -> the host-packed round function
    (:func:`~fedml_tpu_torch.parallel.engine.make_sim_round`)."""
    if mesh is not None:
        raise NotImplementedError("mesh rounds wait for ROADMAP A15")
    if compressed or compressor is not None or program.codec.enabled:
        raise NotImplementedError(
            "the compressed round waits for ROADMAP A12 (compression)")
    from fedml_tpu_torch.parallel.engine import make_sim_round
    return make_sim_round(spec, cfg, payload_fn, server_fn)


def compile_bucketed(program, spec, cfg, payload_fn=None, server_fn=None,
                     compressor=None, **kwargs):
    """Program -> :class:`~fedml_tpu_torch.parallel.engine.
    BucketedStreamRunner`; ``kwargs`` pass through (``client_chunk``,
    ``batch_size``, ``epochs``, ``edges``)."""
    from fedml_tpu_torch.parallel.engine import BucketedStreamRunner
    return BucketedStreamRunner(spec, cfg, payload_fn, server_fn,
                                compressor=compressor, **kwargs)


__all__ = ["compile_sim", "compile_bucketed"]
