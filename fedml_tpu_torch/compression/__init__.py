"""``fedml_tpu_torch.compression``: client-update compression and the
binary wire codec (counterpart of ``fedml_tpu/compression``).

- :mod:`.codec`: binary framing of array payloads (header, dtype, shape,
  raw bytes), byte for byte the reference's frames; numpy only.
- :mod:`.compressors`: the torch compressors over the client axis
  (``none``/``topk``/``randk``/``qsgd``/``signsgd``) with
  :class:`ErrorFeedback`, chosen by spec string (:func:`get_compressor`).
- :mod:`.integration`: the compressed host-packed round, the id-keyed
  :class:`ResidualStore` and the on-wire byte accounting behind
  ``bytes_on_wire`` and ``compression_ratio``.
- :mod:`.wire`: the numpy twin of the compressors for a real uplink and
  the :class:`CompressedUpdate` the server folds sparsely; numpy only.

Exports resolve lazily, so :mod:`.codec` and :mod:`.wire` (which
import numpy only) load neither the compressors nor the round code.
"""

_EXPORTS = {
    "fedml_tpu_torch.compression.codec": (
        "encode_array", "decode_array", "encode_tree", "decode_tree",
        "message_to_wire", "message_from_wire", "tree_wire_nbytes"),
    "fedml_tpu_torch.compression.compressors": (
        "Compressor", "NoneCompressor", "TopKCompressor", "RandKCompressor",
        "QSGDCompressor", "SignSGDCompressor", "ErrorFeedback",
        "get_compressor"),
    "fedml_tpu_torch.compression.integration": (
        "make_compressed_sim_round", "ResidualStore",
        "compressed_payload_nbytes", "raw_payload_nbytes"),
    "fedml_tpu_torch.compression.wire": (
        "host_compressor", "HostCompressor", "CompressedUpdate",
        "ef_step", "encode_rng", "wire_payload_nbytes",
        "WIRE_DELTA_KEY", "WIRE_SPEC_KEY"),
}

__all__ = [name for names in _EXPORTS.values() for name in names]

_BY_NAME = {name: mod for mod, names in _EXPORTS.items() for name in names}


def __getattr__(name):
    mod = _BY_NAME.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
