"""Codec leg of a ``RoundProgram`` (counterpart of
``fedml_tpu/program/codec.py``): one spec string, two lowerings. The
torch compressor (:mod:`fedml_tpu_torch.compression.compressors`) runs
inside the simulated round on the device; the numpy twin
(:mod:`fedml_tpu_torch.compression.wire`) encodes the same spec for a
real uplink. :class:`CodecSpec` names both, and ``device()`` is the only
accessor that loads torch's compressors."""

from __future__ import annotations

from dataclasses import dataclass

#: wire-capable codec families: every name the host twin's registry
#: serves (randk is sim-only; ``wire.host_compressor`` refuses it)
WIRE_CODEC_NAMES = ("qsgd", "topk", "signsgd")

_DISABLED = ("", "0", "off", "false", "none")


def wire_codecs():
    """The wire-codec spec table the drift gate iterates: every host-twin
    family at its default argument and the other points held equal
    across the pair."""
    return ["qsgd", "qsgd:2", "qsgd:4", "qsgd:8",
            "topk", "topk:0.01", "topk:0.25",
            "signsgd"]


@dataclass(frozen=True)
class CodecSpec:
    """Compressor selection of one program; ``spec`` is the grammar both
    registries parse (``"qsgd:4"``, ``"topk:0.01"``, ``"signsgd"``,
    ``"none"``). Biased contractions (topk, signsgd) run error feedback
    on both lowerings; the wire twin runs qsgd without it."""

    spec: str = "none"

    @classmethod
    def coerce(cls, spec) -> "CodecSpec":
        """None, a spec string, a compressor (through its ``spec`` or
        ``name``) or a CodecSpec -> CodecSpec."""
        if isinstance(spec, cls):
            return spec
        if spec is None:
            return cls("none")
        if isinstance(spec, str):
            return cls(spec.strip().lower() or "none")
        s = getattr(spec, "spec", None) or getattr(spec, "name", None)
        if not s:
            raise TypeError(f"cannot coerce {spec!r} into a CodecSpec")
        return cls(str(s))

    @property
    def enabled(self) -> bool:
        return self.spec not in _DISABLED

    @property
    def name(self) -> str:
        return self.spec.partition(":")[0]

    def device(self):
        """The torch compressor (None when disabled)."""
        if not self.enabled:
            return None
        from fedml_tpu_torch.compression.compressors import get_compressor
        return get_compressor(self.spec)

    def host(self):
        """The numpy wire twin (None when disabled)."""
        if not self.enabled:
            return None
        from fedml_tpu_torch.compression.wire import host_compressor
        return host_compressor(self.spec)

    def host_ef(self) -> bool:
        """Whether the wire path runs error feedback under this spec."""
        c = self.host()
        return bool(c is not None and c.ef)


__all__ = ["CodecSpec", "WIRE_CODEC_NAMES", "wire_codecs"]
