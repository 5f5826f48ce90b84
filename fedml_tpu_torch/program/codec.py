"""Codec leg of a ``RoundProgram`` (counterpart of
``fedml_tpu/program/codec.py``): the spec string that names a
client-update compressor. Only the disabled leg (``"none"``, None, the
empty string, ``"0"``, ``"off"``, ``"false"``) is ported; a compressor
spec raises until ROADMAP A12."""

from __future__ import annotations

from dataclasses import dataclass

_DISABLED = ("", "0", "off", "false", "none")


@dataclass(frozen=True)
class CodecSpec:
    """Compressor selection of one program; ``spec`` is the reference's
    grammar (``"qsgd:4"``, ``"topk:0.01"``, ``"signsgd"``, ``"none"``)."""

    spec: str = "none"

    def __post_init__(self):
        if self.enabled:
            raise NotImplementedError(
                f"compressor {self.spec!r} waits for ROADMAP A12 "
                "(compression)")

    @classmethod
    def coerce(cls, spec) -> "CodecSpec":
        """None, a spec string or a CodecSpec -> CodecSpec."""
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


__all__ = ["CodecSpec"]
