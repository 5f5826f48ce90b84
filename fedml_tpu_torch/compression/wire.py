"""Host wire compressors (counterpart of
``fedml_tpu/compression/wire.py``, a numpy copy of it, byte for byte
under the same :func:`encode_rng`): the uplink's compressed report
format and the server's sparse fold of it.

The torch compressors (:mod:`.compressors`) run inside the simulated
round on the device; this module is their numpy twin for a real wire,
free to exploit what the binary codec can frame and device storage
cannot: sub-byte code packing. Both are named by the round program's
codec leg (``program/codec.py`` ``CodecSpec.device()``/``.host()``).

A compressed report replaces ``params`` with ``cdelta`` (the encoded
pytree of the client's EF-compressed update delta) and ``compressor``
(its spec), and keeps ``round`` as the delta's BASE reference. Error
feedback runs for the biased contractions (topk, signsgd); qsgd is
unbiased stochastic rounding and runs WITHOUT feedback (``HostQSGD.ef =
False``): feedback around a wide-cell unbiased quantizer grows its
residual, and with it the next scale, exponentially.

Encoded leaf schemas (numpy values; ``shape``/``dtype`` ride the frame's
JSON header as plain scalars):

- qsgd:    ``{"qp": uint8 bit-packed codes, "scale": f32[], "bits": B,
             "shape": [...], "dtype": name}``; bare ``qsgd`` is B=2 here
  (ternary codes), where the device compressor stores int8 codes.
- topk:    ``{"values": f32[k], "indices": int32[k] (sorted), "shape",
             "dtype"}``, k = ceil(ratio * size).
- signsgd: ``{"sign": bool[...], "scale": f32[], "dtype"}`` (the codec
  bit-packs the signs).

The server folds a :class:`CompressedUpdate` into the shared fp64
accumulator without densifying it (O(k) a topk report), and the
canonical fold adds each distinct BASE once, scaled by its entries'
weight sum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

#: report-message keys of the compressed schema
WIRE_DELTA_KEY = "cdelta"
WIRE_SPEC_KEY = "compressor"


def pack_codes(codes, bits: int) -> np.ndarray:
    """Signed codes in ``[-L, L]`` (``L = 2^(bits-1) - 1``) -> uint8
    array of ``ceil(n * bits / 8)`` bytes (offset-binary, big-endian bit
    order). ``bits == 8`` passes through as the two's-complement byte.

    The even widths (2/4 bits: 4 or 2 codes per byte) pack by shifts
    over the flat uint8 array, faster than the generic ``unpackbits``
    matrix walk the odd widths keep; both produce identical bytes."""
    codes = np.asarray(codes)
    if bits == 8:
        return codes.astype(np.int8).view(np.uint8).reshape(-1)
    levels = 2 ** (bits - 1) - 1
    u = (codes.reshape(-1).astype(np.int16) + levels).astype(np.uint8)
    if bits in (2, 4):
        per = 8 // bits
        pad = (-len(u)) % per
        if pad:
            u = np.concatenate([u, np.zeros(pad, np.uint8)])
        m = u.reshape(-1, per)
        out = np.zeros(len(m), np.uint8)
        for j in range(per):  # big-endian bit order, MSB field first
            out |= m[:, j] << (8 - bits * (j + 1))
        return out
    bitmat = np.unpackbits(u[:, None], axis=1)[:, 8 - bits:]
    return np.packbits(bitmat.reshape(-1))


def unpack_codes(packed, n: int, bits: int) -> np.ndarray:
    """Inverse of :func:`pack_codes`: first ``n`` codes as int8."""
    packed = np.asarray(packed, np.uint8)
    if bits == 8:
        return packed.view(np.int8)[:n].copy()
    levels = 2 ** (bits - 1) - 1
    if bits in (2, 4):
        per = 8 // bits
        mask = (1 << bits) - 1
        shifts = [8 - bits * (j + 1) for j in range(per)]
        m = np.empty((len(packed), per), np.uint8)
        for j, s in enumerate(shifts):
            m[:, j] = (packed >> s) & mask
        u = m.reshape(-1)[:n]
        return (u.astype(np.int16) - levels).astype(np.int8)
    bitmat = np.unpackbits(packed, count=n * bits).reshape(n, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    u = bitmat.astype(np.int16) @ weights.astype(np.int16)
    return (u - levels).astype(np.int8)


def packed_nbytes(size: int, bits: int) -> int:
    return (size * bits + 7) // 8


class HostCompressor:
    """Per-leaf numpy ``encode``/``decode`` lifted over flat param dicts
    (the control plane's payloads are ``{name: ndarray}``; nested
    pytrees are not needed on this path)."""

    name = "none"
    spec = "none"
    #: whether :func:`ef_step` accumulates an error-feedback residual
    #: through this compressor. True for biased contractions (topk,
    #: signsgd -- EF is what makes them converge); False for unbiased
    #: quantizers (qsgd -- feedback amplifies their variance into an
    #: exponentially growing residual, see the module docstring).
    ef = True

    def encode_leaf(self, x, rng):  # pragma: no cover - interface
        raise NotImplementedError

    def decode_leaf(self, enc):  # pragma: no cover - interface
        raise NotImplementedError

    def fold_leaf(self, acc, enc, scale: float):
        """Accumulate ``scale * float64(decode_leaf(enc))`` into the f64
        array ``acc`` in place. Subclasses override where the decoded
        form is sparse (topk: O(k), never densified)."""
        acc += float(scale) * self.decode_leaf(enc).astype(np.float64)

    def encode(self, tree, rng):
        return {k: self.encode_leaf(np.asarray(tree[k], np.float32), rng)
                for k in sorted(tree)}

    def decode(self, enc_tree):
        return {k: self.decode_leaf(enc_tree[k]) for k in sorted(enc_tree)}

    def __repr__(self):
        return f"{type(self).__name__}({self.spec!r})"


class HostQSGD(HostCompressor):
    """Stochastic uniform quantization, bit-packed at the code width.

    ``bits`` in [2, 8]; levels = ``2^(bits-1) - 1``. Unlike the device
    compressor (int8 storage either way), the wire packs codes at
    exactly ``bits`` bits per element, so the bare ``qsgd`` wire spec
    defaults to 2 -- ternary {-1, 0, +1} codes (the TernGrad regime).
    Unbiased by stochastic rounding, so it runs WITHOUT error feedback
    (``ef = False``; see the module docstring for the
    instability feedback causes here)."""

    name = "qsgd"
    ef = False

    def __init__(self, bits=2):
        if not 2 <= int(bits) <= 8:
            raise ValueError(f"qsgd bits must be in [2, 8], got {bits}")
        self.bits = int(bits)
        self.levels = 2 ** (self.bits - 1) - 1
        self.spec = f"qsgd:{self.bits}"

    def encode_leaf(self, x, rng):
        scale = float(np.max(np.abs(x))) if x.size else 0.0
        safe = max(scale, 1e-30)
        # f32 throughout: the quantizer's correctness is its value range
        # (stochastic rounding stays unbiased given the scale)
        y = x.astype(np.float32) * np.float32(self.levels / safe)
        noise = rng.random(x.shape, dtype=np.float32)
        q = np.clip(np.floor(y + noise),
                    -self.levels, self.levels).astype(np.int8)
        return {"qp": pack_codes(q, self.bits),
                "scale": np.float32(scale), "bits": self.bits,
                "shape": [int(d) for d in x.shape], "dtype": str(x.dtype)}

    def decode_leaf(self, enc):
        shape = tuple(enc["shape"])
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        bits = int(enc["bits"])
        levels = 2 ** (bits - 1) - 1
        q = unpack_codes(np.asarray(enc["qp"]), size, bits)
        y = q.astype(np.float32) * (np.float32(enc["scale"])
                                    / np.float32(levels))
        return y.reshape(shape).astype(enc["dtype"])


class HostTopK(HostCompressor):
    """Magnitude top-k sparsification; indices sorted ascending (one
    canonical encoded form, and the sparse fold walks memory in order)."""

    name = "topk"

    def __init__(self, ratio=0.01):
        if not 0 < ratio <= 1:
            raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")
        self.ratio = float(ratio)
        self.spec = f"topk:{self.ratio}"

    def encode_leaf(self, x, rng):
        del rng
        flat = x.reshape(-1)
        k = max(1, int(math.ceil(self.ratio * max(flat.size, 1))))
        if k >= flat.size:
            idx = np.arange(flat.size, dtype=np.int32)
        else:
            idx = np.sort(np.argpartition(np.abs(flat), -k)[-k:]
                          ).astype(np.int32)
        return {"values": flat[idx].astype(np.float32), "indices": idx,
                "shape": [int(d) for d in x.shape], "dtype": str(x.dtype)}

    def decode_leaf(self, enc):
        shape = tuple(enc["shape"])
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        flat = np.zeros(size, enc["dtype"])
        flat[np.asarray(enc["indices"])] = np.asarray(
            enc["values"]).astype(enc["dtype"])
        return flat.reshape(shape)

    def fold_leaf(self, acc, enc, scale: float):
        # O(k): only the kept coordinates touch the accumulator -- the
        # decoded update is zeros elsewhere, so this IS
        # scale * f64(decode), never densified per report
        vals = np.asarray(enc["values"]).astype(
            enc["dtype"]).astype(np.float64)
        np.add.at(acc.reshape(-1), np.asarray(enc["indices"]),
                  float(scale) * vals)


class HostSignSGD(HostCompressor):
    """1-bit sign + per-leaf mean-|x| magnitude; the codec bit-packs the
    bool sign array to 1 bit/element on the wire."""

    name = "signsgd"
    spec = "signsgd"

    def encode_leaf(self, x, rng):
        del rng
        return {"sign": x >= 0,
                "scale": np.float32(np.mean(np.abs(x)) if x.size else 0.0),
                "dtype": str(x.dtype)}

    def decode_leaf(self, enc):
        sign = np.asarray(enc["sign"])
        scale = np.float32(enc["scale"])
        return np.where(sign, scale, -scale).astype(enc["dtype"])


_HOST_REGISTRY = {"qsgd": HostQSGD, "topk": HostTopK,
                  "signsgd": HostSignSGD}


def host_compressor(spec):
    """Spec string -> host compressor (``None``/``none``/empty -> None:
    the caller keeps the plain-``params`` report -- there is no identity
    wire transform, by design).

    Grammar matches :func:`.compressors.get_compressor` (``qsgd:4``,
    ``topk:0.01``, ``signsgd``) with one documented divergence: bare
    ``qsgd`` defaults to 2 bits here (the wire packs sub-byte codes, so
    narrow widths finally buy bytes) while the device compressor's
    int8-storage default stays 8."""
    if spec is None or isinstance(spec, HostCompressor):
        return spec
    s = str(spec).strip().lower()
    if not s or s in ("0", "off", "false", "none"):
        return None
    name, _, arg = s.partition(":")
    if name == "randk":
        raise ValueError("randk is a sim-only compressor (unbiased "
                         "sparsification needs the shared rng stream); "
                         "use topk on the wire")
    if name not in _HOST_REGISTRY:
        raise ValueError(f"unknown wire compressor {name!r} "
                         f"(known: {sorted(_HOST_REGISTRY)})")
    cls = _HOST_REGISTRY[name]
    if not arg:
        return cls()
    if name == "topk":
        return cls(ratio=float(arg))
    if name == "qsgd":
        return cls(bits=int(arg))
    raise ValueError(f"wire compressor {name!r} takes no argument "
                     f"(got {arg!r})")


def encode_rng(seed_tuple) -> np.random.Generator:
    """The one seeded stream rule for wire encodes: keyed (never
    sequential) on ``(rank, round/version, attempt)`` so two runs over
    the same schedule encode bit-identically regardless of thread
    timing."""
    return np.random.default_rng((0x5EED, *map(int, seed_tuple)))


def ef_step(compressor: HostCompressor, delta, residual, rng):
    """One uplink compression step over flat param dicts (numpy). For
    EF compressors (``compressor.ef``, the biased contractions):
    ``enc = encode(delta + residual)``, ``decoded`` is the server's view,
    ``residual' = (delta + residual) - decoded``; ``residual`` of None
    means a zero accumulator (first report of this client). For unbiased
    compressors (qsgd): ``enc = encode(delta)`` and the returned residual
    is always None -- feedback deliberately off (module docstring)."""
    if not compressor.ef:
        enc = compressor.encode(
            {k: np.asarray(delta[k], np.float32) for k in sorted(delta)},
            rng)
        return enc, compressor.decode(enc), None
    comp_in = {k: np.asarray(delta[k], np.float32)
               + (np.float32(0) if residual is None
                  else residual[k]) for k in sorted(delta)}
    enc = compressor.encode(comp_in, rng)
    decoded = compressor.decode(enc)
    new_residual = {k: comp_in[k] - decoded[k] for k in comp_in}
    return enc, decoded, new_residual


@dataclass(frozen=True)
class CompressedUpdate:
    """A compressed report's payload as the fold sees it: the encoded
    delta plus the BASE params it is relative to (resolved by the server
    from the round/version the client reported against).

    :func:`~fedml_tpu_torch.program.aggregation.fold_entries_fp64` folds these
    without densifying: each entry contributes
    ``scale * float64(decode(enc))`` into the shared f64 accumulator
    (O(k) for topk), and each DISTINCT base contributes
    ``(sum of its entries' scales) * float64(base)`` exactly once, in
    sorted ``base_key`` order -- so the fold stays sorted-key
    deterministic and the async oracle (decay 0, one shared base per
    window) still equals the synchronous fold bitwise.
    """

    enc: dict
    spec: str
    base: dict
    base_key: int = 0
    _comp: HostCompressor = field(default=None, compare=False, repr=False)

    def compressor(self) -> HostCompressor:
        c = self._comp or host_compressor(self.spec)
        if c is None:
            raise ValueError(f"CompressedUpdate with a plain spec "
                             f"{self.spec!r}")
        return c

    def fold_delta(self, acc, scale: float):
        """Accumulate this entry's decoded-delta contribution into
        ``acc`` (``{name: float64 ndarray}``; None allocates zeros from
        the base's shapes) and return it."""
        if acc is None:
            acc = {k: np.zeros(np.shape(self.base[k]), np.float64)
                   for k in sorted(self.base)}
        comp = self.compressor()
        for k in sorted(self.enc):
            comp.fold_leaf(acc[k], self.enc[k], scale)
        return acc


def wire_payload_nbytes(compressor, template) -> int:
    """Exact on-wire bytes of one compressed report's ``cdelta`` section
    through the binary codec, computed from the template's shapes alone
    (encode a zero update -- sizes are shape-static). The uncompressed
    floor is :func:`tree_wire_nbytes` of the raw template."""
    from fedml_tpu_torch.compression.codec import tree_wire_nbytes

    zeros = {k: np.zeros(np.shape(v), np.float32)
             for k, v in template.items()}
    enc = compressor.encode(zeros, encode_rng((0, 0, 0)))
    return tree_wire_nbytes(enc)


__all__ = ["WIRE_DELTA_KEY", "WIRE_SPEC_KEY", "HostCompressor", "HostQSGD",
           "HostTopK", "HostSignSGD", "host_compressor", "encode_rng",
           "ef_step", "CompressedUpdate", "pack_codes", "unpack_codes",
           "packed_nbytes", "wire_payload_nbytes"]
