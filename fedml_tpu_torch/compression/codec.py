"""Binary wire codec for array payloads (counterpart of
``fedml_tpu/compression/codec.py``; its frames byte for byte): header +
dtype + shape + raw bytes.

Wire format (all integers big-endian):

  tree frame     = MAGIC(0x9E) VERSION(0x01) hdr_len:u32 hdr_json arrays*
  hdr_json       = the tree with every array leaf replaced by
                   {"__nd__": i} (i = position in the arrays section)
  array frame    = name_len:u8 dtype_name ndim:u8 (dim:u32)*ndim
                   nbytes:u32 payload
  payload        = C-order little-endian raw bytes; bool arrays are
                   bit-packed (np.packbits -- 1 bit/element on the wire)

Leaves may be numpy arrays or torch tensors (CPU or CUDA; a tensor moves
to the host once). ``bfloat16`` is a wire dtype without ``ml_dtypes``: a
``torch.bfloat16`` tensor (or a numpy array whose dtype is named
``bfloat16``) is framed from its raw 2-byte words, and a ``bfloat16``
frame decodes to a ``torch.bfloat16`` tensor through ``torch.frombuffer``
-- never widened. Every other frame decodes to a numpy array that, for
a native little-endian dtype, aliases the buffer read-only.

This module imports numpy only (torch lazily, for a bf16 frame). The
message envelope (``message_to_wire`` and its kin) needs ``core/message``,
which waits for ROADMAP A13.
"""

from __future__ import annotations

import json
import struct
import sys

import numpy as np

MAGIC = 0x9E
VERSION = 1
_HDR_LEN = struct.Struct("!I")
_DIM = struct.Struct("!I")
_ND_KEY = "__nd__"
_BF16 = "bfloat16"


def _resolve_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"codec: unknown wire dtype {name!r}") from None


def _is_tensor(x) -> bool:
    """A torch tensor, recognised without importing torch."""
    return type(x).__module__.startswith("torch") and hasattr(x, "detach")


def _wire_name(dtype) -> str:
    """The wire's dtype name of a numpy or torch dtype."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else np.dtype(
        dtype).name


def _host(x):
    """Any array-ish (numpy, torch on any device, memoryview) -> ``(a,
    name)``: a C-contiguous host ndarray and its wire dtype name. A bf16
    leaf comes back as its raw uint16 words under the name ``bfloat16``."""
    if _is_tensor(x):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        name = _wire_name(t.dtype)
        if name == _BF16:
            import torch
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.asarray(x)
    if a.dtype == object:
        raise TypeError("codec: object arrays are not wire-serializable")
    if not a.flags.c_contiguous:  # 0-d is always contiguous
        a = np.ascontiguousarray(a)
    if a.dtype.name == _BF16:  # an ml_dtypes array, read as its words
        return a.view(np.uint16), _BF16
    return a, a.dtype.name


def _itemsize(name: str) -> int:
    return 2 if name == _BF16 else _resolve_dtype(name).itemsize


def array_wire_nbytes(shape, dtype) -> int:
    """Exact on-wire size of one array frame (header + payload); ``dtype``
    a numpy or torch dtype."""
    name = _wire_name(dtype)
    size = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    payload = (size + 7) // 8 if name == "bool" else size * _itemsize(name)
    return (1 + len(name.encode("ascii")) + 1 + _DIM.size * len(shape)
            + _DIM.size + payload)


def encode_array_views(x) -> list:
    """Array frame as ``[header_bytes, payload_buffer]``. The payload is a
    read-only ``memoryview`` over the host array whenever its layout is
    the wire's (C-contiguous, little-endian, not bool); bools bit-pack,
    byte-swaps and exotic layouts copy once. A view aliases the caller's
    array until the bytes are written."""
    a, name = _host(x)
    if a.dtype.itemsize > 1 and (
            a.dtype.byteorder == ">"
            or (a.dtype.byteorder == "=" and sys.byteorder == "big")):
        a = a.byteswap().view(a.dtype.newbyteorder("<"))
    if name == "bool":
        payload = np.packbits(a.reshape(-1)).data.cast("B")
    else:
        try:
            payload = a.data.cast("B")  # zero-copy: aliases the array
        except (ValueError, TypeError, BufferError):
            payload = a.tobytes()
    bname = name.encode("ascii")
    parts = [struct.pack("!B", len(bname)), bname,
             struct.pack("!B", a.ndim)]
    parts += [_DIM.pack(d) for d in a.shape]
    parts.append(_DIM.pack(len(payload)))
    return [b"".join(parts), payload]


def encode_array(x) -> bytes:
    return b"".join(encode_array_views(x))


def _decode_bf16(buf, offset, nbytes, shape):
    """A ``bfloat16`` payload -> a ``torch.bfloat16`` tensor (a copy)."""
    import torch

    raw = bytearray(buf[offset:offset + nbytes])
    if sys.byteorder == "big":
        raw = bytearray(np.frombuffer(raw, "<u2").astype(np.uint16)
                        .tobytes())
    if not raw:
        return torch.zeros(shape, dtype=torch.bfloat16)
    return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(shape)


def decode_array(buf, offset: int = 0):
    """Decode one array frame at ``offset``; returns ``(array,
    new_offset)``. ``buf`` may be ``bytes``, ``bytearray`` or a
    ``memoryview``. A native little-endian payload comes back as an
    ``np.frombuffer`` view that aliases ``buf`` (read-only when ``buf`` is
    mutable); bools, bf16 and big-endian hosts copy once."""
    (nlen,) = struct.unpack_from("!B", buf, offset)
    offset += 1
    name = bytes(buf[offset:offset + nlen]).decode("ascii")
    offset += nlen
    (ndim,) = struct.unpack_from("!B", buf, offset)
    offset += 1
    shape = []
    for _ in range(ndim):
        (d,) = _DIM.unpack_from(buf, offset)
        shape.append(d)
        offset += _DIM.size
    (nbytes,) = _DIM.unpack_from(buf, offset)
    offset += _DIM.size
    if len(buf) - offset < nbytes:
        raise ValueError("codec: truncated array payload")
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if name == _BF16:
        if nbytes != 2 * size:
            raise ValueError("codec: array payload size mismatch")
        return _decode_bf16(buf, offset, nbytes, shape), offset + nbytes
    dt = _resolve_dtype(name)
    if dt == np.bool_:
        bits = np.unpackbits(
            np.frombuffer(buf, np.uint8, count=nbytes, offset=offset),
            count=size)
        arr = bits.astype(np.bool_).reshape(shape)
    elif sys.byteorder == "big" and dt.itemsize > 1:
        arr = np.frombuffer(bytes(buf[offset:offset + nbytes]),
                            dt).byteswap().reshape(shape)
    else:
        if nbytes != size * dt.itemsize:
            raise ValueError("codec: array payload size mismatch")
        arr = np.frombuffer(buf, dt, count=size, offset=offset)
        if arr.flags.writeable:
            # aliases a mutable receive buffer: freeze the view
            arr.flags.writeable = False
        arr = arr.reshape(shape)
    return arr, offset + nbytes


def _is_array(v) -> bool:
    """Anything with a dtype and a shape goes binary, 0-d included;
    Python scalars and numpy scalar types stay JSON."""
    if isinstance(v, (str, bytes, np.generic)):
        return False
    if isinstance(v, np.ndarray) or _is_tensor(v):
        return True
    return (hasattr(v, "__array__") and hasattr(v, "dtype")
            and hasattr(v, "shape"))


def _extract(value, arrays: list):
    """Replace every array leaf with a ``{"__nd__": i}`` marker,
    collecting the arrays in walk order."""
    if _is_array(value):
        arrays.append(value)
        return {_ND_KEY: len(arrays) - 1}
    if isinstance(value, dict):
        if _ND_KEY in value:
            raise ValueError(f"codec: payload dict key {_ND_KEY!r} is "
                             "reserved for array markers")
        return {k: _extract(v, arrays) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_extract(v, arrays) for v in value]
    if hasattr(value, "item") and getattr(value, "ndim", None) == 0:
        return value.item()
    return value


def _restore(value, arrays: list):
    if isinstance(value, dict):
        if set(value.keys()) == {_ND_KEY}:
            return arrays[value[_ND_KEY]]
        return {k: _restore(v, arrays) for k, v in value.items()}
    if isinstance(value, list):
        return [_restore(v, arrays) for v in value]
    return value


def encode_tree_views(tree) -> list:
    """Tree -> list of wire buffers whose concatenation is
    :func:`encode_tree`'s output (array payloads stay views)."""
    arrays: list = []
    header = json.dumps(_extract(tree, arrays), sort_keys=True).encode()
    views = [bytes((MAGIC, VERSION)) + _HDR_LEN.pack(len(header)) + header]
    for a in arrays:
        views.extend(encode_array_views(a))
    return views


def encode_tree(tree) -> bytes:
    """Tree (nested dict/list/tuple of arrays and scalars) -> wire bytes,
    each payload copied once."""
    return b"".join(encode_tree_views(tree))


def parse_wire_header(data):
    """The JSON control header of a binary frame: ``(header, offset)``,
    markers in place, ``offset`` where the array frames begin."""
    if len(data) < 2 or data[0] != MAGIC:
        raise ValueError("codec: not a binary tree frame")
    if data[1] != VERSION:
        raise ValueError(f"codec: unsupported wire version {data[1]}")
    (hlen,) = _HDR_LEN.unpack_from(data, 2)
    off = 2 + _HDR_LEN.size
    header = json.loads(bytes(data[off:off + hlen]).decode())
    return header, off + hlen


def decode_tree(data):
    """Inverse of :func:`encode_tree`; accepts ``bytes``, ``bytearray``
    or ``memoryview`` (array payloads alias it, see
    :func:`decode_array`)."""
    header, off = parse_wire_header(data)
    arrays = []
    while off < len(data):
        arr, off = decode_array(data, off)
        arrays.append(arr)
    return _restore(header, arrays)


def tree_wire_nbytes(tree) -> int:
    """On-wire size of :func:`encode_tree` without building the bytes:
    leaves may be arrays, tensors (``meta`` ones too) or anything with
    ``.shape`` and ``.dtype``."""
    arrays: list = []

    def walk(v):
        if _is_array(v) or (hasattr(v, "shape") and hasattr(v, "dtype")
                            and not isinstance(v, (str, bytes,
                                                   np.generic))):
            arrays.append(v)
            return {_ND_KEY: len(arrays) - 1}
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [walk(x) for x in v]
        if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
            return v.item()
        return v

    header = json.dumps(walk(tree), sort_keys=True).encode()
    n = 2 + _HDR_LEN.size + len(header)
    for a in arrays:
        n += array_wire_nbytes(tuple(a.shape), a.dtype)
    return n


# -- the message envelope ------------------------------------------------------
_A13 = "ROADMAP A13 (the distributed control plane's Message)"


def _needs_message(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} waits for {_A13}")
    fn.__name__ = name
    fn.__doc__ = f"The reference's ``{name}``: waits for {_A13}."
    return fn


message_to_wire = _needs_message("message_to_wire")
message_to_wire_views = _needs_message("message_to_wire_views")
message_from_wire = _needs_message("message_from_wire")
message_from_header = _needs_message("message_from_header")
peek_wire_envelope = _needs_message("peek_wire_envelope")
decode_frames = _needs_message("decode_frames")

#: exception types one undecodable frame can raise
DECODE_ERRORS = (ValueError, KeyError, IndexError, TypeError,
                 struct.error, UnicodeDecodeError)


__all__ = ["MAGIC", "VERSION", "encode_array", "encode_array_views",
           "decode_array", "encode_tree", "encode_tree_views",
           "decode_tree", "array_wire_nbytes", "tree_wire_nbytes",
           "message_to_wire", "message_to_wire_views",
           "message_from_wire", "message_from_header",
           "parse_wire_header", "peek_wire_envelope", "decode_frames",
           "DECODE_ERRORS"]
