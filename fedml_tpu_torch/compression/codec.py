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

Message frame = a tree frame of the message's ``msg_params``. 0x9E cannot
start a JSON document, so ``message_from_wire`` dispatches on the first
byte: legacy peers sending ``Message.to_json()`` frames keep working. No
pickle anywhere -- the payload is data, never code.

This module imports numpy only (torch lazily, for a bf16 frame; the
``Message`` class lazily, for the envelope).
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


# -- Message envelope ---------------------------------------------------------

def message_to_wire(msg) -> bytes:
    """``Message`` -> binary frame: JSON control header, binary arrays."""
    return encode_tree(msg.get_params())


def message_to_wire_views(msg) -> list:
    """``Message`` -> list of wire buffers (zero-copy array payloads);
    ``b"".join(...)`` of the list equals :func:`message_to_wire`."""
    return encode_tree_views(msg.get_params())


def _message_from_params(message_cls, params):
    msg = message_cls()
    msg.init(params)
    msg.type = str(params[message_cls.MSG_ARG_KEY_TYPE])
    msg.sender_id = params[message_cls.MSG_ARG_KEY_SENDER]
    msg.receiver_id = params[message_cls.MSG_ARG_KEY_RECEIVER]
    return msg


def _is_binary(data) -> bool:
    """First-byte sniff (0x9E cannot start a JSON document), for any
    bytes-like ``data``; str (legacy JSON text) is never binary."""
    if isinstance(data, str):
        return False
    return len(data) >= 1 and data[0] == MAGIC


def message_from_wire(data):
    """Binary OR legacy-JSON frame -> ``Message`` (first-byte sniff: 0x9E
    is the binary magic and cannot start a JSON document). Accepts
    ``bytes`` | ``bytearray`` | ``memoryview`` | ``str``; binary tensor
    payloads alias ``data`` (see :func:`decode_array`)."""
    from fedml_tpu_torch.core.message import Message
    if _is_binary(data):
        return _message_from_params(Message, decode_tree(data))
    msg = Message()
    msg.init_from_json_string(
        data if isinstance(data, str) else bytes(data).decode())
    return msg


def message_from_header(header, data, offset):
    """Second half of a split decode: ``parse_wire_header`` gave
    ``(header, offset)``; this decodes the array frames from ``offset``
    and builds the ``Message`` -- the header JSON is parsed exactly
    once per frame even when the caller routed on it first."""
    from fedml_tpu_torch.core.message import Message
    arrays = []
    off = offset
    while off < len(data):
        arr, off = decode_array(data, off)
        arrays.append(arr)
    return _message_from_params(Message, _restore(header, arrays))


def peek_wire_envelope(data):
    """``(type, sender, receiver)`` of a frame WITHOUT decoding any
    array payload: binary frames parse only the JSON control header;
    legacy JSON frames (tiny control messages) parse whole. The hubs'
    relay path routes on this and re-queues the raw frame -- the
    destination, not the relay, validates the payload."""
    from fedml_tpu_torch.core.message import Message
    if _is_binary(data):
        header, _ = parse_wire_header(data)
    else:
        header = json.loads(
            data if isinstance(data, str) else bytes(data).decode())
    return (str(header[Message.MSG_ARG_KEY_TYPE]),
            header[Message.MSG_ARG_KEY_SENDER],
            header[Message.MSG_ARG_KEY_RECEIVER])


#: Exception types one undecodable frame can raise -- the concrete
#: failure set the transports catch (a malformed peer must cost one
#: connection, never the decode stage or a serve thread).
DECODE_ERRORS = (ValueError, KeyError, IndexError, TypeError,
                 struct.error, UnicodeDecodeError)


def decode_frames(frames):
    """Batch decode: one pass over a chunk of wire frames -> a list
    aligned with ``frames`` holding ``Message`` objects, with
    undecodable frames carried as their exception instance (the caller
    decides the peer's fate; one bad frame must not poison the chunk).
    Amortizes the per-frame import/dispatch overhead the event-loop
    dispatcher used to pay once per frame, and every tensor payload
    aliases its frame buffer (zero-copy decode)."""
    from fedml_tpu_torch.core.message import Message
    out = []
    for data in frames:
        try:
            if _is_binary(data):
                msg = _message_from_params(Message, decode_tree(data))
            else:
                msg = Message()
                msg.init_from_json_string(
                    data if isinstance(data, str)
                    else bytes(data).decode())
        except DECODE_ERRORS as e:
            out.append(e)
            continue
        out.append(msg)
    return out


__all__ = ["MAGIC", "VERSION", "encode_array", "encode_array_views",
           "decode_array", "encode_tree", "encode_tree_views",
           "decode_tree", "array_wire_nbytes", "tree_wire_nbytes",
           "message_to_wire", "message_to_wire_views",
           "message_from_wire", "message_from_header",
           "parse_wire_header", "peek_wire_envelope", "decode_frames",
           "DECODE_ERRORS"]
