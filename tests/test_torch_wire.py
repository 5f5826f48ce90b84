"""The port's wire codec and its numpy wire twin against the reference's
(``fedml_tpu_torch/compression/{codec,wire}.py`` against
``fedml_tpu/compression/{codec,wire}.py``), and the port's drift gate
between its torch compressors and its wire twin.

Tolerances: every frame is byte-equal both ways (each package decodes
the other's frames, bf16 included); the wire twin is byte-equal under
the same ``encode_rng`` (qsgd's stochastic codes included), with equal
decodes and residuals. The drift gate is the reference's
(``tests/test_wire_drift.py``): topk decodes and kept index sets equal,
signsgd signs equal and its mean-|x| scale and decode within 4 ulp (two
reductions in another order), qsgd's scale equal, the wire packing a
bitwise inverse over the device's codes, and decodes of shared codes
within 4 ulp."""

import importlib
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from fedml_tpu.compression import codec as jcodec
from fedml_tpu.compression import wire as jwire
from fedml_tpu.program import codec as jprog_codec
from fedml_tpu_torch.compression import codec
from fedml_tpu_torch.compression import wire
from fedml_tpu_torch.compression.compressors import get_compressor
from fedml_tpu_torch.program.codec import (CodecSpec, WIRE_CODEC_NAMES,
                                           wire_codecs)

DTYPES = ["float32", "float64", "float16", "bfloat16", "int8", "uint8",
          "int32", "int64", "bool"]


def _np_array(dtype, shape=(4, 9)):
    rng = np.random.default_rng(0)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype == "bfloat16":
        return rng.normal(size=shape).astype(ml_dtypes.bfloat16)
    if np.issubdtype(np.dtype(dtype), np.floating):
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(0, 100, shape).astype(dtype)


def _as_tensor(a):
    """A numpy array (bf16 through its words) as a CPU tensor."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _same(got, want):
    """``got`` (numpy or a bf16 tensor) holds ``want``'s dtype and
    values bit for bit."""
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, _as_tensor(np.asarray(want)))
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_array_frames_decode_across_packages(dtype):
    arr = _np_array(dtype)
    frame = jcodec.encode_array(arr)
    assert codec.encode_array(arr) == frame
    assert codec.encode_array(_as_tensor(arr)) == frame
    got, off = codec.decode_array(frame)
    assert off == len(frame)
    _same(got, arr)
    back, _ = jcodec.decode_array(codec.encode_array(_as_tensor(arr)))
    _same(back, arr)
    assert codec.array_wire_nbytes(arr.shape, _as_tensor(arr).dtype) == len(
        frame) == jcodec.array_wire_nbytes(arr.shape, arr.dtype)


@pytest.mark.parametrize("arr", [
    np.float32(3.5).reshape(()), np.zeros((0,), np.int32),
    np.zeros((2, 0, 3), np.float32),
    np.asarray(1.25, ml_dtypes.bfloat16).reshape(()),
    np.zeros((0, 4), ml_dtypes.bfloat16)], ids=lambda a: f"{a.dtype}{a.shape}")
def test_zero_dim_and_empty_frames(arr):
    frame = jcodec.encode_array(arr)
    assert codec.encode_array(_as_tensor(arr)) == frame
    got, _ = codec.decode_array(frame)
    _same(got, arr)


def _mixed_tree(as_tensor):
    conv = _as_tensor if as_tensor else (lambda a: a)
    return {"params": {"w": conv(np.arange(6, dtype=np.float32)
                                 .reshape(2, 3)),
                       "b": conv(np.ones(3, ml_dtypes.bfloat16))},
            "mask": conv(np.array([True, False, True])),
            "round": 7, "name": "cohort", "lst": [1, 2.5, "x"]}


def test_tree_frames_decode_across_packages():
    frame = jcodec.encode_tree(_mixed_tree(False))
    for as_tensor in (False, True):
        assert codec.encode_tree(_mixed_tree(as_tensor)) == frame
        assert b"".join(codec.encode_tree_views(
            _mixed_tree(as_tensor))) == frame
        assert codec.tree_wire_nbytes(_mixed_tree(as_tensor)) == len(frame)
    assert codec.parse_wire_header(frame) == jcodec.parse_wire_header(frame)
    got = codec.decode_tree(frame)
    want = _mixed_tree(False)
    _same(got["params"]["w"], want["params"]["w"])
    _same(got["params"]["b"], want["params"]["b"])
    _same(got["mask"], want["mask"])
    assert (got["round"], got["name"], got["lst"]) == (7, "cohort",
                                                       [1, 2.5, "x"])
    back = jcodec.decode_tree(codec.encode_tree(_mixed_tree(True)))
    _same(back["params"]["b"], want["params"]["b"])


def test_decode_aliases_the_buffer_read_only():
    arr = np.arange(12, dtype=np.float32)
    buf = bytearray(codec.encode_array(arr))
    got, _ = codec.decode_array(buf)
    assert not got.flags.writeable
    assert np.shares_memory(got, np.frombuffer(buf, np.uint8))
    with pytest.raises(ValueError):
        codec.decode_tree(bytes([0x9E, 99]) + codec.encode_tree({"a": 1})[2:])
    with pytest.raises(ValueError):
        codec.encode_tree({"__nd__": 3})


def test_codec_handles_bf16_with_ml_dtypes_hidden(monkeypatch):
    words = np.asarray([0x3F80, 0xC000, 0x0001, 0x7F7F], np.uint16)
    want = jcodec.encode_tree({"s": words.view(ml_dtypes.bfloat16)})
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    monkeypatch.delitem(sys.modules, "fedml_tpu_torch.compression.codec")
    fresh = importlib.import_module("fedml_tpu_torch.compression.codec")
    assert fresh is not codec
    t = torch.from_numpy(words.view(np.int16).copy()).view(torch.bfloat16)
    assert fresh.encode_tree({"s": t}) == want
    got = fresh.decode_tree(want)["s"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    assert fresh.tree_wire_nbytes({"s": t}) == len(want)


@pytest.mark.parametrize("name", ["message_to_wire", "message_from_wire",
                                  "message_from_header",
                                  "peek_wire_envelope", "decode_frames"])
def test_message_envelope_waits_for_a13(name):
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        getattr(codec, name)(b"")


# ---------------------------------------------------------------------------
# the wire twin
# ---------------------------------------------------------------------------
def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((24, 8)).astype(np.float32),
            "b": rng.standard_normal(24).astype(np.float32),
            "s": np.asarray(rng.standard_normal(), np.float32)}


@pytest.mark.parametrize("spec", wire_codecs())
def test_wire_twin_is_byte_equal(spec):
    comp, jcomp = wire.host_compressor(spec), jwire.host_compressor(spec)
    assert (comp.spec, comp.ef) == (jcomp.spec, jcomp.ef)
    residual = jresidual = None
    for rnd in range(3):
        delta = _leaves(rnd)
        enc, dec, residual = wire.ef_step(comp, delta, residual,
                                          wire.encode_rng((5, rnd, 0)))
        jenc, jdec, jresidual = jwire.ef_step(jcomp, delta, jresidual,
                                              jwire.encode_rng((5, rnd, 0)))
        assert codec.encode_tree(enc) == jcodec.encode_tree(jenc)
        for k in delta:
            np.testing.assert_array_equal(dec[k], jdec[k])
            if jresidual is None:
                assert residual is None
            else:
                np.testing.assert_array_equal(residual[k], jresidual[k])
    assert wire.wire_payload_nbytes(comp, _leaves(0)) == \
        jwire.wire_payload_nbytes(jcomp, _leaves(0))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 7, 8])
def test_code_packing_is_byte_equal(bits):
    L = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(bits)
    for n in (0, 1, 3, 17, 4097):
        codes = rng.integers(-L, L + 1, n).astype(np.int8)
        packed = wire.pack_codes(codes, bits)
        np.testing.assert_array_equal(packed, jwire.pack_codes(codes, bits))
        assert len(packed) == wire.packed_nbytes(n, bits)
        np.testing.assert_array_equal(wire.unpack_codes(packed, n, bits),
                                      codes)


@pytest.mark.parametrize("spec", [None, "", "none", "off", "0", "false",
                                  "qsgd", "qsgd:4", "QSGD:8", "topk",
                                  "topk:0.05", "signsgd", "randk:0.1",
                                  "zip", "qsgd:1", "signsgd:3"])
def test_host_compressor_grammar_is_the_reference_one(spec):
    def outcome(fn):
        try:
            c = fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))
        return None if c is None else (c.name, c.spec, c.ef)
    assert outcome(wire.host_compressor) == outcome(jwire.host_compressor)


def test_compressed_update_folds_its_delta_sparsely():
    base = {"w": np.random.default_rng(2).standard_normal(
        256).astype(np.float32)}
    comp = wire.host_compressor("topk:0.1")
    enc = comp.encode({"w": base["w"] * 0.5}, None)
    upd = wire.CompressedUpdate(enc=enc, spec=comp.spec, base=base)
    acc = upd.fold_delta(None, 2.5)
    np.testing.assert_array_equal(
        acc["w"], 2.5 * comp.decode(enc)["w"].astype(np.float64))
    assert (wire.WIRE_DELTA_KEY, wire.WIRE_SPEC_KEY) == (
        jwire.WIRE_DELTA_KEY, jwire.WIRE_SPEC_KEY)


# ---------------------------------------------------------------------------
# the port's drift gate: torch compressors against the wire twin
# ---------------------------------------------------------------------------
def _fuzz_leaves(seed, n=6):
    """Distinct-magnitude fp32 leaves (topk ties are the one legitimate
    divergence between ``torch.topk`` and ``argpartition``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.integers(5, 3000))
        x = rng.standard_normal(size).astype(np.float32)
        if len(np.unique(np.abs(x))) < size:
            x += rng.standard_normal(size).astype(np.float32) * 1e-4
        out.append(x)
    return out


def _dev_encode(comp, x, seed=0):
    return comp.encode(torch.from_numpy(x)[None], np.asarray([seed]))


def test_codec_tables_are_the_reference_ones():
    assert wire_codecs() == jprog_codec.wire_codecs()
    assert WIRE_CODEC_NAMES == jprog_codec.WIRE_CODEC_NAMES
    families = {s.partition(":")[0] for s in wire_codecs()}
    assert families == set(wire._HOST_REGISTRY) == set(WIRE_CODEC_NAMES)
    for spec in wire_codecs():
        cs, jcs = CodecSpec(spec), jprog_codec.CodecSpec(spec)
        assert cs.host().name == cs.device().name == cs.name == jcs.name
        assert cs.host_ef() == jcs.host_ef() == (cs.name in ("topk",
                                                             "signsgd"))
    assert get_compressor("randk:0.1") is not None
    with pytest.raises(ValueError, match="randk"):
        wire.host_compressor("randk:0.1")
    assert (wire.host_compressor("qsgd").bits,
            get_compressor("qsgd").bits) == (2, 8)


@pytest.mark.parametrize("ratio", [0.01, 0.25, 1.0])
def test_drift_topk_decode_byte_equal(ratio):
    dev = get_compressor(f"topk:{ratio}")
    host = wire.host_compressor(f"topk:{ratio}")
    for x in _fuzz_leaves(int(ratio * 100)):
        denc = _dev_encode(dev, x)
        de = dev.decode(denc, x.shape, torch.float32)[0].numpy()
        henc = host.encode_leaf(x, None)
        np.testing.assert_array_equal(de, host.decode_leaf(henc))
        assert (set(denc["indices"][0].tolist())
                == set(np.asarray(henc["indices"]).tolist()))


def test_drift_signsgd():
    dev, host = get_compressor("signsgd"), wire.host_compressor("signsgd")
    for x in _fuzz_leaves(7):
        denc, henc = _dev_encode(dev, x), host.encode_leaf(x, None)
        np.testing.assert_array_equal(denc["sign"][0].numpy(), henc["sign"])
        np.testing.assert_array_max_ulp(denc["scale"][0].numpy(),
                                        np.float32(henc["scale"]), maxulp=4)
        np.testing.assert_array_max_ulp(
            dev.decode(denc, x.shape, torch.float32)[0].numpy(),
            host.decode_leaf(henc), maxulp=4)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_drift_qsgd(bits):
    dev = get_compressor(f"qsgd:{bits}")
    host = wire.host_compressor(f"qsgd:{bits}")
    assert dev.levels == host.levels
    for t, x in enumerate(_fuzz_leaves(200 + bits)):
        denc = _dev_encode(dev, x, t)
        henc = host.encode_leaf(x, wire.encode_rng((t, 0, 0)))
        assert float(denc["scale"][0]) == float(np.float32(henc["scale"]))
        q = denc["q"][0].numpy()
        np.testing.assert_array_equal(
            wire.unpack_codes(wire.pack_codes(q, bits), q.size, bits), q)
        shared = {"qp": wire.pack_codes(q, bits),
                  "scale": np.float32(denc["scale"][0]), "bits": bits,
                  "shape": list(x.shape), "dtype": "float32"}
        np.testing.assert_array_max_ulp(
            dev.decode(denc, x.shape, torch.float32)[0].numpy(),
            host.decode_leaf(shared), maxulp=4)
