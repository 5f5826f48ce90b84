"""The port's message envelope against the reference's
(``fedml_tpu_torch/core/message.py`` and the envelope half of
``compression/codec.py`` against ``fedml_tpu/core/message.py`` and
``fedml_tpu/compression/codec.py``).

Tolerances: none. ``Message.to_bytes`` frames are byte-equal for fp32
params, bf16 params (a ``torch.bfloat16`` tensor against the reference's
``ml_dtypes`` array of the same words), a compressed update delta and a
``__trace__`` context; each package decodes the other's frames to equal
values; the legacy JSON codec and ``params_to_lists`` /
``lists_to_params`` give equal results."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from fedml_tpu.compression import wire as jwire
from fedml_tpu.core import message as jmessage
from fedml_tpu.observability.tracing import SpanContext as JSpanContext
from fedml_tpu.observability.tracing import Tracer as JTracer
from fedml_tpu_torch.compression import wire
from fedml_tpu_torch.core import message
from fedml_tpu_torch.observability.tracing import SpanContext, Tracer

RNG = np.random.default_rng(0)
W = RNG.standard_normal((5, 7)).astype(np.float32)
B = RNG.standard_normal((7,)).astype(np.float32)
WORDS = (RNG.standard_normal((3, 4)).astype(np.float32).view(np.uint32)
         >> 16).astype(np.uint16)


def _bf16_port():
    return torch.from_numpy(WORDS.view(np.int16).copy()).view(torch.bfloat16)


def _topk_delta(mod):
    delta = {"b": B, "w": W}
    enc, _, _ = mod.ef_step(mod.host_compressor("topk:0.25"), delta, None,
                            mod.encode_rng((3, 1, 0)))
    return enc


def _fill(msg, case, port):
    """Add ``case``'s payload to ``msg`` (the port's tensors when
    ``port``, the reference's arrays otherwise)."""
    msg.add("round", 1)
    msg.add("attempt", 0)
    msg.add("num_samples", 30.0)
    if case == "fp32":
        msg.add("params", {"w": W, "b": B})
    elif case == "bf16":
        msg.add("params", {"h": _bf16_port() if port
                           else WORDS.view(ml_dtypes.bfloat16)})
    elif case == "compressed":
        msg.add("cdelta", _topk_delta(wire if port else jwire))
        msg.add("compressor", "topk:0.25")
    elif case == "trace":
        msg.add("params", {"w": W})
        ctx = (SpanContext if port else JSpanContext)(
            "0123456789abcdef", "fedcba9876543210")
        (Tracer() if port else JTracer()).inject(msg, ctx)
    return msg


CASES = ["fp32", "bf16", "compressed", "trace"]


def _pair(case):
    return (_fill(jmessage.Message("res_report", 2, 0), case, False),
            _fill(message.Message("res_report", 2, 0), case, True))


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
        return
    if hasattr(a, "detach"):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    if hasattr(b, "detach"):
        b = b.view(torch.int16).numpy() if b.dtype == torch.bfloat16 \
            else b.numpy()
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == ml_dtypes.bfloat16:
        a = a.view(np.int16)
    if b.dtype == ml_dtypes.bfloat16:
        b = b.view(np.int16)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_frames_are_byte_equal(case):
    ref, port = _pair(case)
    assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("case", CASES)
def test_each_side_decodes_the_others_frames(case):
    ref, port = _pair(case)
    from_ref = message.Message.from_bytes(ref.to_bytes())
    from_port = jmessage.Message.from_bytes(port.to_bytes())
    for got, want in ((from_ref, ref), (from_port, port)):
        assert (got.get_type(), got.get_sender_id(),
                got.get_receiver_id()) == ("res_report", 2, 0)
        for key in want.get_params():
            _equal_trees(want.get(key), got.get(key))
    if case == "bf16":
        assert from_ref.get("params")["h"].dtype == torch.bfloat16
    if case == "trace":
        assert Tracer.extract(from_port).span_id == "fedcba9876543210"
        ctx = Tracer.extract(from_ref)
        assert (ctx.trace_id, ctx.span_id) == ("0123456789abcdef",
                                               "fedcba9876543210")


def test_legacy_json_codec_is_equal():
    ref, port = _pair("fp32")
    assert port.to_json() == ref.to_json()
    back = message.Message.from_bytes(ref.to_json().encode())
    np.testing.assert_array_equal(np.asarray(back.get("params")["w"]),
                                  W.tolist())
    assert str(back) == str(ref)


def test_params_to_lists_and_back_are_equal():
    tree = {"b": {"z": B, "a": [W, np.float32(2.5)]}, "c": None,
            "t": (np.arange(3, dtype=np.int32),)}
    got = message.params_to_lists(tree)
    want = jmessage.params_to_lists(tree)
    assert json.dumps(got) == json.dumps(want)
    assert message.params_to_lists({"w": torch.from_numpy(W)}) == \
        jmessage.params_to_lists({"w": W})
    lists = {"w": W.tolist(), "n": {"b": B.tolist()}}
    _equal_trees(message.lists_to_params(lists),
                 jmessage.lists_to_params(lists))
