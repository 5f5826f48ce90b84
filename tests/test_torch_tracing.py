"""Round tracing of the port against the JAX package.

One round of each ported path -- packed lanes (``wave_mode=3``) on a
depth-8 ResNet at 8x8, 4 clients on 2 lanes, and the bucketed path on a
one-layer TransformerLM (d_model 32, T 16), 8 clients in chunks of 4 --
emits the same ordered span tree as the JAX ``FedAvgAPI`` on the same
configuration: names, nesting and attributes, children in the order they
started. The JAX side runs under its own ``Tracer`` with the numpy
packing backend (``FEDML_TPU_PACKING=python``), so schedules, trips and
bucket edges are byte-equal. With the default ``NoopTracer`` a round
computes bit for bit what it computes under a real ``Tracer``. The
tracing module itself behaves as the reference's on a nested scenario,
and ``profile_trace`` writes a Chrome trace."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import (
    make_classification_spec as jax_spec)
from fedml_tpu.algorithms.specs import (
    make_seq_classification_spec as jax_seq_spec)
from fedml_tpu.data.synthetic import load_synthetic_images
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.observability import tracing as jtracing
from fedml_tpu_torch import bench as bench_port
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import (make_classification_spec,
                                              make_seq_classification_spec)
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.observability import tracing
from fedml_tpu_torch.utils.profiling import profile_trace

DEPTH, H, T, V = 8, 8, 16, 90


def _packed_args():
    return types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=1,
        epochs=1, batch_size=16, lr=0.05, wd=0.001, client_optimizer="sgd",
        frequency_of_the_test=10 ** 9, seed=0, client_chunk=2, wave_mode=3,
        device_resident="auto", device_data_cap_gb=1.0, device_dtype=None)


def _bucketed_args():
    return types.SimpleNamespace(
        client_num_in_total=8, client_num_per_round=8, comm_round=1,
        epochs=1, batch_size=4, lr=3e-4, wd=0.0, client_optimizer="adam",
        frequency_of_the_test=10 ** 9, seed=0, client_chunk=4,
        bucket_edges="geometric", device_resident="0")


def _packed_dataset():
    return load_synthetic_images(client_num=4, n_train=120, n_test=16,
                                 image_size=H, partition="hetero",
                                 partition_alpha=0.5, seed=0)


def _port_api(path):
    if path == "packed":
        spec = make_classification_spec(CifarResNet(depth=DEPTH))
        return FedAvgAPI(_packed_dataset(), spec, _packed_args(),
                         device="cpu")
    model = TransformerLM(V, n_layers=1, n_heads=2, d_model=32, max_len=T)
    return FedAvgAPI(bench._synthetic_shakespeare_clients(8, T, V),
                     make_seq_classification_spec(model), _bucketed_args(),
                     device="cpu")


def _jax_api(path):
    if path == "packed":
        spec = jax_spec(JaxResNet(depth=DEPTH, num_classes=10),
                        jnp.zeros((1, H, H, 3)))
        api = JaxFedAvgAPI(_packed_dataset(), spec, _packed_args())
        assert api.packed_lane_runner is not None
        return api
    model = JaxLM(vocab_size=V, n_layers=1, n_heads=2, d_model=32,
                  max_len=T, dtype=jnp.float32)
    api = JaxFedAvgAPI(bench._synthetic_shakespeare_clients(8, T, V),
                       jax_seq_spec(model, jnp.zeros((1, T), jnp.int32)),
                       _bucketed_args())
    assert api.bucket_runner is not None
    return api


def _tree(spans):
    """``[(depth, name, attrs)]`` in pre-order, children in the order
    they started."""
    children = {}
    for s in spans:
        children.setdefault(s.parent_id, []).append(s)
    out = []

    def walk(parent, depth):
        for s in sorted(children.get(parent, []), key=lambda s: s.t0):
            out.append((depth, s.name,
                        {k: (int(v) if isinstance(v, (int, np.integer))
                             else v) for k, v in s.attrs.items()}))
            walk(s.span_id, depth + 1)

    walk(None, 0)
    return out


def _traced_round(api, module):
    tracer = module.Tracer()
    prev = module.set_tracer(tracer)
    try:
        api.train_one_round()
    finally:
        module.set_tracer(prev)
    return _tree(tracer.finished_spans())


@pytest.fixture(scope="module")
def span_trees():
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        return {path: (_traced_round(_jax_api(path), jtracing),
                       _traced_round(_port_api(path), tracing))
                for path in ("packed", "bucketed")}
    finally:
        mp.undo()


@pytest.mark.parametrize("path", ["packed", "bucketed"])
def test_round_span_tree_matches_jax_fedavg(span_trees, path):
    want, got = span_trees[path]
    assert got == want
    names = [name for _, name, _ in got]
    assert names[:2] == ["round", "cohort-select"]
    assert names[-2:] == ["aggregate", "report"]
    inner = "lanes" if path == "packed" else "bucket-chunk"
    assert inner in names


def test_bucketed_round_runs_one_chunk_span_per_chunk(span_trees):
    _, got = span_trees["bucketed"]
    chunks = [attrs for _, name, attrs in got if name == "bucket-chunk"]
    assert len(chunks) == 2
    assert [c["clients"] for c in chunks] == [4, 4]
    assert all(c["trip"] <= c["edge"] for c in chunks)


def _state_arrays(api):
    out = {}
    for part, leaves in api.global_state.items():
        for k, v in leaves.items():
            out[f"{part}/{k}"] = v.detach().numpy().copy()
    return out


@pytest.mark.parametrize("path", ["packed", "bucketed"])
def test_noop_tracer_round_equals_traced_round(path):
    assert tracing.get_tracer() is tracing.NOOP_TRACER
    plain = _port_api(path)
    m_plain = plain.train_one_round()
    traced = _port_api(path)
    tracer = tracing.Tracer()
    prev = tracing.set_tracer(tracer)
    try:
        m_traced = traced.train_one_round()
    finally:
        tracing.set_tracer(prev)
    assert tracer.finished_spans()
    for m in (m_plain, m_traced):
        m.pop("round_time_s")
    assert m_plain == m_traced
    a, b = _state_arrays(plain), _state_arrays(traced)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _nested_scenario(module):
    tracer = module.Tracer()
    with tracer.span("round", round=3):
        with tracer.span("local-train", mode="bucketed", clients=2):
            for edge in (8, 16):
                with tracer.span("bucket-chunk", edge=edge, clients=1,
                                 trip=edge - 1):
                    pass
        detached = tracer.start_span("aggregate")
        detached.set(reason="sync")
        detached.end()
        detached.end()
    return tracer


def test_tracing_module_matches_the_reference(tmp_path):
    # the port keeps the reference's API with its cross-process context
    # propagation (the control plane carries it) and the JSONL export
    # (observability.enable writes spans.jsonl)
    assert tracing.__all__ == jtracing.__all__
    assert tracing.TRACE_KEY == jtracing.TRACE_KEY
    for name in ("inject", "extract", "remote_context"):
        for cls in ("Tracer", "NoopTracer"):
            assert hasattr(getattr(jtracing, cls), name)
            assert hasattr(getattr(tracing, cls), name)
    got, want = _nested_scenario(tracing), _nested_scenario(jtracing)
    assert _tree(got.finished_spans()) == _tree(want.finished_spans())
    assert (sorted(got.durations_by_name())
            == sorted(want.durations_by_name()))
    assert ({k: len(v) for k, v in got.durations_by_name().items()}
            == {k: len(v) for k, v in want.durations_by_name().items()})
    docs = []
    for tracer in (got, want):
        path = tracer.export_chrome(str(tmp_path / "trace.json"))
        with open(path) as f:
            doc = json.load(f)
        docs.append([(e["ph"], e["name"], sorted(e.get("args", {})))
                     for e in doc["traceEvents"]])
    assert docs[0] == docs[1]
    lines = []
    for tracer in (got, want):
        path = tracer.export_jsonl(str(tmp_path / "spans.jsonl"))
        with open(path) as f:
            lines.append([(d["name"], sorted(d), sorted(d["attrs"]))
                          for d in map(json.loads, f)])
    assert lines[0] == lines[1] and len(lines[0]) == 5


def test_noop_tracer_matches_the_reference():
    for noop in (tracing.NOOP_TRACER, jtracing.NOOP_TRACER):
        assert not noop.enabled
        with noop.span("round", round=0) as s:
            assert s.set(x=1) is s
        assert noop.finished_spans() == [] and noop.durations_by_name() == {}
        assert noop.current() is None


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    off = {"device_busy_s": None, "wall_s": None}
    with profile_trace(None) as out:
        pass
    assert out == off
    with profile_trace(str(tmp_path), enabled=False) as out:
        pass
    assert out == off
    assert not (tmp_path / "trace.json").exists()
    with profile_trace(str(tmp_path)) as out:
        torch.ones(64, 64) @ torch.ones(64, 64)
    # on the CPU there is no card to be busy
    assert out["device_busy_s"] is None and out["wall_s"] > 0
    assert bench_port._profile_fields(out, 1) == {}
    fields = bench_port._profile_fields(
        {"device_busy_s": 3.0, "wall_s": 12.0}, 2)
    assert fields == {"device_busy_s": 1.5, "device_busy_share": 0.25}
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


# ---------------------------------------------------------------------------
# every resident wave_mode and the host-packed path (LR: the spans do not
# depend on the model), and a round that evaluates (its "eval" span)
# ---------------------------------------------------------------------------
MODE_PATHS = [(0, "auto"), (1, "auto"), (2, "auto"), (1, "0")]


def _lr_args(mode, resident, comm_round=1, freq=10 ** 9):
    return types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=comm_round,
        epochs=1, batch_size=16, lr=0.05, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=freq, seed=0, client_chunk=3, wave_mode=mode,
        device_resident=resident, device_data_cap_gb=1.0, device_dtype=None)


def _lr_apis(args):
    from fedml_tpu.data.synthetic import load_synthetic_federated
    from fedml_tpu.models.linear import LogisticRegression as JaxLR
    from fedml_tpu_torch.models.linear import LogisticRegression

    dataset = load_synthetic_federated(client_num=4, n_train=120, n_test=20,
                                       seed=0)
    japi = JaxFedAvgAPI(dataset, jax_spec(JaxLR(num_classes=10),
                                          jnp.zeros((1, 60))), args)
    api = FedAvgAPI(dataset, make_classification_spec(
        LogisticRegression(60, 10)), args, device="cpu")
    return japi, api


def _traced_train(api, module):
    tracer = module.Tracer()
    prev = module.set_tracer(tracer)
    try:
        api.train()
    finally:
        module.set_tracer(prev)
    return _tree(tracer.finished_spans())


@pytest.fixture(scope="module")
def mode_trees():
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        out = {}
        for mode, res in MODE_PATHS:
            japi, api = _lr_apis(_lr_args(mode, res))
            out[(mode, res)] = (_traced_round(japi, jtracing),
                                _traced_round(api, tracing))
        japi, api = _lr_apis(_lr_args(1, "auto", comm_round=2, freq=2))
        out["eval"] = (_traced_train(japi, jtracing),
                       _traced_train(api, tracing))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("mode,resident", MODE_PATHS)
def test_mode_round_span_tree_matches_jax_fedavg(mode_trees, mode,
                                                 resident):
    want, got = mode_trees[(mode, resident)]
    assert got == want
    modes = [a["mode"] for _, n, a in got if n == "local-train"]
    assert modes == [{0: "flat", 1: "waves", 2: "lanes"}[mode]
                     if resident == "auto" else "packed"]


def test_wave_round_opens_one_span_per_wave(mode_trees):
    _, got = mode_trees[(1, "auto")]
    waves = [a for _, n, a in got if n == "wave"]
    assert [w["clients"] for w in waves] == [3, 1]
    assert [n for _, n, _ in got].count("server-update") == 1


def test_evaluating_round_opens_the_reference_eval_span(mode_trees):
    """Two rounds of ``train()``, evaluating after the second: the same
    span trees, the ``eval`` span a root carrying the trained round."""
    want, got = mode_trees["eval"]
    assert got == want
    evals = [(d, a) for d, n, a in got if n == "eval"]
    assert evals == [(0, {"round": 1})]
