"""Compressed federated rounds of the port against the reference's, from
the reference's initial weights carried over, both packing schedules
with numpy: the experiment mains with ``--compressor`` (the host-packed
compressed round under ``main_fedavg`` and ``main_fedopt``, streaming
error feedback on the bucketed path, synchronous and async) on LR with
the reference's defaults for 2 rounds; the host-packed compressed round
of a tiny TransformerLM (d_model 32, 2 layers, 6 clients, SGD) for 2
rounds; the bench's ``--compression_sweep``, ``--check`` and
``--massive_cohort 300 --compressor topk:0.1``. Also: the port's
``none`` round is its plain round bit for bit, and residuals follow
client ids across re-sampled cohorts.

Tolerances: ``bytes_on_wire``, ``compression_ratio``, the bucket and
async counters and every byte count exactly; losses and test metrics
to 1e-4 (the mains' comparison in ``test_torch_experiments.py``); global
parameters and residuals to 1e-5 (LR) and 1e-6 (the LM's SGD steps):
fp32 sums in another order move a delta by an ulp, and topk keeps the
same coordinates while its magnitudes stay apart."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from fedml_tpu_torch import bench as tbench
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import (make_classification_spec,
                                              make_seq_classification_spec)
from fedml_tpu_torch.data.synthetic import load_synthetic_federated
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.program.cohort import client_sampling
from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                lm_variables_to_state,
                                                zoo_state_to_variables,
                                                zoo_variables_to_state)

#: (main, argv) on LR with the reference's defaults for 2 rounds
MAIN_CASES = {
    "fedavg_topk": ("fedavg", ["--compressor", "topk:0.1"]),
    "fedopt_signsgd": ("fedopt", ["--compressor", "signsgd"]),
    "stream_sync_topk": ("fedavg", ["--bucket_edges", "geometric",
                                    "--client_chunk", "4",
                                    "--compressor", "topk:0.1"]),
    "stream_async_signsgd": ("fedavg", ["--async_agg", "1", "--buffer_k",
                                        "4", "--client_chunk", "2",
                                        "--compressor", "signsgd"]),
}
TOL_LR, TOL_LM = 1e-5, 1e-6


def _carry(init):
    return zoo_variables_to_state(init)


@pytest.fixture(scope="module", params=sorted(MAIN_CASES))
def mains(request):
    """The reference main and the port's on the same argv: (case,
    reference api, port api)."""
    import importlib

    import fedml_tpu.algorithms.fedavg as jfedavg
    import fedml_tpu.algorithms.fedopt as jfedopt
    import fedml_tpu_torch.algorithms.fedavg as tfedavg
    import fedml_tpu_torch.algorithms.fedopt as tfedopt

    name, argv = MAIN_CASES[request.param]
    argv = argv + ["--comm_round", "2", "--platform", "cpu"]
    jmod, tmod = ((jfedopt, tfedopt) if name == "fedopt"
                  else (jfedavg, tfedavg))
    cls = "FedOptAPI" if name == "fedopt" else "FedAvgAPI"
    inits = []

    class JaxAPI(getattr(jmod, cls)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append(jax.tree.map(np.array, self.global_state))

    class PortAPI(getattr(tmod, cls)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.global_state = _carry(inits[0])
            if name == "fedopt":
                self.server_state = self.server_tx.init(
                    self.global_state["params"])

    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    mp.setattr(jmod, cls, JaxAPI)
    mp.setattr(tmod, cls, PortAPI)
    try:
        jmain = importlib.import_module(f"fedml_tpu.experiments.main_{name}")
        tmain = importlib.import_module(
            f"fedml_tpu_torch.experiments.main_{name}")
        japi, _ = jmain.main(argv)
        api, _ = tmain.main(argv)
    finally:
        mp.undo()
    return request.param, japi, api


def test_main_records_match_the_reference(mains):
    case, japi, api = mains
    assert len(api.history) == len(japi.history) == 2
    for rm, gm in zip(japi.history, api.history):
        # the port's bucketed record also names its packing backend
        assert sorted(set(gm) - {"packing_backend"}) == sorted(rm)
        assert gm["bytes_on_wire"] == rm["bytes_on_wire"] > 0
        assert gm["compression_ratio"] == rm["compression_ratio"] > 1
        for key, want in rm.items():
            if key.startswith(("bucket/", "async/")):
                assert gm[key] == want, key
            elif key not in ("round_time_s",):
                np.testing.assert_allclose(gm[key], want, atol=1e-4,
                                           err_msg=f"{case} {key}")


def test_main_states_and_residuals_match_the_reference(mains):
    case, japi, api = mains
    got = zoo_state_to_variables(api.global_state)["params"]
    want = jax.tree.map(np.asarray, japi.global_state["params"])
    for layer, leaves in want.items():
        for k, w in leaves.items():
            np.testing.assert_allclose(got[layer][k], w, rtol=0,
                                       atol=TOL_LR, err_msg=f"{case} {k}")
    assert api._ef_store.dense == japi._ef_store.dense
    for c in range(len(api.train_data_local_dict)):
        res = zoo_state_to_variables({"params": api._ef_store.peek(c)})
        jres = japi._ef_store.peek(c)
        for layer, leaves in jres.items():
            for k, w in leaves.items():
                np.testing.assert_allclose(
                    res["params"][layer][k], np.asarray(w), rtol=0,
                    atol=TOL_LR, err_msg=f"{case} client {c} {k}")


# ---------------------------------------------------------------------------
# the compressed LM round
# ---------------------------------------------------------------------------
T, V = 20, 90


def _lm_args(compressor):
    return types.SimpleNamespace(
        client_num_in_total=6, client_num_per_round=6, comm_round=2,
        epochs=1, batch_size=4, lr=0.1, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=1, seed=0, client_chunk=4, wave_mode=1,
        device_resident="auto", device_data_cap_gb=1.0, device_dtype=None,
        compressor=compressor)


@pytest.fixture(scope="module")
def lm_rounds():
    from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
    from fedml_tpu.algorithms.specs import (
        make_seq_classification_spec as jax_seq_spec)
    from fedml_tpu.data.synthetic import load_synthetic_sequences
    from fedml_tpu.models.transformer import TransformerLM as JaxLM

    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        dataset = load_synthetic_sequences(client_num=6, n_train=60,
                                           n_test=12, seq_len=T,
                                           vocab_size=V, seed=0)
        jmodel = JaxLM(vocab_size=V, n_layers=2, n_heads=2, d_model=32,
                       max_len=T, dtype=jnp.float32)
        japi = JaxFedAvgAPI(dataset, jax_seq_spec(
            jmodel, jnp.zeros((1, T), jnp.int32)), _lm_args("topk:0.1"))
        init = jax.tree.map(np.array, japi.global_state)
        model = TransformerLM(V, n_layers=2, n_heads=2, d_model=32,
                              max_len=T)
        api = FedAvgAPI(dataset, make_seq_classification_spec(model),
                        _lm_args("topk:0.1"), device="cpu")
        api.global_state = lm_variables_to_state(init)
        ref, got = [], []
        japi.train(on_round=lambda a, m: ref.append(dict(m)))
        api.train(on_round=lambda a, m: got.append(dict(m)))
        return japi, api, ref, got
    finally:
        mp.undo()


def test_compressed_lm_round_matches_the_reference(lm_rounds):
    japi, api, ref, got = lm_rounds
    assert api.compressed_round_fn is not None and api.device_data is None
    for rm, gm in zip(ref, got):
        assert gm["bytes_on_wire"] == rm["bytes_on_wire"]
        assert gm["compression_ratio"] == rm["compression_ratio"]
        for key in ("Train/Loss", "Test/Loss", "Test/Acc"):
            np.testing.assert_allclose(gm[key], rm[key], atol=1e-4)
    got_p = lm_state_to_variables(api.global_state)["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(
            japi.global_state["params"]):
        g = got_p
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, np.asarray(want), rtol=0,
                                   atol=TOL_LM, err_msg=str(path))


def test_compressed_lm_residuals_match_the_reference(lm_rounds):
    japi, api, _, _ = lm_rounds
    for c in range(6):
        res = lm_state_to_variables({"params": api._ef_store.peek(c)})
        for path, want in jax.tree_util.tree_leaves_with_path(
                japi._ef_store.peek(c)):
            g = res["params"]
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(g, np.asarray(want), rtol=0,
                                       atol=TOL_LM, err_msg=str(path))


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------
def _lr_api(compressor=None, total=6, per_round=6):
    dataset = load_synthetic_federated(client_num=total, n_train=300,
                                       n_test=60, alpha=0.0, beta=0.0,
                                       seed=0)
    spec = make_classification_spec(LogisticRegression(60, 10,
                                                       apply_sigmoid=False))
    args = types.SimpleNamespace(
        client_num_in_total=total, client_num_per_round=per_round,
        comm_round=2, epochs=1, batch_size=10, lr=0.03, wd=0.0,
        client_optimizer="sgd", frequency_of_the_test=5, seed=0,
        client_chunk=4, device_resident="0", compressor=compressor)
    return FedAvgAPI(dataset, spec, args, device="cpu")


def test_none_round_is_the_plain_round_bit_for_bit():
    none, plain = _lr_api("none"), _lr_api()
    assert none.compressed_round_fn is not None
    for _ in range(2):
        rec = none.train_one_round()
        plain.train_one_round()
    assert rec["compression_ratio"] < 1  # the identity's framing
    for k, v in plain.global_state["params"].items():
        assert torch.equal(none.global_state["params"][k], v), k
    for c in range(6):
        assert all(float(v.abs().max()) == 0
                   for v in none._ef_store.peek(c).values())


def test_residuals_follow_client_ids_across_cohorts():
    api = _lr_api("qsgd:8", total=8, per_round=3)
    cohort0 = set(client_sampling(0, 8, 3))
    api.train_one_round()
    before = {c: api._ef_store.peek(c) for c in range(8)}
    cohort1 = set(client_sampling(1, 8, 3))
    api.train_one_round()
    assert cohort0 != cohort1
    for c in range(8):
        after = api._ef_store.peek(c)
        if c in cohort1:
            assert any(float(v.abs().max()) > 0 for v in after.values())
        else:
            for k, v in after.items():
                assert torch.equal(v, before[c][k]), (c, k)


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------
def _ref_tools(monkeypatch, **flags):
    lines = []
    monkeypatch.setattr(bench, "print", lambda line, **kw: lines.append(
        json.loads(line)), raising=False)
    rc = bench.run_compression_tools(types.SimpleNamespace(
        sweep_model="cnn", repeats=1, **flags))
    monkeypatch.undo()
    return rc, lines


SWEEP = "none,topk:0.01,randk:0.1,qsgd:8,signsgd"


def test_compression_sweep_bytes_are_the_reference_ones(monkeypatch):
    _, want = _ref_tools(monkeypatch, check=False, compressors=SWEEP)
    record = tbench.main(["--compression_sweep", "--sweep_model", "cnn",
                          "--compressors", SWEEP, "--repeats", "1",
                          "--platform", "cpu"])
    assert "error" not in record and tbench._exit_code(record) == 0
    rows = record["rows"]
    assert [r["compressor"] for r in rows] == SWEEP.split(",")
    for got, ref in zip(rows, want):
        for key in ("compressor", "model", "n_params", "encoded_bytes",
                    "raw_binary_bytes", "ratio_vs_binary"):
            assert got[key] == ref[key], (got["compressor"], key)
        assert got["encode_ms"] > 0 and got["decode_ms"] > 0


def test_check_gate_and_json_bytes_are_the_reference_ones(monkeypatch):
    from fedml_tpu.models import CNNOriginalFedAvg

    rc, want = _ref_tools(monkeypatch, check=True, compressors="none")
    record = tbench.main(["--check", "--sweep_model", "cnn",
                          "--platform", "cpu"])
    assert rc == 0 and record["pass"] is True and want[0]["pass"] is True
    for key in ("n_params", "binary_bytes", "threshold"):
        assert record[key] == want[0][key], key
    # the JSON lists depend on the values: equal on the same weights
    variables = CNNOriginalFedAvg(only_digits=True).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 1)))
    state = zoo_variables_to_state(jax.tree.map(np.asarray, variables),
                                   convs=("conv1", "conv2"))
    assert tbench._json_list_nbytes(tbench.reference_variables(
        state, "cnn")) == bench._json_list_nbytes(variables["params"])


def test_massive_cohort_with_a_compressor_matches_the_reference():
    import fedml_tpu.algorithms.fedavg as jfedavg
    import fedml_tpu_torch.algorithms.fedavg as tfedavg

    inits, out = [], {}

    class JaxAPI(jfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append(jax.tree.map(np.array, self.global_state))

    class PortAPI(tfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.global_state = zoo_variables_to_state(inits[0])

    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    mp.setattr(jfedavg, "FedAvgAPI", JaxAPI)
    mp.setattr(tfedavg, "FedAvgAPI", PortAPI)
    mp.setattr(bench, "print", lambda line, **kw: out.setdefault(
        "ref", json.loads(line)), raising=False)
    try:
        assert bench.run_massive_cohort(types.SimpleNamespace(
            massive_cohort=300, staleness_decay=0.5, rounds=1,
            compressor="topk:0.1", ledger="", massive_async=0,
            massive_chunk=128, buffer_k=2048)) == 0
        got = tbench.main(["--massive_cohort", "300", "--compressor",
                           "topk:0.1", "--platform", "cpu", "--rounds", "1",
                           "--ledger", ""])
    finally:
        mp.undo()
    ref = out["ref"]
    assert "error" not in got
    for key in ("compressor", "bytes_on_wire", "compression_ratio",
                "clients_per_round", "true_steps", "executed_steps",
                "bucket_shapes"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"],
                               atol=1e-4)
    assert got["metric"].startswith(ref["metric"])
    assert got["residual_store"] == "dense"
