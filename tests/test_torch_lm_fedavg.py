"""The LM slice of the port against the JAX package: AMSGrad against
optax, the bucketed-streaming host legs and the Shakespeare data byte for
byte, and two rounds of the bucketed ``FedAvgAPI`` against the JAX
package's on a tiny fp32 TransformerLM (vocab 90, d_model 32, 2 layers,
2 heads, T 16): 8 clients of the LEAF-shaped synthetic population,
``client_chunk`` 4, batch 4, ``bucket_edges="geometric"`` (edges 8 and
16, both used), ``device_resident="0"``, Adam at lr 3e-4, the port
starting from the JAX package's initial weights carried across. Both
sides pack schedules with numpy (byte-equal); the JAX side runs its
Pallas flash attention in interpret mode.

Tolerances of the two rounds: the bucket accounting is equal; the train
loss agrees to 1e-6; the global parameters to lr/2 = 1.5e-4 elementwise,
with 99.9% of them within 1e-6. The first Adam update is lr * g / (|g| +
eps): an element whose gradient sits near 0 can move by up to lr either
way when the two frameworks' fp32 sums differ in the last bit, while the
others agree to reassociation (observed: 1e-7 after round 1, 2e-5 at
3 of 31,578 elements after round 2).
"""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import (
    make_seq_classification_spec as jax_seq_spec)
from fedml_tpu.data import shakespeare as jshake
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.parallel import packing as jpack
from fedml_tpu.parallel.engine import ClientUpdateConfig as JaxCfg
from fedml_tpu.parallel.engine import make_optimizer as jax_make_optimizer
from fedml_tpu.parallel.mesh import zero_pad_leading as jax_zero_pad
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
from fedml_tpu_torch.data import shakespeare as tshake
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.parallel import packing as tpack
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig, _select,
                                             make_optimizer)
from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                lm_variables_to_state)

T, V, ROUNDS, LR = 16, 90, 2, 3e-4


# ---------------------------------------------------------------------------
# AMSGrad
# ---------------------------------------------------------------------------
def test_amsgrad_matches_optax_over_five_steps_with_masked_steps():
    """Two stacked clients, weight decay coupled in, five steps of which
    client 1 skips step 1 and client 0 step 2 (masked steps leave
    params and optimizer state, its count included, untouched)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (4,)}
    p0 = [{k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()} for _ in range(2)]
    grads = [{k: rng.standard_normal((2,) + s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    valid = np.array([[1, 1], [1, 0], [0, 1], [1, 1], [1, 1]], bool)

    opt = make_optimizer(ClientUpdateConfig(optimizer="adam", lr=LR,
                                            weight_decay=0.01))
    params = {k: torch.from_numpy(np.stack([p[k] for p in p0]))
              for k in shapes}
    state = opt.init(params, (2,))
    for g, ok in zip(grads, valid):
        new = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                         state, params)
        params, state = _select(torch.from_numpy(ok), new, (params, state))

    tx = jax_make_optimizer(JaxCfg(optimizer="adam", lr=LR,
                                   weight_decay=0.01))
    for c in range(2):
        p = {k: jnp.asarray(v) for k, v in p0[c].items()}
        s = tx.init(p)
        for g, ok in zip(grads, valid):
            if ok[c]:
                u, s = tx.update({k: jnp.asarray(v[c]) for k, v in g.items()},
                                 s, p)
                p = optax.apply_updates(p, u)
        assert int(state["count"][c]) == int(optax.tree_utils.tree_get(
            s, "count")) == int(valid[:, c].sum())
        for k in shapes:
            np.testing.assert_allclose(params[k][c].numpy(), np.asarray(p[k]),
                                       rtol=0, atol=1e-7)
            for name in ("mu", "nu", "nu_max"):
                np.testing.assert_allclose(
                    state[name][k][c].numpy(),
                    np.asarray(optax.tree_utils.tree_get(s, name)[k]),
                    rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# host legs, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,s_max", [
    ("geometric", 50), (None, 7), ("geo", 8), ("auto", 1), ("8,24", 20),
    ("8,16", 100), ("3", 40)])
def test_parse_bucket_edges_matches_jax(spec, s_max):
    assert tpack.parse_bucket_edges(spec, s_max) == \
        jpack.parse_bucket_edges(spec, s_max)


def test_bucket_edges_reject_what_jax_rejects():
    with pytest.raises(ValueError):
        tpack.parse_bucket_edges("0,8", 10)
    with pytest.raises(ValueError):
        tpack.bucket_edge_for([3, 17], [8, 16])
    steps = np.arange(0, 17)
    np.testing.assert_array_equal(tpack.bucket_edge_for(steps, [8, 16]),
                                  jpack.bucket_edge_for(steps, [8, 16]))
    assert int(tpack.bucket_edge_for(8, [8, 16])) == 8


def test_schedule_batches_and_padding_are_byte_equal():
    ds = bench._synthetic_shakespeare_clients(6, T, V)[5]
    datasets = [ds[c] for c in range(6)]
    ns = [len(d["y"]) for d in datasets]
    members = [4, 0, 2, 5]
    kw = dict(s_max=16, step_bucket=8)
    got = tpack.pack_schedule([ns[m] for m in members], 4, 1,
                              rng=np.random.default_rng(3), native=False,
                              **kw)
    want = jpack.pack_schedule([ns[m] for m in members], 4, 1,
                               rng=np.random.default_rng(3), native=False,
                               **kw)
    for key in ("idx", "mask", "n"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError):
        tpack.pack_schedule([40], 4, 1, s_max=8)
    xb, yb = tpack.gather_batches(datasets, got, members)
    jxb, jyb = jpack.gather_batches(datasets, want, members)
    assert xb.dtype == jxb.dtype and yb.dtype == jyb.dtype
    np.testing.assert_array_equal(xb, jxb)
    np.testing.assert_array_equal(yb, jyb)
    arrays = (xb, yb, got["mask"], got["n"])
    for a, b in zip(tpack.zero_pad_leading(arrays, 3),
                    jax_zero_pad(arrays, 3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_shakespeare_data_is_byte_equal():
    assert tshake.CHAR_VOCAB == jshake.CHAR_VOCAB
    assert (tshake.SEQUENCE_LENGTH, tshake.VOCAB_SIZE) == (80, 90)
    assert tshake.VOCAB_SIZE == jshake.VOCAB_SIZE
    snippets = ["To be, or not to be: that is the question.", "",
                "Ünïcode ~ out of vocab\n" * 6, "a" * 200]
    for s in snippets:
        assert tshake.to_ids(s) == jshake.to_ids(s)
        assert tshake.to_ids(s, 12) == jshake.to_ids(s, 12)
    for got, want in zip(tshake.preprocess_snippets(snippets),
                         jshake.preprocess_snippets(snippets)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tshake.preprocess_snippets([]),
                         jshake.preprocess_snippets([])):
        assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("clients,seq_len", [(32, 80), (8, T)])
def test_synthetic_population_matches_bench(clients, seq_len):
    got = tshake.synthetic_shakespeare_clients(clients, seq_len, V)
    want = bench._synthetic_shakespeare_clients(clients, seq_len, V)
    assert got[0] == want[0] and got[1] == want[1] and got[7] == want[7]
    assert got[4] == want[4]
    for a, b in ((got[2], want[2]), (got[3], want[3])):
        for key in ("x", "y"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    for c in range(clients):
        for key in ("x", "y"):
            np.testing.assert_array_equal(got[5][c][key], want[5][c][key])
            np.testing.assert_array_equal(got[6][c][key], want[6][c][key])


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def _args(clients=8, chunk=4):
    return types.SimpleNamespace(
        client_num_in_total=clients, client_num_per_round=clients,
        comm_round=ROUNDS, epochs=1, batch_size=4, lr=LR, wd=0.0,
        client_optimizer="adam", frequency_of_the_test=10 ** 9, seed=0,
        client_chunk=chunk, bucket_edges="geometric", device_resident="0")


def _port_api(dataset, args):
    model = TransformerLM(V, n_layers=2, n_heads=2, d_model=32, max_len=T)
    return FedAvgAPI(dataset, make_seq_classification_spec(model), args,
                     device="cpu")


@pytest.fixture(scope="module")
def trajectories():
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        dataset = bench._synthetic_shakespeare_clients(8, T, V)
        jmodel = JaxLM(vocab_size=V, n_layers=2, n_heads=2, d_model=32,
                       max_len=T, dtype=jnp.float32)
        japi = JaxFedAvgAPI(dataset, jax_seq_spec(
            jmodel, jnp.zeros((1, T), jnp.int32), name="lm"), _args())
        assert japi.bucket_runner is not None
        init = jax.tree.map(np.array, japi.global_state)
        api = _port_api(dataset, _args())
        api.global_state = lm_variables_to_state(init)
        ref, got = [], []
        for _ in range(ROUNDS):
            ref.append((japi.train_one_round(),
                        jax.tree.map(np.array, japi.global_state)))
            got.append((api.train_one_round(),
                        lm_state_to_variables(api.global_state)))
        return ref, got, init, api
    finally:
        mp.undo()


BUCKET_KEYS = ("bucket/clients", "bucket/shapes", "bucket/chunks",
               "bucket/executed_steps", "bucket/true_steps",
               "bucket/waste_frac")


@pytest.mark.parametrize("rnd", range(ROUNDS))
def test_bucketed_round_matches_jax_fedavg(trajectories, rnd):
    ref, got, init, _ = trajectories
    (rm, rs), (gm, gs) = ref[rnd], got[rnd]
    assert gm["round"] == rm["round"] == rnd
    assert {k: gm[k] for k in BUCKET_KEYS} == {k: rm[k] for k in BUCKET_KEYS}
    assert gm["bucket/shapes"] == 2 and gm["bucket/waste_frac"] > 0
    np.testing.assert_allclose(gm["Train/Loss"], rm["Train/Loss"], atol=1e-6)
    np.testing.assert_allclose(gm["Train/Acc"], rm["Train/Acc"], atol=1e-6)
    want = jax.tree_util.tree_leaves_with_path(rs)
    have = dict(jax.tree_util.tree_leaves_with_path(gs))
    start = dict(jax.tree_util.tree_leaves_with_path(init))
    assert len(want) == len(have)
    errs, moved = [], 0.0
    for path, leaf in want:
        np.testing.assert_allclose(have[path], leaf, rtol=0, atol=LR / 2)
        errs.append(np.abs(have[path] - leaf).ravel())
        moved = max(moved, float(np.abs(leaf - start[path]).max()))
    assert np.mean(np.concatenate(errs) > 1e-6) < 1e-3
    assert moved > LR  # the round really trained


def test_round_records_and_test_evaluation(trajectories):
    _, got, _, api = trajectories
    assert api.round_idx == ROUNDS
    assert all(m["round_time_s"] > 0 for m, _ in got)
    ev = api.evaluate_global()
    assert np.isfinite(ev["Test/Loss"]) and 0.0 <= ev["Test/Acc"] <= 1.0


def test_ragged_final_chunk_pads_inert_clients():
    """Seven clients in a chunk of 8: the chunk carries one inert client
    (n = 0, fully masked), which moves nothing -- the round equals the
    same seven clients in a chunk of 7 (one schedule draw either way) up
    to an fp32 ulp of the batched products -- while its steps count as
    executed."""
    dataset = bench._synthetic_shakespeare_clients(7, T, V)
    out = []
    for chunk in (8, 7):
        api = _port_api(dataset, _args(7, chunk))
        out.append((api.train_one_round(), api.global_state["params"]))
    (m8, p8), (m7, p7) = out
    assert m8["bucket/chunks"] == m7["bucket/chunks"] == 1
    assert m8["bucket/true_steps"] == m7["bucket/true_steps"]
    trip = m7["bucket/executed_steps"] // 7
    assert m8["bucket/executed_steps"] == 8 * trip
    np.testing.assert_allclose(m8["Train/Loss"], m7["Train/Loss"], atol=1e-6)
    for k in p7:
        torch.testing.assert_close(p8[k], p7[k], rtol=0, atol=1e-6)


def test_bucketed_path_refuses_what_is_not_ported():
    dataset = bench._synthetic_shakespeare_clients(4, T, V)
    args = _args(4)
    args.grad_clip = 5.0
    # clipping is ported (FedNAS): the chunks' optimizer clips first
    from fedml_tpu_torch.parallel.engine import (ClipByGlobalNorm,
                                                 make_optimizer)
    api = _port_api(dataset, args)
    assert api.bucket_runner is not None
    assert isinstance(make_optimizer(api.cfg), ClipByGlobalNorm)
    args = _args(4)
    args.compressor = "topk:0.1"
    # the bucketed path streams error feedback now
    api = _port_api(dataset, args)
    assert api.bucket_runner.compressor.name == "topk"
    assert api.compressed_round_fn is None and api._ef_store.dense
