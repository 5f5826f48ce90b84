"""The port's torch compressors, their error feedback, the compressed
fold, the residual store and the codec leg of the round program, against
the JAX package on the same numpy inputs
(``fedml_tpu_torch/compression/{compressors,integration}.py``,
``program/{aggregation,privacy,codec}.py``).

Tolerances: ``none`` and ``topk`` (distinct magnitudes) encode and
decode exactly, topk's indices byte-equal on leaves given in one layout;
signsgd's signs exactly and its mean-|x| scale within 4 ulp (the sums
run in another order); ``qsgd`` and ``randk`` exactly given JAX's draws
handed in; the compressors' unbiasedness to 5 standard errors of the
mean over 400 draws; the error-feedback identity ``decoded + residual' == delta +
residual`` to 1e-6; the compressed folds, the compressed buffered
oracle and the robust fold over compressed reports bitwise; the payload
byte counts exactly."""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.compression import compressors as jcomps
from fedml_tpu.compression import integration as jinteg
from fedml_tpu.compression import wire as jwire
from fedml_tpu.program import aggregation as jagg
from fedml_tpu.program import privacy as jprivacy
from fedml_tpu.program.round import RoundProgram as JaxProgram
from fedml_tpu_torch.compression import compressors as comps
from fedml_tpu_torch.compression import integration as integ
from fedml_tpu_torch.compression import wire
from fedml_tpu_torch.program import aggregation as agg
from fedml_tpu_torch.program import privacy
from fedml_tpu_torch.program.codec import CodecSpec
from fedml_tpu_torch.program.round import RoundProgram
from fedml_tpu_torch.utils.torch_import import reference_tree

K = 3
SHAPES = {"a_conv": (4, 3, 5), "b_bias": (7,), "c_dense": (16, 9)}


def _leaves(seed=0, shapes=SHAPES):
    """``[K, *shape]`` fp32 leaves with distinct magnitudes in each
    client's row."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        rows = [rng.permutation(np.linspace(0.01, 3.0, n)) *
                rng.choice([-1.0, 1.0], n) for _ in range(K)]
        out[name] = np.stack(rows).reshape((K,) + shape).astype(np.float32)
    return out


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_keys(name_index, c):
    return jax.random.PRNGKey(1000 * c + name_index)


def _jax_encode(jcomp, leaves):
    """JAX's encode of each client's leaves and the draws it made."""
    encs, draws = {}, {}
    for i, (name, x) in enumerate(sorted(leaves.items())):
        per, dr = [], []
        for c in range(K):
            key = _jax_keys(i, c)
            per.append(jax.tree.map(np.asarray, jcomp.encode(x[c], key)))
            if isinstance(jcomp, jcomps.QSGDCompressor):
                dr.append(np.asarray(jax.random.uniform(key, x[c].shape)))
            elif isinstance(jcomp, jcomps.RandKCompressor):
                k = jcomps._k_for(x[c].shape, jcomp.ratio)
                dr.append(np.asarray(jax.random.permutation(
                    key, x[c].size)[:k]))
        encs[name] = per
        draws[name] = torch.from_numpy(np.stack(dr)) if dr else None
    return encs, draws


SPECS = ["none", "topk:0.1", "topk:1.0", "randk:0.25", "qsgd:8", "qsgd:2",
         "signsgd"]


@pytest.mark.parametrize("spec", SPECS)
def test_compressor_matches_jax(spec):
    leaves = _leaves(1)
    comp, jcomp = comps.get_compressor(spec), jcomps.get_compressor(spec)
    jenc, draws = _jax_encode(jcomp, leaves)
    enc = comp.compress(_torch(leaves), np.arange(K),
                        draws if any(v is not None for v in draws.values())
                        else None)
    tmpl = {k: torch.zeros(s) for k, s in SHAPES.items()}
    dec = comp.decompress(enc, tmpl)
    for name, x in leaves.items():
        for c in range(K):
            want = jenc[name][c]
            for field, w in want.items():
                got = enc[name][field][c].numpy()
                if spec == "signsgd" and field == "scale":
                    np.testing.assert_array_max_ulp(got, w, maxulp=4)
                else:
                    assert got.dtype == w.dtype, (name, field)
                    np.testing.assert_array_equal(got, w, err_msg=field)
            jdec = np.asarray(jcomp.decode(
                jax.tree.map(jnp.asarray, want), x[c].shape, jnp.float32))
            if spec == "signsgd":
                np.testing.assert_array_max_ulp(dec[name][c].numpy(), jdec,
                                                maxulp=4)
            else:
                np.testing.assert_array_equal(dec[name][c].numpy(), jdec)


@pytest.mark.parametrize("spec", ["randk:0.25", "qsgd:4"])
def test_stochastic_compressors_are_unbiased(spec):
    comp = comps.get_compressor(spec)
    x = torch.from_numpy(_leaves(2)["c_dense"]).double()
    draws, n = 400, x[0].numel()
    acc = torch.zeros_like(x)
    for s in range(draws):
        acc += comp.decode(comp.encode(x.float(), np.arange(K) + K * s),
                           x.shape[1:], torch.float32).double()
    if spec.startswith("qsgd"):
        # a code rounds up with probability p: variance cell^2 p (1 - p)
        cell = x.abs().reshape(K, -1).amax(1) / comp.levels
        sd = (cell / 2).reshape(K, 1, 1).expand_as(x)
    else:
        # kept with probability k/n and scaled by n/k
        sd = x.abs() * (n / comps._k_for(x.shape[1:], comp.ratio) - 1) ** .5
    assert bool(((acc / draws - x).abs() <= 5 * sd / draws ** .5).all())


def test_draws_are_per_client_and_leaf_and_reproducible():
    comp = comps.get_compressor("qsgd:8")
    tree = _torch(_leaves(3))
    a = comp.draws(tree, np.asarray([5, 6, 7]))
    b = comp.draws(tree, np.asarray([5, 6, 7]))
    for k in tree:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k][0], a[k][1])
    assert not torch.equal(a["a_conv"].flatten()[:7],
                           a["b_bias"].flatten()[:7])
    enc = comp.compress(tree, np.asarray([5, 6, 7]))
    enc_drawn = comp.compress(tree, None, a)
    for k in tree:
        assert torch.equal(enc[k]["q"], enc_drawn[k]["q"])


@pytest.mark.parametrize("spec", ["topk:0.1", "qsgd:8", "signsgd",
                                  "randk:0.5"])
def test_error_feedback_identity(spec):
    ef = comps.ErrorFeedback(comps.get_compressor(spec))
    tmpl = {k: torch.zeros(s) for k, s in SHAPES.items()}
    residual = ef.init(tmpl, K)
    for rnd in range(3):
        delta = _torch(_leaves(10 + rnd))
        _, dec, new = ef.step(delta, residual, tmpl, np.arange(K) + rnd)
        for k in delta:
            torch.testing.assert_close(dec[k] + new[k],
                                       delta[k] + residual[k], rtol=0,
                                       atol=1e-6)
        residual = new
    assert any(float(v.abs().max()) > 0 for v in residual.values())


def test_integer_leaves_ride_raw():
    comp = comps.get_compressor("topk:0.5")
    tree = {"w": torch.randn(K, 6), "step": torch.arange(K)}
    enc = comp.compress(tree, np.arange(K))
    assert torch.equal(enc["step"]["raw"], tree["step"])
    dec = comp.decompress(enc, {"w": torch.zeros(6),
                                "step": torch.zeros((), dtype=torch.int64)})
    assert torch.equal(dec["step"], tree["step"])


@pytest.mark.parametrize("spec", [None, "", "0", "off", "false", "none",
                                  "topk", "topk:0.01", "randk:0.1", "qsgd",
                                  "qsgd:4", "QSGD:8", "signsgd", "zip",
                                  "qsgd:9", "topk:0", "topk:1.5",
                                  "signsgd:2", "none:3"])
def test_get_compressor_grammar_is_the_reference_one(spec):
    def outcome(fn):
        try:
            c = fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))
        if c is None:
            return None
        return (c.name, getattr(c, "ratio", None), getattr(c, "bits", None),
                repr(c))
    assert outcome(comps.get_compressor) == outcome(jcomps.get_compressor)


def _ref_template():
    """A reference-layout params template (the carried LR and a conv)."""
    return {"conv1": {"kernel": np.zeros((5, 5, 1, 8), np.float32),
                      "bias": np.zeros(8, np.float32)},
            "linear": {"kernel": np.zeros((60, 10), np.float32),
                       "bias": np.zeros(10, np.float32)}}


@pytest.mark.parametrize("spec", ["none", "topk:0.01", "topk:0.3",
                                  "randk:0.1", "qsgd:8", "signsgd"])
def test_payload_nbytes_are_the_reference_ones(spec):
    port_params = {"conv1.weight": torch.zeros(8, 1, 5, 5),
                   "conv1.bias": torch.zeros(8),
                   "linear.weight": torch.zeros(10, 60),
                   "linear.bias": torch.zeros(10)}
    wire_tree = reference_tree(port_params)
    want = jinteg.compressed_payload_nbytes(jcomps.get_compressor(spec),
                                            _ref_template())
    got = integ.compressed_payload_nbytes(comps.get_compressor(spec),
                                          wire_tree)
    assert got == want
    assert integ.raw_payload_nbytes(wire_tree) == \
        jinteg.raw_payload_nbytes(_ref_template())


# ---------------------------------------------------------------------------
# the compressed fold
# ---------------------------------------------------------------------------
def _updates(mod, spec, base, seed, base_key=0):
    comp = mod.host_compressor(spec)
    rng = np.random.default_rng(seed)
    delta = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
             for k, v in base.items()}
    enc, _, _ = mod.ef_step(comp, delta, None, mod.encode_rng((seed, 0, 0)))
    return mod.CompressedUpdate(enc=enc, spec=comp.spec, base=base,
                                base_key=base_key)


def _entry_sets():
    rng = np.random.default_rng(0)
    b0 = {"w": rng.standard_normal((8, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    b1 = {k: v + 1 for k, v in b0.items()}
    dense = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in b0.items()}

    def entries(mod):
        return {
            "compressed": [(r, 10.0 * r, _updates(mod, s, b0, r), 10.0 * r)
                           for r, s in ((3, "qsgd"), (1, "topk:0.25"),
                                        (2, "signsgd"))],
            "mixed": [(1, 10.0, dense, 10.0),
                      (2, 30.0, _updates(mod, "qsgd:4", b0, 7), 30.0)],
            "bases": [(1, 1.0, _updates(mod, "topk:0.5", b0, 1, 0), 1.0),
                      (2, 2.0, _updates(mod, "topk:0.5", b0, 2, 0), 2.0),
                      (3, 3.0, _updates(mod, "topk:0.5", b1, 3, 1), 3.0)],
        }
    return entries(wire), entries(jwire)


@pytest.mark.parametrize("case", ["compressed", "mixed", "bases"])
def test_compressed_fold_is_bitwise_the_reference(case):
    got_entries, want_entries = (e[case] for e in _entry_sets())
    got, w = agg.fold_entries_fp64(got_entries)
    want, jw = jagg.fold_entries_fp64(want_entries)
    assert w == jw
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_compressed_buffered_oracle_is_bitwise_the_reference():
    base = {"w": np.random.default_rng(4).standard_normal(
        64).astype(np.float32)}
    out = []
    for mod, amod in ((wire, agg), (jwire, jagg)):
        aggregator = amod.BufferedAggregator(amod.AggregationPolicy(
            buffer_k=10 ** 9, staleness_decay=0.0))
        reports = {}
        for rank in (3, 1, 2):
            upd = _updates(mod, "qsgd", base, rank)
            reports[rank] = (10.0 * rank, upd)
            aggregator.fold(rank, 10.0 * rank, upd)
        res = aggregator.flush("drain")
        want, total = amod.aggregate_reports(reports)
        assert res.weight == total
        np.testing.assert_array_equal(res.params["w"], want["w"])
        out.append(res.params["w"])
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.parametrize("mode", ["coordinate_median", "trimmed_mean"])
def test_robust_fold_over_compressed_reports(mode):
    base = {"w": np.random.default_rng(5).standard_normal(
        32).astype(np.float32)}
    got = privacy.RobustPolicy(mode=mode, trim_ratio=0.2).fold_reports(
        {r: (float(r), _updates(wire, "topk:0.25", base, r))
         for r in range(1, 6)})
    want = jprivacy.RobustPolicy(mode=mode, trim_ratio=0.2).fold_reports(
        {r: (float(r), _updates(jwire, "topk:0.25", base, r))
         for r in range(1, 6)})
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0]["w"], want[0]["w"])


# ---------------------------------------------------------------------------
# the residual store
# ---------------------------------------------------------------------------
def _store_template():
    return {"w": torch.zeros(3, 2), "b": torch.zeros(2)}


def _mark(ids):
    """Rows whose values name their owner id."""
    return {"w": torch.stack([torch.full((3, 2), float(i)) for i in ids]),
            "b": torch.stack([torch.full((2,), float(i)) for i in ids])}


@pytest.mark.parametrize("dense", [True, False])
def test_residual_store_keys_by_id(dense):
    store = integ.ResidualStore(_store_template(), num_clients=10,
                                dense=dense)
    assert store.dense == dense
    store.scatter([3, 7, 1], _mark([3, 7, 1]))
    store.scatter([7, 2], _mark([70, 2]))
    assert float(store.peek(7)["w"][0, 0]) == 70.0
    for c in (3, 1, 2):
        assert float(store.peek(c)["w"][0, 0]) == float(c)
    for c in (0, 4, 5, 6, 8, 9):
        assert float(store.peek(c)["w"].abs().max()) == 0.0
    got = store.gather([2, 3, 9])
    assert [float(got["b"][i, 0]) for i in range(3)] == [2.0, 3.0, 0.0]
    store.scatter([4, 4], _mark([40, 41]))  # a repeated id: last wins
    assert float(store.peek(4)["b"][1]) == 41.0


def test_residual_store_backings_agree():
    dense = integ.ResidualStore(_store_template(), num_clients=6, dense=True)
    sparse = integ.ResidualStore(_store_template())
    assert dense.dense and not sparse.dense
    small = integ.ResidualStore(_store_template(), num_clients=6,
                                dense_cap_gb=1e-9)
    assert not small.dense
    for ids in ([1, 4], [4, 2, 0], [5]):
        upd = _mark([10 * i + 1 for i in ids])
        dense.scatter(ids, upd)
        sparse.scatter(ids, upd)
    for c in range(6):
        for k in ("w", "b"):
            assert torch.equal(dense.peek(c)[k], sparse.peek(c)[k])
    for k in ("w", "b"):
        assert torch.equal(dense.gather([5, 3, 1])[k],
                           sparse.gather([5, 3, 1])[k])


# ---------------------------------------------------------------------------
# the codec leg of the round program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["topk:0.01", "qsgd", "signsgd",
                                  "randk:0.1", "none"])
def test_codec_leg_and_manifest_are_the_reference_ones(spec):
    from fedml_tpu.program.codec import CodecSpec as JaxCodecSpec
    cs, jcs = CodecSpec.coerce(spec), JaxCodecSpec.coerce(spec)
    assert (cs.spec, cs.enabled, cs.name) == (jcs.spec, jcs.enabled,
                                              jcs.name)
    assert repr(cs.device()) == repr(jcs.device())
    if spec == "randk:0.1":
        with pytest.raises(ValueError, match="randk"):
            cs.host()
    else:
        assert repr(cs.host()) == repr(jcs.host())
        assert cs.host_ef() == jcs.host_ef()
    # a program built from a compressor instance, as FedAvgAPI builds it
    args = types.SimpleNamespace(compressor=spec)
    dev, jdev = cs.device(), jcs.device()
    prog = RoundProgram.from_args(args, codec=dev if dev else "none")
    jprog = JaxProgram.from_args(args, codec=jdev if jdev else "none")
    assert json.dumps(prog.manifest(), sort_keys=True) == json.dumps(
        jprog.manifest(), sort_keys=True)
    assert RoundProgram.from_manifest(prog.manifest()) == prog
    host = prog.host_view()
    assert host.codec is prog.codec
    if spec != "randk:0.1":
        assert repr(host.host_codec()) == repr(
            jprog.host_view().host_codec())
    assert dataclasses.asdict(prog.codec) == {"spec": prog.codec.spec}


def test_lstm_bytes_are_counted_under_the_port_names():
    """The LSTMs' leaves do not map one to one (the port fuses flax's
    eight gate leaves of a cell into ``weight_ih``/``weight_hh``/
    ``bias_hh``), so their updates are compressed and counted under the
    port's names: fewer bytes than the reference counts (ROADMAP §C)."""
    from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg
    from fedml_tpu_torch.utils.torch_import import (module_state,
                                                    reference_names,
                                                    rnn_state_to_variables)

    params = module_state(RNNOriginalFedAvg())["params"]
    variables = rnn_state_to_variables({"params": params})
    assert reference_names(params) is None
    assert reference_tree(params) is params
    for spec in ("topk:0.01", "signsgd"):
        got = integ.compressed_payload_nbytes(comps.get_compressor(spec),
                                              params)
        want = jinteg.compressed_payload_nbytes(jcomps.get_compressor(spec),
                                                variables["params"])
        assert 0 < want - got < 0.05 * want
