"""FedSeg's modules against the JAX package on the CPU: the learning-rate
schedules and the confusion-matrix metrics bit for bit, the segmentation
LDA and the synthetic and VOC loaders array for array, DeepLab's logits
at both output strides and both presets (their widths are fixed, so on
16x16 images) within 1e-4 through the CV carrier (exact both ways),
``F.interpolate`` against ``jax.image.resize``, and one FedSeg round
with a poly schedule, through SGD and through AMSGrad (``--client_optimizer
adam``), against the reference's ``FedSegAPI`` from a carried init within
1e-4 on the global state and the records. The
clients' shards are whole batches: BatchNorm over a zero-padded batch is
ill-conditioned in the reference's fp32 (ROADMAP §C).

The reference's jax-free cases of ``tests/test_fedseg.py`` run
retargeted at the port; its cases whose bodies call jax have
counterparts here with the same asserts."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from reference_scenarios import retarget
from seeded_variables import seeded_variables

from fedml_tpu.core import partition as jpartition
from fedml_tpu.core import seg_eval as jseg
from fedml_tpu.data import synthetic as jsynthetic
from fedml_tpu.data import voc as jvoc
from fedml_tpu.models import deeplab as jdeeplab
from fedml_tpu.utils import schedules as jschedules
from fedml_tpu_torch.core import partition, seg_eval
from fedml_tpu_torch.data import registry, synthetic, voc
from fedml_tpu_torch.models import deeplab
from fedml_tpu_torch.utils import schedules
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)

TOL = 1e-4

# -- the reference's own cases, through the port ------------------------------
_seg = retarget("test_fedseg.py")
TestEvaluator = _seg.TestEvaluator
TestSchedules = _seg.TestSchedules
TestVOCLoader = _seg.TestVOCLoader


def test_the_retargeted_scenarios_run_the_port():
    assert _seg.Evaluator is seg_eval.Evaluator
    assert _seg.make_lr_schedule is schedules.make_lr_schedule


# -- schedules and metrics, bit for bit ---------------------------------------

#: ulps a schedule may differ by: step is bit for bit; XLA's CPU ``cos``
#: and ``pow`` round differently from torch's (neither is correctly
#: rounded) in at most 2 of these 70 steps, by one ulp, or two for cos
#: near the horizon, where ``1 + cos`` cancels
SCHEDULE_ULPS = {"step": 0, "cos": 2, "poly": 1}


@pytest.mark.parametrize("mode,kw", [
    ("poly", {}), ("cos", {}), ("step", {"lr_step": 2}),
    ("poly", {"warmup_epochs": 1}), ("cos", {"warmup_epochs": 2}),
    ("step", {"lr_step": 1, "warmup_epochs": 1})])
def test_schedule_is_the_reference(mode, kw):
    steps = np.arange(0, 70, dtype=np.int32)
    want = np.asarray(jschedules.make_lr_schedule(mode, 0.07, 6, 9, **kw)(
        jnp.asarray(steps)))
    got = schedules.make_lr_schedule(mode, 0.07, 6, 9, **kw)(
        torch.as_tensor(steps)).numpy()
    assert got.dtype == want.dtype == np.float32
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= SCHEDULE_ULPS[mode], (ulps.max(), mode)
    assert np.count_nonzero(ulps) <= 2


def test_confusion_and_metrics_are_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    gt = rng.integers(-1, 6, (4, 9, 9))
    gt[0, 0, :3] = 255
    pred = rng.integers(0, 5, (4, 9, 9))
    mask = np.array([[1.0] * 81, [0.0] * 81, [1.0] * 81, [1.0] * 81])
    want = np.asarray(jseg.confusion_matrix(
        jnp.asarray(gt), jnp.asarray(pred), 5, jnp.asarray(mask)))
    got = seg_eval.confusion_matrix(torch.as_tensor(gt),
                                    torch.as_tensor(pred), 5,
                                    torch.as_tensor(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    jev, ev = jseg.Evaluator(5), seg_eval.Evaluator(5)
    jev.add_batch(gt, pred)
    ev.add_batch(gt, pred)
    ev.add_matrix(got)
    jev.add_matrix(want)
    assert ev.metrics() == jev.metrics()


# -- partition and loaders, array for array -----------------------------------

def test_segmentation_lda_is_the_reference():
    rng = np.random.default_rng(1)
    present = [sorted(set(rng.integers(0, 6, rng.integers(1, 4)).tolist()))
               for _ in range(200)]
    want = jpartition.non_iid_partition_with_dirichlet_distribution(
        present, 4, 6, 0.5, task="segmentation", seed=3)
    got = partition.non_iid_partition_with_dirichlet_distribution(
        present, 4, 6, 0.5, task="segmentation", seed=3)
    assert sorted(got) == sorted(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_synthetic_segmentation_is_the_reference():
    kw = dict(client_num=3, n_train=30, n_test=9, image_size=12,
              class_num=4, seed=2)
    got = synthetic.load_synthetic_segmentation(**kw)
    want = jsynthetic.load_synthetic_segmentation(**kw)
    for g, w in zip(got, want):
        _equal(g, w)
    args = types.SimpleNamespace(client_num_in_total=3, seed=2, n_train=30,
                                 n_test=9, image_size=12)
    from fedml_tpu.data import registry as jregistry
    for g, w in zip(registry.load_dataset(args, "synthetic_segmentation"),
                    jregistry.load_dataset(args, "synthetic_segmentation")):
        _equal(g, w)


@pytest.mark.parametrize("size", [12, 9])
def test_voc_loader_is_the_reference(tmp_path, size):
    root = str(TestVOCLoader()._voc_tree(tmp_path, n=8, size=12))
    got = voc.load_voc_federated(root, client_num=2, image_size=size,
                                 seed=1)
    want = jvoc.load_voc_federated(root, client_num=2, image_size=size,
                                   seed=1)
    for g, w in zip(got, want):
        _equal(g, w)


# -- DeepLab ------------------------------------------------------------------

def _carried(jmodel, x, seed=0):
    return seeded_variables(jmodel, x, seed, train=False)


def _port_apply(model, state, x, train):
    tensors = {**state["params"],
               **{k: v.clone() for k, v in state["batch_stats"].items()}}
    with torch.no_grad():
        return functional_call(model, tensors, (torch.as_tensor(x),),
                               {"train": train}).numpy()


@pytest.mark.parametrize("backbone", ["mobilenet", "resnet"])
@pytest.mark.parametrize("outstride", [8, 16])
def test_deeplab_logits_are_the_reference(backbone, outstride):
    # 32x32 at batch 4: the stride-16 encoder's BatchNorm sees 16 values
    # a channel (at 16x16 and batch 2 only 2, and fp32 noise then moves
    # the train-mode logits by 4e-4 in either package)
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    jm = jdeeplab.DeepLab(num_classes=5, backbone=backbone,
                          output_stride=outstride)
    v = _carried(jm, x)
    state = cv_variables_to_state(v)
    rt = cv_state_to_variables(state)
    assert jax.tree.structure(rt) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(rt), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    model = deeplab.DeepLab(num_classes=5, backbone=backbone,
                            output_stride=outstride)
    assert sorted(model.state_dict()) == sorted(
        list(state["params"]) + list(state["batch_stats"]))
    want_train, _ = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    want_eval = jm.apply(v, jnp.asarray(x), train=False)
    np.testing.assert_allclose(_port_apply(model, state, x, True),
                               np.asarray(want_train), atol=TOL)
    np.testing.assert_allclose(_port_apply(model, state, x, False),
                               np.asarray(want_eval), atol=TOL)


@pytest.mark.parametrize("src,dst", [((1, 1), (4, 4)), ((2, 3), (8, 12)),
                                     ((4, 4), (16, 16)), ((3, 5), (7, 9))])
def test_bilinear_upsampling_is_jax_image_resize(src, dst):
    x = np.random.default_rng(5).normal(size=(2,) + src + (3,)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,),
                            method="bilinear")
    got = deeplab.bilinear(torch.as_tensor(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6)


# counterpart of test_fedseg.py::TestDeepLab::test_logit_shapes
@pytest.mark.parametrize("outstride", [8, 16])
def test_logit_shapes(outstride):
    m = deeplab.DeepLab(num_classes=5, output_stride=outstride)
    out = m(torch.zeros((2, 32, 32, 3)), train=False)
    assert out.shape == (2, 32, 32, 5)


# -- one FedSeg round against the reference -----------------------------------

def _args(**kw):
    base = dict(client_num_in_total=4, client_num_per_round=4, comm_round=1,
                epochs=1, batch_size=8, lr=0.1, client_optimizer="sgd",
                wd=1e-4, frequency_of_the_test=1, ci=0, seed=0,
                lr_scheduler="poly", lr_step=0, warmup_epochs=0,
                device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


#: the AMSGrad round's base lr (the SGD round's is 0.1)
ADAM_LR = 1e-3


@pytest.fixture(scope="module", params=["sgd", "adam"])
def fedseg_round(request):
    from fedml_tpu.algorithms.fedseg import FedSegAPI as JFedSegAPI
    from fedml_tpu.algorithms.specs import make_segmentation_spec as jspec
    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
    from fedml_tpu_torch.algorithms.specs import make_segmentation_spec

    ds = jsynthetic.load_synthetic_segmentation(
        client_num=4, n_train=64, n_test=16, image_size=16, class_num=3)
    jm = jdeeplab.DeepLab(num_classes=3, backbone="mobilenet")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("FEDML_TPU_PACKING", "python")
        spec = jspec(jm, jnp.asarray(ds[2]["x"][:1]), num_classes=3)
        # numpy-drawn variables (flax's eager init takes seconds here)
        seeded = _carried(jm, ds[2]["x"][:1])
        spec = dataclasses.replace(
            spec, init_fn=lambda rng: jax.tree.map(jnp.asarray, seeded))
        args = _args(client_optimizer=request.param,
                     lr=0.1 if request.param == "sgd" else ADAM_LR)
        japi = JFedSegAPI(ds, spec, args)
        init = jax.tree.map(np.array, japi.global_state)
        jrec = japi.train_one_round()
        jrec.update(japi.evaluate_global())
        api = FedSegAPI(ds, make_segmentation_spec(
            deeplab.DeepLab(num_classes=3, backbone="mobilenet"),
            num_classes=3), args)
        api.global_state = cv_variables_to_state(init)
        rec = api.train_one_round()
        rec.update(api.evaluate_global())
    finally:
        mp.undo()
    return japi, api, init, jrec, rec


#: AMSGrad divides each step by the gradient's own size, so a weight whose
#: gradient lies within fp32 rounding of 0 (or whose second step nearly
#: cancels its first) moves by a rounding-sized share of the lr in either
#: package: at one thread 1 of 551,155 weights lay 1.9e-4 apart, 12 past
#: 1e-5, the 99.9th percentile 6.6e-7. Under AMSGrad a weight may pass
#: TOL, a 1e-4 share of them at most and none by an lr; a wrong schedule
#: or count moves nearly every weight past TOL
ADAM_OUTLIERS = 1e-4


def test_fedseg_round_state_is_the_reference(fedseg_round):
    japi, api, init, _, _ = fedseg_round
    want = cv_variables_to_state(jax.tree.map(np.asarray,
                                              dict(japi.global_state)))
    start = cv_variables_to_state(init)
    moved = max(float((want["params"][k] - start["params"][k]).abs().max())
                for k in want["params"])
    assert moved > 10 * TOL
    adam = api.args.client_optimizer == "adam"
    outliers = count = 0
    for coll in ("params", "batch_stats"):
        assert sorted(api.global_state[coll]) == sorted(want[coll])
        for k, w in want[coll].items():
            err = (api.global_state[coll][k] - w).abs()
            if adam and coll == "params":
                outliers += int((err > TOL).sum())
                count += err.numel()
                assert float(err.max()) < ADAM_LR, (k, float(err.max()))
            else:
                assert float(err.max()) <= TOL, (coll, k, float(err.max()))
    assert outliers <= ADAM_OUTLIERS * count, (outliers, count)


def test_fedseg_round_records_are_the_reference(fedseg_round):
    _, api, _, jrec, rec = fedseg_round
    assert api.checkpoint_metric == "Seg/mIoU"
    assert sorted(rec) == sorted(jrec)
    for key in jrec:
        if key not in ("round", "round_time_s"):
            np.testing.assert_allclose(rec[key], jrec[key], atol=TOL,
                                       err_msg=key)


# counterparts of test_fedseg.py::TestFedSegRound
def test_federated_segmentation_learns():
    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
    from fedml_tpu_torch.algorithms.specs import make_segmentation_spec

    ds = synthetic.load_synthetic_segmentation(client_num=4, n_train=64,
                                               n_test=16, image_size=16,
                                               class_num=3)
    model = deeplab.DeepLab(num_classes=3, backbone="mobilenet")
    spec = make_segmentation_spec(model, num_classes=3)
    api = FedSegAPI(ds, spec, _args(comm_round=3, lr=0.1, wd=0.0,
                                    client_num_per_round=4))
    api.train()
    ev = api.evaluate_global()
    assert {"Seg/Acc", "Seg/mIoU", "Seg/FWIoU",
            "Seg/AccClass"} <= set(ev)
    assert ev["Seg/Acc"] > 0.5          # background majority is learnable
    assert api.history[-1]["Train/mIoU"] >= 0.0


def test_main_fedseg_cli():
    from fedml_tpu_torch.experiments import main_fedseg
    api, _ = main_fedseg.main(
        ["--dataset", "synthetic_segmentation", "--backbone", "mobilenet",
         "--lr", "0.1", "--n_train", "48", "--n_test", "16",
         "--image_size", "16", "--client_num_in_total", "4",
         "--client_num_per_round", "2", "--comm_round", "2",
         "--epochs", "1", "--batch_size", "8",
         "--frequency_of_the_test", "1", "--ci", "1", "--platform", "cpu"])
    assert api.round_idx == 2


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_scheduled_sgd_counts_each_client_as_optax(momentum):
    """A schedule as SGD's ``lr``: each stacked client's count starts at
    0 and moves only on its valid steps, as optax's ``sgd(schedule)``
    vmapped over clients whose masked steps keep their state."""
    import optax
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 _select, make_optimizer)
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(2, 6)).astype(np.float32)
    grads = rng.normal(size=(4, 2, 6)).astype(np.float32)
    valid = np.array([[1, 1], [1, 0], [0, 1], [1, 1]], bool)
    jsched = jschedules.make_lr_schedule("poly", 0.1, 1, 4)
    tx = optax.chain(optax.add_decayed_weights(1e-3),
                     optax.sgd(jsched, momentum=momentum or None))

    def jstep(g, s, p, ok):
        u, s2 = tx.update(g, s, p)
        return jax.tree.map(lambda a, b: jnp.where(ok, a, b),
                            (optax.apply_updates(p, u), s2), (p, s))

    jp, js = jnp.asarray(p0), jax.vmap(tx.init)(jnp.asarray(p0))
    opt = make_optimizer(ClientUpdateConfig(
        lr=schedules.make_lr_schedule("poly", 0.1, 1, 4), weight_decay=1e-3,
        momentum=momentum))
    tp = {"w": torch.as_tensor(p0)}
    ts = opt.init(tp, (2,))
    for g, ok in zip(grads, valid):
        jp, js = jax.vmap(jstep)(jnp.asarray(g), js, jp, jnp.asarray(ok))
        new = opt.update({"w": torch.as_tensor(g)}, ts, tp)
        tp, ts = _select(torch.as_tensor(ok), new, (tp, ts))
    np.testing.assert_array_equal(ts["count"].numpy(), valid.sum(0))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp), atol=1e-6)


def test_scheduled_amsgrad_counts_each_client_as_optax():
    """A schedule as AMSGrad's ``lr`` (FedSeg's ``--client_optimizer
    adam``): read at each stacked client's own count before its
    increment, as ``optax.amsgrad(schedule)`` vmapped over clients whose
    masked steps keep their state."""
    import optax
    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 _select, make_optimizer)
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(2, 6)).astype(np.float32)
    grads = rng.normal(size=(4, 2, 6)).astype(np.float32)
    valid = np.array([[1, 1], [1, 0], [0, 1], [1, 1]], bool)
    jsched = jschedules.make_lr_schedule("poly", 0.1, 1, 4)
    tx = optax.chain(optax.add_decayed_weights(1e-3), optax.amsgrad(jsched))

    def jstep(g, s, p, ok):
        u, s2 = tx.update(g, s, p)
        return jax.tree.map(lambda a, b: jnp.where(ok, a, b),
                            (optax.apply_updates(p, u), s2), (p, s))

    jp, js = jnp.asarray(p0), jax.vmap(tx.init)(jnp.asarray(p0))
    opt = make_optimizer(ClientUpdateConfig(
        optimizer="adam", lr=schedules.make_lr_schedule("poly", 0.1, 1, 4),
        weight_decay=1e-3))
    tp = {"w": torch.as_tensor(p0)}
    ts = opt.init(tp, (2,))
    for g, ok in zip(grads, valid):
        jp, js = jax.vmap(jstep)(jnp.asarray(g), js, jp, jnp.asarray(ok))
        new = opt.update({"w": torch.as_tensor(g)}, ts, tp)
        tp, ts = _select(torch.as_tensor(ok), new, (tp, ts))
    np.testing.assert_array_equal(ts["count"].numpy(), valid.sum(0))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp), atol=1e-6)
