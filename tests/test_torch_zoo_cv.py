"""The port's CV zoo -- ResNetGN, MobileNet, MobileNetV3, EfficientNet and
VGG -- against the JAX package's flax modules through the CV carrier
(``utils/torch_import.py`` ``cv_variables_to_state``).

Each configuration's weights are drawn once (module scope) by the
port's initialiser, their norm parameters and running statistics
spread by a seeded perturbation, and carried to flax; the flax tree must
have the structure and shapes of ``jax.eval_shape(module.init)``, so the
parameter counts are flax's (``zoo_cv_cases.py``). Tolerances:

- eval logits at full width (batch 2, 32x32; VGG16 with BatchNorm at
  64x64, where the flatten order shows, and ResNet-50 with the 7x7/2
  stem): max
  difference within 1e-5 of max |logit| (fp32);
- the train-mode forward of MobileNet, whose class has no narrower
  configuration, at full width (batch 2, 64x64, so that its last
  BatchNorm sees 8 values): logits and new BatchNorm statistics within
  1e-4 of their largest magnitude (the other families' training steps,
  with gradients, are ``test_torch_zoo_cv_step.py``'s);
- carrier round trips bit-exact in both directions;
- bf16 compute (``--model_dtype bf16``) in eval: fp32 parameters, fp32
  logits within 0.1 of max |logit| of the fp32 forward and not equal to
  it.

The dropout masks, which the two frameworks draw differently, are
checked on their own: shapes, keep rate, the ``1 / keep`` scaling,
repeatable for a seed, absent in eval. The reference's own model cases
(``tests/test_models.py``, all ``slow`` there) are restated in torch
idiom below, ``slow`` as there."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch import models as T
from fedml_tpu_torch.models.efficientnet import round_filters, round_repeats
from fedml_tpu_torch.models.factory import create_model
from fedml_tpu_torch.models.layers import (drop_path, flax_group_norm,
                                           lecun_init_)
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state,
                                                module_state,
                                                reference_names,
                                                reference_tree)
from zoo_cv_cases import (BF16_TOL, FULL, LOGIT_TOL, STEP_TOL, _Case,
                          _close, _x)

@pytest.fixture(scope="module")
def full():
    cache = {}

    def get(name):
        if name not in cache:
            jm, tm, shape = FULL[name]
            cache[name] = _Case(jm(), tm(), shape)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(FULL))
def test_eval_logits_match_flax(full, name):
    case = full(name)
    want = jax.jit(case.jm.apply)(case.variables, jnp.asarray(case.x))
    got, _ = case.port()
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), LOGIT_TOL, name)


def test_train_forward_and_statistics_match_flax(full):
    name = "mobilenet"
    case = full(name)
    x = _x((2, 64, 64, 3), seed=5)
    want, mut = jax.jit(lambda v, x: case.jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(case.variables,
                                                    jnp.asarray(x))
    got, stats = case.port(x=x, train=True)
    _close(got.numpy(), np.asarray(want), STEP_TOL, name)
    want_stats = cv_variables_to_state(
        {"params": {}, **jax.tree.map(np.asarray, mut)})
    assert sorted(want_stats["batch_stats"]) == sorted(stats)
    for k, v in want_stats["batch_stats"].items():
        _close(stats[k].numpy(), v.numpy(), STEP_TOL, k)


@pytest.mark.parametrize("name", sorted(FULL))
def test_parameter_counts_are_flax_ones(full, name):
    case = full(name)
    assert sum(p.numel() for p in case.tm.parameters()) == case.flax_count
    # GroupNorm is stateless: the GN ResNets keep no batch_stats
    assert ("batch_stats" in case.variables) == (name in (
        "mobilenet", "mobilenet_v3_large",
        "mobilenet_v3_small", "efficientnet_b0", "vgg16_bn_64px"))


@pytest.mark.parametrize("name", sorted(FULL))
def test_carrier_round_trips_are_exact(full, name):
    case = full(name)
    back = cv_variables_to_state(case.variables)
    for part in ("params", "batch_stats"):
        assert sorted(back[part]) == sorted(case.state[part])
        for k, v in case.state[part].items():
            torch.testing.assert_close(back[part][k], v, rtol=0, atol=0)
    again = cv_state_to_variables(back)
    assert jax.tree.structure(again) == jax.tree.structure(case.variables)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(case.variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(FULL))
def test_reference_names_are_the_flax_paths(full, name):
    """The compression layer counts bytes under the reference's names
    (``reference_tree``): each port parameter maps to its flax path."""
    case = full(name)
    paths = reference_names(case.state["params"])
    want = {path for path, _ in _leaf_paths(case.variables["params"])}
    assert set(paths.values()) == want and len(paths) == len(want)
    tree = reference_tree(case.state["params"])
    for k, path in paths.items():
        node = tree
        for part in path:
            node = node[part]
        assert node is case.state["params"][k]


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_carrier_maps_flax_names_and_layouts(full):
    """The named layouts: a depthwise kernel ``[kh, kw, 1, C]`` becomes
    ``[C, 1, kh, kw]``, a Dense kernel is transposed, ``scale`` is
    ``weight``, the statistics are the running ones."""
    v = full("mobilenet_v3_large").variables
    s = cv_variables_to_state(v)
    dw = v["params"]["bneck4"]["dw"]["kernel"]
    assert dw.shape == (5, 5, 1, 120)
    np.testing.assert_array_equal(s["params"]["bneck4.dw.weight"].numpy(),
                                  np.transpose(dw, (3, 2, 0, 1)))
    fc1 = v["params"]["bneck4"]["se"]["fc1"]
    np.testing.assert_array_equal(s["params"]["bneck4.se.fc1.weight"].numpy(),
                                  fc1["kernel"].T)
    np.testing.assert_array_equal(s["params"]["bn_stem.weight"].numpy(),
                                  v["params"]["bn_stem"]["scale"])
    np.testing.assert_array_equal(
        s["batch_stats"]["bn_stem.running_var"].numpy(),
        v["batch_stats"]["bn_stem"]["var"])
    names = set(cv_variables_to_state(full("efficientnet_b0").variables)
                ["params"])
    assert {"block2_1.se_reduce.weight", "head.weight",
            "block0_0.dw.weight"} <= names
    assert "block0_0.expand.weight" not in names  # expand ratio 1
    names = set(full("resnet50_gn_large_stem").state["params"])
    # stage 1's first bottleneck has a downsample branch at stride 1
    assert "layer1_block0.downsample_conv.weight" in names
    assert "layer1_block1.downsample_conv.weight" not in names


@pytest.mark.parametrize("name", sorted(FULL))
def test_bf16_compute_keeps_fp32_masters_and_logits(full, name):
    case = full(name)
    model = FULL[name][1](dtype=torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in
               case.state["params"].values())
    got, _ = case.port(dtype_model=model)
    want, _ = case.port()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert not torch.equal(got, want)
    _close(got.numpy(), want.numpy(), BF16_TOL, name)


def test_group_norm_is_flax_group_norm():
    """GroupNorm against flax's at group sizes 1, 4 and 32 on inputs of
    mean 2: the output within 1e-5 of its largest magnitude (fp32), and
    the gradients of a seeded projection of it with respect to input,
    scale and bias within 1e-5 of theirs (against ``jax.grad`` in
    float64)."""
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    x = (2.0 + rng.normal(size=(3, 4, 4, 64))).astype(np.float32)
    up = rng.normal(size=x.shape).astype(np.float32)
    for gs in (1, 4, 32):
        gn = fnn.GroupNorm(num_groups=None, group_size=gs, epsilon=1e-5)
        scale = rng.normal(size=64).astype(np.float32)
        bias = rng.normal(size=64).astype(np.float32)
        want = gn.apply({"params": {"scale": scale, "bias": bias}},
                        jnp.asarray(x))
        with jax.enable_x64(True):
            f = lambda a, s, b: (gn.apply({"params": {"scale": s, "bias": b}},
                                          a) * up).sum()
            grads = jax.tree.map(np.asarray, jax.grad(f, argnums=(0, 1, 2))(
                *(jnp.asarray(a, jnp.float64) for a in (x, scale, bias))))
        xt, st, bt = (torch.tensor(a, requires_grad=True)
                      for a in (x, scale, bias))
        got = flax_group_norm(xt.permute(0, 3, 1, 2), st, bt, gs,
                              torch.float32).permute(0, 2, 3, 1)
        _close(got.detach().numpy(), np.asarray(want), 1e-5, gs)
        (got * torch.as_tensor(up)).sum().backward()
        for t, g in zip((xt, st, bt), grads):
            _close(t.grad.numpy(), g, 1e-5, gs)


# -- dropout masks, on their own ---------------------------------------------

MASKED = {
    "vgg": lambda: T.vgg11(class_num=10, classifier_dims=(512, 256)),
    "efficientnet_b0": lambda: T.efficientnet("efficientnet-b0",
                                              num_classes=10),
    "mobilenet_v3_dropout": lambda: T.MobileNetV3(
        "SMALL", num_classes=10, multiplier=0.25, dropout_rate=0.2),
}


def _draw(model, n, seed):
    return model.draw_dropout_masks(n, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", sorted(MASKED))
def test_mask_shapes_and_keep_rates(name):
    model = MASKED[name]()
    n = 2048
    masks = _draw(model, n, 0)
    assert list(masks) == list(model._mask_specs)
    for key, (shape, rate) in model._mask_specs.items():
        m = masks[key]
        assert m.shape == (n,) + tuple(shape) and m.dtype == torch.float32
        assert set(m.unique().tolist()) <= {0.0, 1.0}
        # four standard deviations of the mean of m.numel() draws
        tol = 4 * (rate * (1 - rate) / m.numel()) ** 0.5
        assert abs(float(m.mean()) - (1.0 - rate)) <= tol, key


def test_mask_keys_follow_the_reference():
    vgg = T.vgg16(class_num=10)
    assert {k: v for k, v in vgg._mask_specs.items()} == {
        "fc0": ((4096,), 0.5), "fc1": ((4096,), 0.5)}
    eff = T.efficientnet("efficientnet-b0", num_classes=10)
    assert eff._mask_specs["head"] == ((1280,), 0.2)
    # drop-connect only on residual blocks, at 0.2 * idx / 16
    blocks = {k: v for k, v in eff._mask_specs.items() if k != "head"}
    assert "block0_0" not in blocks and "block1_0" not in blocks
    assert blocks["block1_1"] == ((), 0.2 * 2 / 16)
    assert blocks["block5_3"] == ((), 0.2 * 14 / 16)
    assert len(blocks) == 9
    assert T.MobileNetV3(num_classes=10)._mask_specs == {}


@pytest.mark.parametrize("name", sorted(MASKED))
def test_masks_repeat_for_a_seed(name):
    model = MASKED[name]()
    a, b, c = _draw(model, 8, 3), _draw(model, 8, 3), _draw(model, 8, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_masks_scale_kept_activations_by_one_over_keep():
    """VGG (no BN) trained on all-ones masks equals its evaluation with
    the layers after each dropout scaled by ``1 / keep``; all-zero masks
    cut the classifier off (logits = head bias)."""
    model = T.vgg11(class_num=10, classifier_dims=(32, 16), dropout_rate=0.25)
    lecun_init_(model, torch.Generator().manual_seed(0))
    state = module_state(model)["params"]
    state["head.bias"] = torch.arange(10.0)
    x = torch.as_tensor(_x((3, 32, 32, 3)))
    call = lambda p, **kw: torch.func.functional_call(model, p, (x,), kw)
    ones = {k: torch.ones_like(v) for k, v in _draw(model, 3, 0).items()}
    scaled = dict(state)
    for name in ("fc1.weight", "head.weight"):
        scaled[name] = state[name] / 0.75
    torch.testing.assert_close(call(state, train=True, dropout_masks=ones),
                               call(scaled), rtol=1e-5, atol=1e-5)
    zeros = {k: torch.zeros_like(v) for k, v in ones.items()}
    torch.testing.assert_close(call(state, train=True, dropout_masks=zeros),
                               torch.arange(10.0).expand(3, 10))
    keep = torch.tensor([1.0, 0.0, 1.0])
    y = torch.ones(3, 2, 4, 4)
    torch.testing.assert_close(drop_path(y, keep, 0.2),
                               keep[:, None, None, None] * y / 0.8)


@pytest.mark.parametrize("name", sorted(MASKED))
def test_masks_are_absent_in_eval_and_required_in_training(name):
    model = MASKED[name]()
    lecun_init_(model, torch.Generator().manual_seed(0))
    x = torch.as_tensor(_x((2, 32, 32, 3)))
    with torch.no_grad():
        plain = model(x)
        zeros = {k: torch.zeros_like(v)
                 for k, v in _draw(model, 2, 0).items()}
        torch.testing.assert_close(model(x, dropout_masks=zeros), plain,
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="dropout masks"):
            model(x, train=True)
    assert not hasattr(T.vgg11(dropout_rate=0.0), "draw_dropout_masks")
    assert not hasattr(T.MobileNetV3(num_classes=10), "draw_dropout_masks")


# -- the factory --------------------------------------------------------------

FACTORY = [("resnet18_gn", T.ResNetGN), ("resnet34_gn", T.ResNetGN),
           ("resnet50_gn", T.ResNetGN), ("mobilenet", T.MobileNet),
           ("mobilenet_v3", T.MobileNetV3), ("efficientnet", T.EfficientNet),
           ("efficientnet-b3", T.EfficientNet), ("vgg11", T.VGG),
           ("vgg13", T.VGG), ("vgg16", T.VGG), ("vgg19", T.VGG)]


@pytest.mark.parametrize("name,cls", FACTORY)
def test_factory_builds_the_zoo_with_bf16_threaded(name, cls):
    args = types.SimpleNamespace(model_dtype="bf16")
    model = create_model(args, name, 10, input_shape=(32, 32, 3))
    assert isinstance(model, cls)
    dtypes = {m.dtype for m in model.modules() if hasattr(m, "dtype")}
    assert dtypes == {torch.bfloat16}


def test_factory_reads_the_reference_knobs():
    args = types.SimpleNamespace(group_norm_channels=0, model_mode="SMALL",
                                 vgg_bn=True, model_dtype=None)
    assert create_model(args, "resnet18_gn", 10).group_norm == 0
    assert create_model(None, "resnet18_gn", 10).group_norm == 32
    assert create_model(args, "mobilenet_v3", 10).n_bneck == 11
    assert create_model(None, "mobilenet_v3", 10).n_bneck == 15
    assert create_model(args, "vgg11", 10).batch_norm
    assert not create_model(None, "vgg11", 10).batch_norm
    # the first conv from the input's channels, VGG's fc0 from its size
    assert create_model(None, "mobilenet", 10,
                        input_shape=(28, 28)).conv1.weight.shape[1] == 1
    assert create_model(None, "vgg11", 10, input_shape=(64, 64, 3)
                        ).fc0.weight.shape == (4096, 2 * 2 * 512)
    # the sequence models see a 1-D sample shape through the mains
    for name in ("transformer", "rnn", "rnn_stackoverflow"):
        assert create_model(None, name, 90, input_shape=(20,)) is not None
    eff = create_model(None, "efficientnet-b4", 7)
    assert eff.dropout_rate == 0.4 and eff.fc.weight.shape[0] == 7
    with pytest.raises(ValueError, match="model_name should be one of"):
        create_model(None, "efficientnet-b9", 10)
    with pytest.raises(ValueError, match="unknown model"):
        create_model(None, "resnet19_gn", 10)


@pytest.mark.parametrize("name", ["resnet34_gn", "efficientnet-b3"])
def test_factory_parameter_counts_are_flax_ones(name):
    from fedml_tpu.models.factory import create_model as jax_create_model

    x = jnp.zeros((1, 32, 32, 3))
    abstract = jax.eval_shape(jax_create_model(None, name, 10).init,
                              jax.random.PRNGKey(0), x)
    want = sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(abstract["params"]))
    model = create_model(None, name, 10, input_shape=(32, 32, 3))
    assert sum(p.numel() for p in model.parameters()) == want


# -- the reference's model cases (tests/test_models.py), in torch idiom -------

def _apply(model, x, train=False):
    lecun_init_(model, torch.Generator().manual_seed(0))
    st = module_state(model)
    masks = ({k: v for k, v in model.draw_dropout_masks(
        x.shape[0], torch.Generator().manual_seed(1)).items()}
        if train and hasattr(model, "draw_dropout_masks") else None)
    kw = {"train": train}
    if masks is not None:
        kw["dropout_masks"] = masks
    out = torch.func.functional_call(
        model, {**st["params"], **st["batch_stats"]}, (x,), kw)
    return out, st


@pytest.mark.slow
class TestReferenceModelCases:
    def test_resnet18_gn_forward_no_batch_stats(self):
        out, st = _apply(T.resnet18_gn(class_num=100, group_norm=32),
                         torch.zeros(2, 24, 24, 3), train=True)
        assert not st["batch_stats"]
        assert out.shape == (2, 100)

    def test_resnet18_bn_mode(self):
        _, st = _apply(T.resnet18_gn(class_num=10, group_norm=0),
                       torch.zeros(1, 32, 32, 3))
        assert st["batch_stats"]

    def test_mobilenet_forward(self):
        out, st = _apply(T.MobileNet(num_classes=10),
                         torch.zeros(2, 32, 32, 3), train=True)
        assert out.shape == (2, 10) and st["batch_stats"]

    @pytest.mark.parametrize("mode", ["LARGE", "SMALL"])
    def test_mobilenet_v3_forward(self, mode):
        out, _ = _apply(T.MobileNetV3(model_mode=mode, num_classes=10),
                        torch.zeros(2, 32, 32, 3), train=True)
        assert out.shape == (2, 10)

    def test_efficientnet_b0_forward(self):
        model = T.efficientnet("efficientnet-b0", num_classes=10)
        out, _ = _apply(model, torch.zeros(2, 32, 32, 3))
        assert out.shape == (2, 10)
        # train mode exercises the drop-connect and dropout masks
        out2, _ = _apply(model, torch.zeros(2, 32, 32, 3), train=True)
        assert out2.shape == (2, 10)

    def test_efficientnet_scaling(self):
        assert round_filters(32, 1.0) == 32
        assert round_filters(32, 1.1) == 32
        assert round_filters(40, 1.1) == 48
        assert round_repeats(2, 1.1) == 3
        with pytest.raises(ValueError, match="model_name"):
            T.efficientnet("efficientnet-b9")

    def test_vgg11_forward(self):
        out, _ = _apply(T.vgg11(class_num=10, classifier_dims=(512,)),
                        torch.zeros(2, 32, 32, 3))
        assert out.shape == (2, 10)

    @pytest.mark.parametrize("name", ["resnet56", "cnn", "mobilenet",
                                      "efficientnet-b0", "vgg11"])
    def test_model_dtype_bf16_threads_to_compute(self, name):
        args = types.SimpleNamespace(model_dtype="bf16")
        shape = (1, 28, 28) if name == "cnn" else (1, 32, 32, 3)
        model = create_model(args, name, 10, input_shape=shape[1:])
        assert model.dtype == torch.bfloat16
        out, st = _apply(model, torch.zeros(shape))
        assert all(p.dtype == torch.float32 for p in st["params"].values())
        assert out.dtype == torch.float32
