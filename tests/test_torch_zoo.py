"""The port's LR/CNN zoo and factory against the JAX package (the CV
zoo's are ``test_torch_zoo_cv.py``'s): forwards
of ``LogisticRegression``, ``CNNOriginalFedAvg`` and ``CNNDropOut`` (eval
mode: the two frameworks draw different dropout masks) on the reference's
weights carried over, at 1e-5; the parameter counts the reference's
docstrings give; the vertical-FL party models ``DenseModel`` and
``LocalModel`` (names, shapes, outputs); ``resnet110``'s depth; the factory's names and
refusals; the lane-packed CNN against per-lane forwards and against the
JAX package's packed CNN; ``CNNDropOut``'s training repeatable for a
seed."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import cnn as jcnn
from fedml_tpu.models import lane_packed as jlp
from fedml_tpu.models import linear as jlinear
from fedml_tpu.models.factory import create_model as jax_create_model
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg
from fedml_tpu_torch.models.factory import create_model
from fedml_tpu_torch.models.lane_packed import (builder_for,
                                                make_lane_packed_apply)
from fedml_tpu_torch.models.linear import (DenseModel, LocalModel,
                                           LogisticRegression)
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.utils.torch_import import (cv_state_to_variables,
                                                cv_variables_to_state)



def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _forward(model, state, x, **kw):
    with torch.no_grad():
        return torch.func.functional_call(
            model, state["params"], (torch.as_tensor(x),), kw).numpy()


@pytest.mark.parametrize("shape", [(3, 28, 28), (3, 28, 28, 1),
                                   (2, 12, 12, 3)])
@pytest.mark.parametrize("jcls,cls", [
    (jcnn.CNNOriginalFedAvg, CNNOriginalFedAvg),
    (jcnn.CNNDropOut, CNNDropOut)])
def test_cnn_forward_matches_flax(jcls, cls, shape):
    x = _x(shape)
    jm = jcls()
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = cls(input_shape=shape[1:])
    state = cv_variables_to_state(jax.tree.map(np.asarray, variables))
    np.testing.assert_allclose(_forward(model, state, x), want, atol=1e-5)
    back = cv_state_to_variables(state)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(back))[path], leaf)


@pytest.mark.parametrize("sigmoid", [True, False])
def test_lr_forward_matches_flax(sigmoid):
    x = _x((5, 60))
    jm = jlinear.LogisticRegression(num_classes=10, apply_sigmoid=sigmoid)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = LogisticRegression(60, 10, apply_sigmoid=sigmoid)
    state = cv_variables_to_state(jax.tree.map(np.asarray, variables))
    np.testing.assert_allclose(_forward(model, state, x), want, atol=1e-5)
    assert LogisticRegression(60, 10).apply_sigmoid  # the LEAF quirk


@pytest.mark.parametrize("cls,count", [(CNNOriginalFedAvg, 1_663_370),
                                       (CNNDropOut, 1_199_882)])
def test_parameter_counts_are_the_reference_ones(cls, count):
    assert sum(p.numel() for p in cls().parameters()) == count
    jname = cls.__name__
    jm = getattr(jcnn, jname)()
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    assert sum(int(np.prod(v.shape))
               for v in jax.tree.leaves(variables)) == count


def test_resnet110_depth():
    args = types.SimpleNamespace(model_dtype=None)
    model = create_model(args, "resnet110", 10)
    assert isinstance(model, CifarResNet) and model.depth == 110
    assert len(model.layer1) == len(model.layer2) == len(model.layer3) == 18
    jm = jax_create_model(args, "resnet110", 10)
    jv = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree.leaves(jv["params"]))


@pytest.mark.parametrize("name,cls", [
    ("lr", LogisticRegression), ("cnn", CNNOriginalFedAvg),
    ("cnn_dropout", CNNDropOut), ("resnet56", CifarResNet),
    ("resnet110", CifarResNet), ("transformer", None),
    ("transformer_nwp", None)])
def test_factory_knows_the_ported_names(name, cls):
    args = types.SimpleNamespace(model_dtype="bf16")
    model = create_model(args, name, 10, input_shape=(28, 28, 1))
    if cls is not None:
        assert isinstance(model, cls)
    if name != "lr":
        assert model.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        create_model(args, "lr", 10)


@pytest.mark.parametrize("name,item", [
    ("resnet18_gn", "A14"), ("mobilenet", "A14"), ("mobilenet_v3", "A14"),
    ("efficientnet", "A14"), ("efficientnet-b3", "A14"), ("vgg16", "A14"),
    ("vgg11", "A14"), ("vgg13", "A14"),
    ("resnet50_gn", "A14"), ("resnet34_gn", "A14")])
def test_factory_refuses_unported_names(name, item):
    # ROADMAP A14's zoo is ported: each name it waited for now builds
    assert isinstance(create_model(None, name, 10), torch.nn.Module)


def test_factory_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown model"):
        create_model(None, "no_such_model", 10)


@pytest.mark.parametrize("L", [1, 4, 6])
def test_packed_cnn_matches_per_lane_forwards(L):
    shape = (12, 12, 2)
    x = _x((L, 3) + shape, seed=L)
    jm = jcnn.CNNOriginalFedAvg()
    vs = [jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(i),
                                           jnp.asarray(x[0])))
          for i in range(L)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *vs)
    model = CNNOriginalFedAvg(input_shape=shape)
    per_lane = np.stack([_forward(model, cv_variables_to_state(v),
                                  x[i]) for i, v in enumerate(vs)])
    state = cv_variables_to_state(stacked, lead=1)
    got, stats = make_lane_packed_apply(model, L)(state, torch.as_tensor(x))
    assert stats == {}
    np.testing.assert_allclose(got.numpy(), per_lane, atol=1e-5)
    want, _ = jlp.make_lane_packed_apply(jm, L)(stacked, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_builder_for_registers_the_packed_families():
    assert builder_for(CNNOriginalFedAvg()) is not None
    assert builder_for(CifarResNet(depth=8)) is not None
    assert builder_for(CNNDropOut()) is None
    assert builder_for(LogisticRegression(4, 2)) is None


def _dropout_train(seed):
    model = CNNDropOut(input_shape=(12, 12, 1))
    spec = make_classification_spec(model)
    state = spec.init_fn(0, "cpu")
    x = torch.as_tensor(_x((2, 4, 12, 12, 1)))
    batch = {"x": x, "y": torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]]),
             "mask": torch.ones(2, 4)}
    stacked = {"params": {k: v.unsqueeze(0).expand((2,) + v.shape).clone()
                          .requires_grad_(True)
                          for k, v in state["params"].items()}}
    loss, _ = spec.stacked_loss_fn(stacked, batch, True,
                                   seeds=np.array([seed, seed + 1]))
    grads = torch.autograd.grad(loss, list(stacked["params"].values()))
    return float(loss.detach()), grads


def test_cnn_dropout_training_is_repeatable_for_a_seed():
    loss_a, grads_a = _dropout_train(3)
    loss_b, grads_b = _dropout_train(3)
    loss_c, _ = _dropout_train(4)
    assert loss_a == loss_b and loss_a != loss_c
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="seeds"):
        spec = make_classification_spec(CNNDropOut(input_shape=(12, 12, 1)))
        st = spec.init_fn(0, "cpu")
        spec.stacked_loss_fn(
            {"params": {k: v[None] for k, v in st["params"].items()}},
            {"x": torch.zeros(1, 2, 12, 12, 1), "y": torch.zeros(1, 2).long(),
             "mask": torch.ones(1, 2)}, True)


def _state(variables):
    return cv_variables_to_state(jax.tree.map(np.array, variables))["params"]


@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_model_is_flax(use_bias):
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jm = jlinear.DenseModel(output_dim=2, use_bias=use_bias)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 5)))
    m = DenseModel(5, output_dim=2, use_bias=use_bias)
    assert set(m.state_dict()) == set(_state(v))
    m.load_state_dict(_state(v))
    out = m(torch.as_tensor(x)).detach().numpy()
    assert out.shape == (3, 2)
    np.testing.assert_allclose(out, np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("hidden", [(), (16,), (8, 4)])
def test_local_model_is_flax(hidden):
    x = np.random.default_rng(0).normal(size=(3, 6)).astype(np.float32)
    jm = jlinear.LocalModel(hidden_dims=hidden, output_dim=3)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 6)))
    m = LocalModel(6, hidden_dims=hidden, output_dim=3)
    assert set(m.state_dict()) == set(_state(v))
    m.load_state_dict(_state(v))
    out = m(torch.as_tensor(x)).detach().numpy()
    assert out.shape == (3, 3)
    np.testing.assert_allclose(out, np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=1e-6)
