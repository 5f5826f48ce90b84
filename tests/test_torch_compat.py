"""The port's reference call shapes (``fedml_tpu_torch/compat.py``):
``FedML_init`` and ``FedML_<Algo>_distributed`` driven the way reference
launch code drives them, positional dataset fields unpacked from the
loader, with the asserts of the reference's ``tests/test_compat.py``;
then the same calls with ``args.mesh`` over a spawned gloo group of 2
and of 4 ranks (``tests/torch_dist.py``), every rank ending with the
global state of the single-device call within 1e-5."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import numpy as np
import pytest

import torch_dist
import torch_dist_cases as cases
from fedml_tpu_torch.compat import (FedML_FedAvg_distributed,
                                    FedML_FedAvgRobust_distributed,
                                    FedML_FedNova_distributed,
                                    FedML_FedOpt_distributed, FedML_init)
from fedml_tpu_torch.data.synthetic import load_synthetic_federated
from fedml_tpu_torch.models.linear import LogisticRegression


def _reference_style_call(fn, extra_args=None):
    """Drive the compat entry exactly the way reference launch code does:
    positional 8-tuple fields unpacked from the loader."""
    comm, process_id, worker_number = FedML_init(device="cpu")
    assert comm is None and process_id == 0 and worker_number >= 1

    dataset = load_synthetic_federated(client_num=4, n_train=400,
                                       n_test=80, seed=0)
    (train_data_num, _test_data_num, train_data_global, test_data_global,
     train_data_local_num_dict, train_data_local_dict,
     test_data_local_dict, class_num) = dataset

    args = types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=2,
        epochs=1, batch_size=16, lr=0.3, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=100, seed=0, class_num=class_num,
        server_optimizer="sgd", server_lr=0.5)
    if extra_args:
        for k, v in extra_args.items():
            setattr(args, k, v)

    model = LogisticRegression(60, class_num, apply_sigmoid=False)
    api = fn(process_id, worker_number, "cpu", comm, model,
             train_data_num, train_data_global, test_data_global,
             train_data_local_num_dict, train_data_local_dict,
             test_data_local_dict, args)
    assert api.round_idx == 2
    assert len(api.history) == 2
    ev = api.evaluate_global()
    assert 0.0 <= ev["Test/Acc"] <= 1.0
    return api


def test_fedavg_distributed_call_shape():
    api = _reference_style_call(FedML_FedAvg_distributed)
    # training happened and stayed finite
    assert np.isfinite(api.history[-1]["Train/Loss"])


def test_fedopt_distributed_call_shape():
    _reference_style_call(FedML_FedOpt_distributed)


def test_fednova_distributed_call_shape():
    _reference_style_call(FedML_FedNova_distributed)


def test_fedavg_robust_distributed_call_shape():
    api = _reference_style_call(FedML_FedAvgRobust_distributed)
    assert api.evaluate_backdoor() == {}


def test_class_num_inferred_when_absent():
    """Reference args objects don't always carry class_num; the shim
    infers it from the labels."""
    dataset = load_synthetic_federated(client_num=3, n_train=300,
                                       n_test=60, seed=1)
    args = types.SimpleNamespace(
        client_num_in_total=3, client_num_per_round=3, comm_round=1,
        epochs=1, batch_size=16, lr=0.3, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=100, seed=0, platform="cpu")
    model = LogisticRegression(60, dataset[7], apply_sigmoid=False)
    api = FedML_FedAvg_distributed(
        0, 1, None, None, model, dataset[0], dataset[2], dataset[3],
        dataset[4], dataset[5], dataset[6], args)
    assert api.class_num == dataset[7]


@pytest.fixture(scope="module", params=[2, 4])
def group(request):
    g = torch_dist.RankGroup(request.param,
                             env={"FEDML_TPU_PACKING": "python"})
    try:
        yield g
    finally:
        g.close()


@pytest.mark.parametrize("name", ["FedAvg", "FedOpt", "FedNova",
                                  "FedAvgRobust"])
def test_distributed_call_on_a_mesh(group, name, monkeypatch):
    monkeypatch.setenv("FEDML_TPU_PACKING", "python")
    outs = group.run(cases.compat_call, name, group.n)
    for rank, (triple, state, history) in enumerate(outs):
        assert triple == (None, rank, group.n)
        assert history == outs[0][2] and len(history) == 2
    _, want, want_history = cases.compat_call(name, 0)
    for part in want:
        for k, v in want[part].items():
            for _, state, _ in outs:
                np.testing.assert_allclose(state[part][k], v, atol=1e-5)
    for got, ref in zip(outs[0][2], want_history):
        np.testing.assert_allclose(got["Train/Loss"], ref["Train/Loss"],
                                   atol=1e-5)
