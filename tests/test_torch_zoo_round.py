"""The fed CIFAR-100 recipe's round through both packages' experiment
mains on the CPU: ``main_fedavg --dataset fed_cifar100 --model
resnet18_gn`` (GroupNorm 32, 100 classes at full width) on a 3-client
``prepare fixture`` (6 uint8 32x32 images a client, cropped to 24x24 by
the loaders), batch 4, 1 epoch, 1 round, the port starting from the
reference's initial weights carried over by the CV carrier, both
packing schedules with numpy. The global parameters agree within 1e-4
absolute and the round's records within 1e-4.

The reference's model computes in float64 (its factory's module cloned
with ``dtype=float64`` under ``jax.enable_x64``; parameters stay fp32):
XLA's fp32 on the CPU carries the two local SGD steps of a client 3.9e-4
(2.6% of the update) off float64 in ``layer4_block0``, where the port's
fp32 stays within 3e-8 of it. The port runs torch's native CPU
convolution (``torch.backends.mkldnn`` off): oneDNN's fp32 weight
gradients at these shapes stray up to 1.2e-4 of the largest |gradient|
import torch_threads  # noqa: F401  (caps torch threads under xdist)
from float64, the native kernels about 5e-7."""

import numpy as np
import pytest

from fedml_tpu.data import prepare as jprepare
from fedml_tpu.experiments import main_fedavg as jmain
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.utils.torch_import import cv_variables_to_state

TOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import torch

    import fedml_tpu.algorithms.fedavg as jfedavg
    import fedml_tpu.models.factory as jfactory
    import fedml_tpu_torch.algorithms.fedavg as tfedavg

    d = str(tmp_path_factory.mktemp("fed_cifar100"))
    assert jprepare.main(["fixture", "fed_cifar100", "--data_dir", d]) == 0
    argv = ["--dataset", "fed_cifar100", "--data_dir", d, "--model",
            "resnet18_gn", "--client_num_in_total", "3",
            "--client_num_per_round", "3", "--batch_size", "4", "--epochs",
            "1", "--comm_round", "1", "--platform", "cpu"]
    inits = []

    class JaxAPI(jfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append(jax.tree.map(np.array, self.global_state))

    class PortAPI(tfedavg.FedAvgAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            state = cv_variables_to_state(inits[0])
            if not state["batch_stats"]:
                del state["batch_stats"]
            self.global_state = state

    create = jfactory.create_model
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("FEDML_TPU_PACKING", "python")
        mp.setattr(torch.backends.mkldnn, "enabled", False)
        mp.setattr(jfedavg, "FedAvgAPI", JaxAPI)
        mp.setattr(tfedavg, "FedAvgAPI", PortAPI)
        mp.setattr(jfactory, "create_model", lambda *a, **kw: create(
            *a, **kw).clone(dtype=jnp.float64))
        with jax.enable_x64(True):
            japi, _ = jmain.main(argv)
        api, _ = main_fedavg.main(argv)
    finally:
        mp.undo()
    return japi, api, inits[0]


def test_global_parameters_match_the_reference(runs):
    import jax

    japi, api, init = runs
    tree = lambda v: cv_variables_to_state(
        {"params": jax.tree.map(np.asarray, v["params"])})["params"]
    want, start = tree(japi.global_state), tree(init)
    got = api.global_state["params"]
    assert api.device.type == "cpu"
    assert sorted(got) == sorted(want)
    assert "batch_stats" not in api.global_state  # GroupNorm is stateless
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 10 * TOL  # the round trained
    for k, w in want.items():
        err = float((got[k].cpu() - w).abs().max())
        assert err <= TOL, (k, err)


def test_round_records_match_the_reference(runs):
    japi, api, _ = runs
    assert len(api.history) == len(japi.history) == 1
    rm, gm = japi.history[0], api.history[0]
    assert sorted(gm) == sorted(rm)
    for key in rm:
        if key not in ("round", "round_time_s"):
            np.testing.assert_allclose(gm[key], rm[key], atol=TOL,
                                       err_msg=key)
