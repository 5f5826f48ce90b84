"""FedGKT's server phase over a ``model`` mesh axis
(``fedml_tpu_torch/algorithms/fedgkt.py``), the counterpart of the
reference's ``tests/test_split_vertical_mpc.py:95-133``.

Every rank of a spawned gloo group of 2 and of 4 runs the whole API on
a ``(1, n)`` ``(clients, model)`` mesh, so each server batch of 8
splits into ``8 / n`` rows a rank. Held: with the reference's BN-free
server (flatten, Dense 32, ReLU, Dense) the sharded round equals the
unsharded one run on the same ranks -- the round's train loss within
rtol 1e-5, the server's parameters and the fresh teacher logits
(gathered back in row order) within 1e-4 absolute and relative (the
pair of ``tests/test_ops.py``'s parameter holds: after the round at lr
0.3 the head's weights reach about 21, and the fp32 sum of the ranks'
gradients strays from the one-batch sum by 1.5e-4 there on 4 ranks),
the same on every rank; a
BatchNorm server (``GKTServerResNet`` at ``n`` 1, whose statistics are
each rank's rows, averaged, as DataParallel's) trains and evaluates."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import pytest

import torch_dist
import torch_dist_cases as cases

TOL = 1e-4


@pytest.fixture(scope="module", params=[2, 4])
def group(request):
    g = torch_dist.RankGroup(request.param)
    try:
        yield g
    finally:
        g.close()


def test_gkt_server_phase_shards_over_model_axis(group):
    unsharded = group.run(cases.gkt_round, None, False)[0]
    outs = group.run(cases.gkt_round, group.n, False)
    assert not unsharded["sharded"]
    for out in outs:
        assert out["sharded"]
        np.testing.assert_allclose(out["record"]["Train/Loss"],
                                   unsharded["record"]["Train/Loss"],
                                   rtol=1e-5)
        for k, v in unsharded["server"].items():
            np.testing.assert_allclose(out["server"][k], v, atol=TOL,
                                       rtol=TOL, err_msg=k)
        np.testing.assert_allclose(out["logits"], unsharded["logits"],
                                   atol=TOL, rtol=TOL)
        for k, v in outs[0]["server"].items():
            np.testing.assert_array_equal(out["server"][k], v)


def test_gkt_bn_server_shards_and_evaluates(group):
    for out in group.run(cases.gkt_round, group.n, True):
        assert out["sharded"]
        assert np.isfinite(out["record"]["Train/Loss"])
        assert 0.0 <= out["eval"]["Test/Acc"] <= 1.0
        assert np.isfinite(out["logits"]).all()
