"""The seven mains the reference hands ``common.make_mesh(args)``
(``main_fedavg``, ``main_fedavg_robust``, ``main_fednova``,
``main_fedopt``, ``main_hierarchical``, ``main_fedseg`` and
``main_fednas --stage train``) run with ``--mesh N`` on every rank of a
spawned gloo group of N = 2 and 4 ranks (``tests/torch_dist.py``).

Every rank ends with the same global state and the same records, its
mesh is ``{"clients": N, "model": 1}``, and rank 0 alone writes the
metrics (the others get the log-only sink). The LR and CNN mains are
held to the same main's ``--mesh 0`` run in this process within 1e-5
(the host-packed sharded round, or for the hierarchical main its own
loop, against the single-device rounds). FedSeg's DeepLab and FedNAS's
DARTS cell train through batch-8 BatchNorm, where the grouped
convolutions of a rank's block and of the whole cohort round differently
and the local steps amplify it past any fp32 bound
(``parallel/dryrun.py``); they are held to their records' keys, finite
values and the ranks' agreement."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import importlib

import numpy as np
import pytest

import torch_dist
import torch_dist_cases as cases

LR = ["--comm_round", "2"]
IMAGES = ["--dataset", "synthetic_images", "--model", "cnn", "--image_size",
          "8", "--n_train", "160", "--n_test", "32", "--client_num_in_total",
          "5", "--client_num_per_round", "5", "--batch_size", "16",
          "--comm_round", "2"]
SEG = ["--dataset", "synthetic_segmentation", "--backbone", "mobilenet",
       "--lr", "0.1", "--n_train", "48", "--n_test", "16", "--image_size",
       "16", "--client_num_in_total", "4", "--client_num_per_round", "4",
       "--comm_round", "1", "--batch_size", "8", "--ci", "1"]
NAS = ["--stage", "train", "--dataset", "synthetic_images", "--n_train",
       "32", "--n_test", "8", "--image_size", "8", "--init_channels", "4",
       "--layers", "3", "--client_num_in_total", "3",
       "--client_num_per_round", "3", "--comm_round", "1", "--batch_size",
       "8"]
#: main -> (argv, held to --mesh 0 within 1e-5)
MAINS = {"main_fedavg": (LR, True),
         "main_fedavg_robust": (IMAGES, True),
         "main_fednova": (LR, True),
         "main_fedopt": (LR + ["--server_optimizer", "adam"], True),
         "main_hierarchical": (LR, True),
         "main_fedseg": (SEG, False),
         "main_fednas": (NAS, False)}


@pytest.fixture(scope="module", params=[2, 4])
def group(request):
    g = torch_dist.RankGroup(request.param)
    try:
        yield g
    finally:
        g.close()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("main", sorted(MAINS))
def test_main_runs_on_a_mesh(group, main):
    argv, exact = MAINS[main]
    argv = argv + ["--platform", "cpu"]
    outs = group.run(cases.run_main, main, argv + ["--mesh", str(group.n)])
    state, history, shape, _ = outs[0]
    assert shape == {"clients": group.n, "model": 1}
    assert [o[3] for o in outs] == (["MetricsLogger"]
                                    + ["_LogOnlySink"] * (group.n - 1))
    for other in outs[1:]:
        assert other[1] == history
        for (pa, a), (pb, b) in zip(_leaves(state), _leaves(other[0])):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    module = importlib.import_module(f"fedml_tpu_torch.experiments.{main}")
    api, want = module.main(argv)
    assert len(history) == len(api.history)
    for got, ref in zip(history, api.history):
        assert set(got) == set(ref) - {"round_time_s"}
        for key, value in got.items():
            if isinstance(value, float):
                assert np.isfinite(value), (key, value)
                if exact:
                    np.testing.assert_allclose(value, ref[key], atol=1e-5)
    for (pa, a), (pb, b) in zip(_leaves(state),
                                _leaves(cases._np(want))):
        assert pa == pb and a.shape == b.shape
        assert np.isfinite(a).all()
        if exact:
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=pa)
