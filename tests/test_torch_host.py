"""The port's host-side numpy legs are byte-equal to the JAX package's:
the LDA partition, the synthetic image loader, cohort sampling, client
stacking, the index schedule, the lane packing and the eval packing
(the reference's numpy packing backend, ``native=False``)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest

from fedml_tpu.core import partition as ref_partition
from fedml_tpu.data import synthetic as ref_synthetic
from fedml_tpu.parallel import packing as ref_packing
from fedml_tpu.program import cohort as ref_cohort
from fedml_tpu_torch.core import partition
from fedml_tpu_torch.data import synthetic
from fedml_tpu_torch.parallel import packing
from fedml_tpu_torch.program import cohort


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        a_, b_ = np.asarray(a), np.asarray(b)
        assert a_.dtype == b_.dtype and a_.shape == b_.shape
        assert a_.tobytes() == b_.tobytes()


@pytest.mark.parametrize("seed,alpha,clients", [(0, 0.5, 8), (3, 0.1, 5),
                                                 (7, 5.0, 16)])
def test_lda_partition_byte_equal(seed, alpha, clients):
    labels = np.random.default_rng(seed).integers(0, 10, 1200)
    want = ref_partition.non_iid_partition_with_dirichlet_distribution(
        labels, clients, 10, alpha, seed=seed)
    got = partition.non_iid_partition_with_dirichlet_distribution(
        labels, clients, 10, alpha, seed=seed)
    _assert_tree_equal(got, want)


def test_infeasible_partition_raises():
    with pytest.raises(ValueError, match="infeasible"):
        partition.non_iid_partition_with_dirichlet_distribution(
            np.zeros(50, np.int64), 10, 10, 0.5, seed=0)


@pytest.mark.parametrize("part", ["hetero", "homo"])
def test_synthetic_images_byte_equal(part):
    kw = dict(client_num=6, n_train=300, n_test=60, image_size=8,
              partition=part, partition_alpha=0.5, seed=4)
    _assert_tree_equal(synthetic.load_synthetic_images(**kw),
                       ref_synthetic.load_synthetic_images(**kw))


@pytest.mark.parametrize("rnd,total,per", [(0, 32, 32), (3, 32, 8),
                                           (11, 100, 10), (5, 7, 3)])
def test_client_sampling_byte_equal(rnd, total, per):
    got = cohort.client_sampling(rnd, total, per)
    want = ref_cohort.client_sampling(rnd, total, per)
    assert [int(c) for c in got] == [int(c) for c in want]


def _shards(seed=2):
    rnd = np.random.default_rng(seed)
    return [{"x": rnd.normal(size=(n, 4, 4, 3)).astype(np.float32),
             "y": rnd.integers(0, 10, n).astype(np.int64)}
            for n in (20, 8, 14, 0, 16, 9, 33)]


def test_stack_clients_byte_equal():
    _assert_tree_equal(packing.stack_clients(_shards()),
                       ref_packing.stack_clients(_shards()))


@pytest.mark.parametrize("bs,epochs,lanes", [(8, 1, 3), (5, 2, 4),
                                             (-1, 1, 2), (16, 3, 8)])
def test_schedule_and_lanes_byte_equal(bs, epochs, lanes):
    ns = [len(d["y"]) for d in _shards()]
    got = packing.pack_schedule(ns, bs, epochs,
                                rng=np.random.default_rng(9), native=False)
    want = ref_packing.pack_schedule(ns, bs, epochs,
                                     rng=np.random.default_rng(9),
                                     native=False)
    _assert_tree_equal(got, want)
    _assert_tree_equal(packing.pack_lanes(got, lanes, native=False),
                       ref_packing.pack_lanes(want, lanes, native=False))


def test_pack_eval_byte_equal():
    d = _shards()[0]
    _assert_tree_equal(packing.pack_eval(d, 6), ref_packing.pack_eval(d, 6))


def test_native_backend_is_not_ported(monkeypatch):
    """The native backend is ported (``test_torch_native.py``); where its
    shim cannot be had, asking for it by name raises instead of quietly
    packing with numpy."""
    from fedml_tpu_torch import native
    monkeypatch.setenv("FEDML_TPU_NO_NATIVE", "1")
    native.reset()
    try:
        with pytest.raises(RuntimeError, match="FEDML_TPU_NO_NATIVE"):
            packing.pack_schedule([4], 2, 1, native=True)
    finally:
        native.reset()
