"""The port's multi-rank dry run (``fedml_tpu_torch/parallel/dryrun.py``,
the counterpart of ``__graft_entry__.py:72`` ``dryrun_multichip``) over
a spawned gloo group of 2 ranks (``test_torch_dryrun_four.py`` runs 4).

At the reference's sizes (ResNet-20) the dry run holds each of its
cases 1-7 to the port's single-device round within the reference's
bounds (1e-5 for the rounds, 1e-4 for dp x sp) and raises otherwise;
every rank returns the same states. The same cases at depth 8 from the
reference's weights are held to the reference's values on a mesh of the
same size (``tests/dryrun_reference.py``)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

import dryrun_reference as ref
import torch_dist

N = 2


@pytest.fixture(scope="module")
def group():
    g = torch_dist.RankGroup(N, env={"FEDML_TPU_PACKING": "python"})
    try:
        yield g
    finally:
        g.close()


def test_dryrun_cases_at_the_reference_sizes(group):
    ref.check_reference_sizes(group)


def test_dryrun_cases_match_the_reference(group, monkeypatch):
    ref.check_reference_values(group, monkeypatch)
