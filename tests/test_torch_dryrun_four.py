"""The port's dry run over a spawned gloo group of 4 ranks: the cases
and holds of ``test_torch_dryrun.py`` (which runs 2), here with a
4-rank ``seq`` axis for dp x sp."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

import dryrun_reference as ref
import torch_dist

N = 4


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
