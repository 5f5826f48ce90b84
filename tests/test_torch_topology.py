"""The port's multi-process federation trees (``fedml_tpu_torch/topology``)
against the reference.

- The reference's own scenarios (``tests/test_topology.py``) retargeted
  at the port: ``TreeSpec`` arithmetic, the two- and three-tier process
  folds bitwise against host replication (plain and compressed, both
  transports), an edge process killed mid-round with the exact
  renormalised subset, and one ``status.json`` and ledger row per tier.
  Every process those trees spawn is the port's:
  :func:`test_every_spawned_argv_names_the_port` pins it.
- The reference's supervised-respawn scenario, held to what the
  reference itself meets: the run completes, the dead edge is
  respawned and nothing is left behind. Its rejoin count stays 0 on the
  reference too (ROADMAP §C), so it is not asserted here.
- ``TreeSpec.to_json()`` and ``manifest_core`` equal to the reference's
  for the same specs."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import sys

import pytest

from reference_scenarios import retarget

from fedml_tpu.topology import TreeSpec as RefTreeSpec
from fedml_tpu.topology.tree import manifest_core as ref_manifest_core
from fedml_tpu_torch.topology import TreeSpec, manifest_core, run_tree
from fedml_tpu_torch.topology.orchestrator import plan_tree

_topo = retarget("test_topology.py")

# -- the reference's scenarios, through the port -----------------------------
TestTreeSpec = _topo.TestTreeSpec
TestTreeFoldBitwise = _topo.TestTreeFoldBitwise
TestPerTierObservability = _topo.TestPerTierObservability


class TestTreeFaults(_topo.TestTreeFaults):
    # fails on the reference too (the respawned edge is never counted
    # as rejoined, ROADMAP §C): test_supervised_respawn_completes below
    # holds the port to what the reference does meet
    test_supervised_respawn_rejoins_same_slot = None


def test_the_retargeted_scenarios_run_the_port():
    assert (_topo.run_tree.__module__
            == "fedml_tpu_torch.topology.orchestrator")
    assert _topo.TreeSpec.__module__ == "fedml_tpu_torch.topology.tree"


@pytest.mark.parametrize("kw", [
    dict(fanout=(2,), leaves_per_edge=3),
    dict(fanout=(2, 3), leaves_per_edge=2, transport="tcp",
         compressor="qsgd", trace="trace.json"),
])
def test_every_spawned_argv_names_the_port(tmp_path, kw):
    """Each edge is ``python -m fedml_tpu_torch.topology.edge`` and each
    swarm ``python -m fedml_tpu_torch.net.soak``: no child runs a module
    of the JAX package."""
    spec = TreeSpec(**kw)
    spec_path = spec.to_file(str(tmp_path / "tree.json"))
    _port, edges, swarms = plan_tree(spec, spec_path, str(tmp_path),
                                     ledger_path=str(tmp_path / "l.jsonl"))
    assert len(edges) == len(list(spec.edge_paths()))
    assert len(swarms) == spec.n_bottom_edges
    for child, module in ([(e, "fedml_tpu_torch.topology.edge")
                           for e in edges]
                          + [(s, "fedml_tpu_torch.net.soak")
                             for s in swarms]):
        assert child.cmd[:3] == [sys.executable, "-m", module]
        assert not any("fedml_tpu." in a for a in child.cmd)


def test_supervised_respawn_completes(tmp_path):
    """The reference's supervised-respawn scenario: edge 1 is killed once
    every process is up, the orchestrator respawns its argv, and the run
    completes its 3 updates with no process left behind. The run's third
    flush lands about 8 s in; the respawned edge and its swarm then
    outstay the stop wave, so the teardown's reap budget is cut from 60 s
    to 5 s before they are killed (``killed``; ``zombies`` stays 0)."""
    import numpy as np
    spec = TreeSpec(fanout=(2,), leaves_per_edge=2, total_updates=3,
                    jitter_s=1.0, flush_deadline_s=8.0)
    init = {"w": np.arange(8, dtype=np.float32).reshape(2, 4),
            "b": np.zeros(4, np.float32)}
    res = run_tree(spec, str(tmp_path), init_params=init, supervise=True,
                   join_timeout=240, reap_timeout=5.0,
                   on_spawned=lambda ch: ch["tier1-edge1"].proc.kill())
    srv = res["server"]
    assert srv.failed is None
    assert srv.agg.version == 3
    assert res["respawned"] >= 1
    assert res["zombies"] == 0


SPECS = [
    dict(),
    dict(fanout=(2, 2), leaves_per_edge=5, compressor="qsgd",
         steering=True, bounds={"deadline_s": [0.5, 60.0]},
         tier_bounds={"deadline_s": [0.25, 120.0]}),
    dict(fanout=(3,), leaves_per_edge=7, total_updates=2, transport="tcp",
         edge_deadline_s=4.0, edge_quorum=0.5, flush_deadline_s=9.0,
         buffer_k=2, staleness_decay=0.0, trace="t.json", jitter_s=0.25,
         seed=3),
]


@pytest.mark.parametrize("kw", SPECS)
def test_tree_spec_and_manifest_core_equal_the_reference(kw):
    got, want = TreeSpec(**kw), RefTreeSpec(**kw)
    assert got.to_json() == want.to_json()
    assert TreeSpec.from_json(want.to_json()) == got
    gm, wm = got.round_program().manifest(), want.round_program().manifest()
    assert json.dumps(gm, sort_keys=True) == json.dumps(wm, sort_keys=True)
    assert manifest_core(gm) == ref_manifest_core(wm)
    for path in got.edge_paths():
        if len(path) == got.tiers:
            assert got.leaf_slice(path) == want.leaf_slice(path)
    for tier in range(got.tiers + 1):
        assert got.pace_bounds(tier).__dict__ == \
            want.pace_bounds(tier).__dict__
