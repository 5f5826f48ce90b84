"""Multi-process federation trees (counterpart of
``fedml_tpu/topology``; Bonawitz MLSys'19 actor hierarchy).

``net/fanin.py`` proved the tiers compose in one process; this package
makes them real processes: :mod:`.tree` declares the shape
(:class:`~fedml_tpu_torch.topology.tree.TreeSpec`), :mod:`.edge` is the edge
process entrypoint (one :class:`~fedml_tpu_torch.net.fanin.EdgeAggregator`
per process: leaf-star server below, compressed-wire client above),
and :mod:`.orchestrator` spawns, supervises, and tears down the tree
(:func:`~fedml_tpu_torch.topology.orchestrator.run_tree`).
"""

from fedml_tpu_torch.topology.tree import TreeSpec, manifest_core
from fedml_tpu_torch.topology.orchestrator import run_tree

__all__ = ["TreeSpec", "manifest_core", "run_tree"]
