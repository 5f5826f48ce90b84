"""Gossip topology managers for decentralized FL (counterpart of
``fedml_tpu/core/topology.py``; plain numpy, the port's own copy).

A ring augmented with random links, row-normalized into a mixing matrix;
the asymmetric variant deletes random directed edges. The draws come from
``np.random.default_rng(seed)`` in the reference's order, so ``W`` is
bit-equal to the reference's for the same ``(n, neighbor_num, seed)``.
The gossip rounds (``algorithms/decentralized.py``,
``algorithms/decentralized_online.py``) take their matrix from
:func:`mixing_matrix` and mix node states with it as one product on the
device.
"""

from __future__ import annotations

import numpy as np


class BaseTopologyManager:
    """Interface parity with reference ``base_topology_manager.py:4-24``."""

    def generate_topology(self):
        raise NotImplementedError

    def get_in_neighbor_idx_list(self, node_index):
        raise NotImplementedError

    def get_out_neighbor_idx_list(self, node_index):
        raise NotImplementedError

    def get_in_neighbor_weights(self, node_index):
        raise NotImplementedError

    def get_out_neighbor_weights(self, node_index):
        raise NotImplementedError


def _ring_plus_random_topology(n, neighbor_num, rng):
    """Symmetric ring + random extra links, as in reference
    ``symmetric_topology_manager.py:21-52`` (networkx watts_strogatz_graph with
    rewiring probability 0 plus ``neighbor_num`` random undirected edges)."""
    topo = np.zeros((n, n))
    # base ring (guarantees connectivity), then neighbor_num - 2 random
    # undirected links per node for the small-world effect
    for i in range(n):
        topo[i, (i + 1) % n] = 1
        topo[i, (i - 1) % n] = 1
    extra = max(0, neighbor_num - 2)
    for i in range(n):
        candidates = [j for j in range(n) if j != i and topo[i, j] == 0]
        rng.shuffle(candidates)
        for j in candidates[:extra]:
            topo[i, j] = topo[j, i] = 1
    np.fill_diagonal(topo, 1)
    return topo


class SymmetricTopologyManager(BaseTopologyManager):
    """Undirected topology with row-normalized mixing weights."""

    def __init__(self, n, neighbor_num=2, seed=0):
        self.n = n
        self.neighbor_num = min(neighbor_num, n - 1)
        self.topology = None
        self._seed = seed

    def generate_topology(self):
        rng = np.random.default_rng(self._seed)
        topo = _ring_plus_random_topology(self.n, self.neighbor_num, rng)
        # symmetrize then row-normalize (reference divides each row by its degree)
        topo = np.maximum(topo, topo.T)
        self.topology = topo / topo.sum(axis=1, keepdims=True)
        return self.topology

    def get_in_neighbor_idx_list(self, node_index):
        return [i for i in range(self.n)
                if self.topology[i, node_index] > 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index):
        return [i for i in range(self.n)
                if self.topology[node_index, i] > 0 and i != node_index]

    def get_in_neighbor_weights(self, node_index):
        return [float(self.topology[i, node_index]) for i in range(self.n)]

    def get_out_neighbor_weights(self, node_index):
        return [float(self.topology[node_index, i]) for i in range(self.n)]


class AsymmetricTopologyManager(SymmetricTopologyManager):
    """Directed topology: start symmetric, delete random directed edges with
    probability ``undirected_neighbor_num`` semantics of reference
    ``asymmetric_topology_manager.py:23-74``, then row-normalize."""

    def __init__(self, n, neighbor_num=2, out_neighbor_num=2, seed=0):
        super().__init__(n, neighbor_num, seed)
        self.out_neighbor_num = out_neighbor_num

    def generate_topology(self):
        rng = np.random.default_rng(self._seed)
        topo = _ring_plus_random_topology(self.n, self.neighbor_num, rng)
        topo = np.maximum(topo, topo.T)
        # randomly delete directed edges (keep self-loop and ring neighbors so
        # the graph stays strongly connected)
        for i in range(self.n):
            off_ring = [j for j in range(self.n)
                        if topo[i, j] > 0 and j not in (i, (i + 1) % self.n, (i - 1) % self.n)]
            rng.shuffle(off_ring)
            n_del = max(0, len(off_ring) - self.out_neighbor_num)
            for j in off_ring[:n_del]:
                topo[i, j] = 0
        self.topology = topo / topo.sum(axis=1, keepdims=True)
        return self.topology


def mixing_matrix(n, algorithm="dsgd", topology=None, neighbor_num=2,
                  seed=0):
    """The gossip matrix of ``algorithm`` as float32 numpy ``[n, n]``.

    ``topology`` is a manager (default a :class:`SymmetricTopologyManager`
    of ``n`` nodes drawn from ``seed``), generated here if it has not
    been. DSGD takes its row-stochastic ``W``; PushSum the
    column-stochastic matrix on ``W``'s support: each sender splits its
    mass over its out-neighbors (with the row-stochastic ``W`` the
    de-biasing weight would stay 1)."""
    if algorithm not in ("dsgd", "pushsum"):
        raise ValueError(f"unknown gossip algorithm {algorithm!r}")
    tm = topology or SymmetricTopologyManager(n, neighbor_num=neighbor_num,
                                              seed=seed)
    if tm.topology is None:
        tm.generate_topology()
    W = np.asarray(tm.topology, np.float32)
    if algorithm == "pushsum":
        support = (W > 0).astype(np.float32)
        W = support / support.sum(axis=0, keepdims=True)
    return W
