"""Decentralized (serverless) FL: gossip averaging over a topology
(counterpart of ``fedml_tpu/algorithms/decentralized.py``).

- DSGD: every node trains locally, then takes the weighted average of
  its in-neighbors' models through the row-stochastic mixing matrix of
  the topology managers (``core/topology.py``).
- PushSum for directed (asymmetric) topologies: nodes gossip ``(w * x,
  w)`` pairs over the column-stochastic support matrix and de-bias by the
  scalar weight ``w`` (``pushsum_w``).
- Compressed gossip (``--compressor``): each node ships its params delta
  from its pre-round state through the port's error feedback
  (``compression/compressors.py`` ``ErrorFeedback``, a residual a node)
  and the mixing runs on the reconstructed states.

Node states are stacked ``[N, ...]`` on the device: the N nodes train at
once through the engine's client update started from their own states
(the engine's ``make_node_update``), and one gossip step is one
product ``einsum("ij,j...->i...", W, x)`` a leaf in fp32, cast back.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from fedml_tpu_torch.compression.compressors import (ErrorFeedback,
                                                     get_compressor,
                                                     tree_items, tree_map)
from fedml_tpu_torch.compression.integration import (
    _meta, compressed_payload_nbytes, raw_payload_nbytes)
from fedml_tpu_torch.core.topology import mixing_matrix
from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                             client_seeds_for, fold_seed,
                                             make_node_update)
from fedml_tpu_torch.parallel.packing import pack_cohort
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.torch_import import (gate_join, gate_split,
                                                reference_state)


def mix_states(stacked_states, W):
    """One gossip mixing step: ``state_i <- sum_j W[i, j] state_j`` on
    every leaf (leading axis the N nodes), in fp32, cast back to each
    leaf's dtype."""
    return tree_map(lambda x: torch.einsum(
        "ij,j...->i...", W, x.float()).to(x.dtype), stacked_states)


def _per_node(w, x):
    """``w [N]`` shaped to broadcast against a ``[N, ...]`` leaf."""
    return w.reshape((-1,) + (1,) * (x.dim() - 1))


class DecentralizedFedAPI:
    """Serverless training loop: every node trains locally each round,
    then mixes with its topology neighbors (DSGD) or runs PushSum's
    de-biased gossip on directed graphs.

    Args:
      dataset: the 8-tuple; each client shard is one node.
      spec: a :class:`~fedml_tpu_torch.core.trainer.TrainSpec` with a
        ``stacked_loss_fn``.
      args: ``lr``, ``wd``, ``momentum``, ``client_optimizer``,
        ``batch_size``, ``epochs``, ``comm_round``, ``seed``,
        ``topology_neighbors``, ``compressor``.
      topology: a topology manager (default symmetric, ``seed``-drawn).
      algorithm: ``"dsgd"`` or ``"pushsum"``.
      device: ``None`` runs on the GPU and raises without one; ``"cpu"``
        runs on the CPU.
    """

    def __init__(self, dataset, spec, args, topology=None, algorithm="dsgd",
                 metrics_logger=None, compressor=None, device=None):
        (self.train_data_num, _, self.train_data_global,
         self.test_data_global, _, self.train_data_local_dict,
         self.test_data_local_dict, self.class_num) = dataset
        self.spec, self.args, self.algorithm = spec, args, algorithm
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        self.n_nodes = len(self.train_data_local_dict)
        self.seed = int(getattr(args, "seed", 0))
        W = mixing_matrix(self.n_nodes, algorithm, topology,
                          getattr(args, "topology_neighbors", 2), self.seed)
        self.W = torch.as_tensor(W, device=self.device)
        self.metrics_logger = metrics_logger or (
            lambda d: logging.info("%s", d))

        cfg = ClientUpdateConfig(
            optimizer=getattr(args, "client_optimizer", "sgd"),
            lr=args.lr, weight_decay=getattr(args, "wd", 0.0),
            momentum=getattr(args, "momentum", 0.0))
        self._update = make_node_update(spec, cfg)
        self.compressor = get_compressor(
            compressor if compressor is not None
            else getattr(args, "compressor", None))
        self._ef = (ErrorFeedback(self.compressor)
                    if self.compressor is not None else None)

        # every node starts from the same init (the reference broadcasts
        # rank 0's)
        init = spec.init_fn(self.seed, self.device)
        self.states = tree_map(
            lambda x: x.unsqueeze(0).expand((self.n_nodes,) + x.shape)
            .clone(), init)
        # per-node residuals over params only (what is compressed), in
        # the layout the compressor sees (an LSTM's gate leaves)
        self.residuals = {}
        if self._ef is not None:
            self.residuals = self._ef.init(gate_split(init["params"]),
                                           self.n_nodes)
            self._init_wire(init)
        self.pushsum_w = torch.ones(self.n_nodes, dtype=torch.float32,
                                    device=self.device)
        self._data_rng = np.random.default_rng(self.seed)
        self.round_idx = 0
        self.history = []

    def _init_wire(self, node0):
        """One node's update bytes, from shapes alone and under the
        reference's names: its compressed params plus any uncompressed
        non-params state (BatchNorm statistics gossip at full fidelity),
        and the whole state raw for the ratio."""
        ref = reference_state(node0)
        rest = {k: v for k, v in ref.items() if k != "params"}
        self._payload_bytes = compressed_payload_nbytes(
            self.compressor, ref["params"]) + (
                raw_payload_nbytes(rest) if rest else 0)
        self._raw_payload_bytes = raw_payload_nbytes(ref)

    def _compress(self, prev, local, round_seed):
        """Each node's params delta from its pre-round state through
        error feedback; the mixing sees ``prev + decoded``."""
        pp, lp = prev["params"], local["params"]
        delta = gate_split({k: lp[k] - pp[k] for k in pp})
        template = gate_split(_meta({k: v[0] for k, v in pp.items()}))
        seeds = client_seeds_for(fold_seed(round_seed, 3), self.n_nodes)
        _, dec, self.residuals = self._ef.step(delta, self.residuals,
                                               template, seeds)
        dec = gate_join(dec)
        recon = dict(local)
        recon["params"] = {k: pp[k] + dec[k] for k in pp}
        return recon

    def _gossip(self, local):
        if self.algorithm == "pushsum":
            w = self.pushsum_w
            weighted = tree_map(lambda x: x * _per_node(w, x), local)
            mixed = mix_states(weighted, self.W)
            self.pushsum_w = self.W @ w
            return tree_map(lambda x: x / _per_node(self.pushsum_w, x),
                            mixed)
        return mix_states(local, self.W)

    def train_one_round(self):
        packed = pack_cohort(
            [self.train_data_local_dict[i] for i in range(self.n_nodes)],
            self.args.batch_size, self.args.epochs, rng=self._data_rng)
        packed = {k: torch.as_tensor(v, device=self.device)
                  for k, v in packed.items()}
        packed["y"] = packed["y"].long()
        round_seed = int(fold_seed(self.seed, self.round_idx))
        local, _, metrics = self._update(
            self.states, packed, client_seeds_for(round_seed, self.n_nodes))
        with torch.no_grad():
            if self._ef is not None:
                local = self._compress(self.states, local, round_seed)
            self.states = self._gossip(local)
        m = {k: float(v.sum()) for k, v in metrics.items()}
        out = {"round": self.round_idx,
               "Train/Loss": m["loss_sum"] / max(m["count"], 1),
               "Train/Acc": m["correct"] / max(m["count"], 1)}
        if self._ef is not None:
            # each node ships one compressed update to its out-neighbors:
            # one send a node (broadcast links dedupe per edge)
            out["bytes_on_wire"] = self._payload_bytes * self.n_nodes
            out["compression_ratio"] = round(
                self._raw_payload_bytes / self._payload_bytes, 3)
        self.round_idx += 1
        self.history.append(out)
        self.metrics_logger(out)
        return out

    def consensus_distance(self):
        """Mean squared distance of the node models from their average,
        summed over the leaves: the convergence diagnostic of gossip."""
        total = 0.0
        for _, x in tree_items(self.states):
            x = x.float()
            sq = (x - x.mean(dim=0, keepdim=True)) ** 2
            if x.dim() > 1:
                sq = sq.sum(dim=tuple(range(1, x.dim())))
            total = total + sq.mean()
        return float(total)

    def node_state(self, i):
        return tree_map(lambda x: x[i], self.states)

    def train(self):
        for _ in range(self.args.comm_round):
            self.train_one_round()
        return self.states


__all__ = ["DecentralizedFedAPI", "mix_states"]
