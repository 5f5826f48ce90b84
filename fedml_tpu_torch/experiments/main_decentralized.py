"""Decentralized FL experiment main (counterpart of
``fedml_tpu/experiments/main_decentralized.py``; the reference's
``decentralized_demo`` and ``standalone/decentralized``: gossip over the
topology managers with DSGD or PushSum nodes), on the card:

    python -m fedml_tpu_torch.experiments.main_decentralized \
        --dataset synthetic --model lr --algorithm dsgd
    python -m fedml_tpu_torch.experiments.main_decentralized --online 1 \
        --algorithm pushsum --time_varying 1
    python -m fedml_tpu_torch.experiments.main_decentralized --platform cpu ...

Every client shard is one node. ``--online 1`` runs online logistic
regression over per-node streams instead: a UCI file when ``--data_dir``
names one, the synthetic stream otherwise. ``main(argv)`` returns ``(api,
states)``, or ``(api, w)`` online.
"""

from __future__ import annotations

import argparse
import os

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("DecentralizedFL-torch")
    common.add_base_args(p)
    p.add_argument("--algorithm", type=str, default="dsgd",
                   choices=["dsgd", "pushsum"])
    p.add_argument("--topology_neighbors", type=int, default=2)
    p.add_argument("--asymmetric", type=int, default=0,
                   help="1 = directed topology (random edge deletion)")
    p.add_argument("--online", type=int, default=0,
                   help="1 = streaming online learning over UCI-style "
                        "streams (the reference's standalone/decentralized)")
    p.add_argument("--stream_length", type=int, default=200)
    p.add_argument("--time_varying", type=int, default=0)
    p.add_argument("--beta", type=float, default=0.0,
                   help="adversarial (clustered) stream prefix fraction")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    common.refuse_unported(args)
    device = common.device_for(args)
    if args.online:
        return _online_main(args, device)
    logger = common.setup(args, run_name=f"Decentralized-{args.algorithm}")
    dataset, model = common.load_dataset_and_model(args)
    spec = common.make_spec(args, model, dataset)

    from fedml_tpu_torch.core.topology import (AsymmetricTopologyManager,
                                               SymmetricTopologyManager)
    cls = (AsymmetricTopologyManager if args.asymmetric
           else SymmetricTopologyManager)
    topology = cls(len(dataset[5]), neighbor_num=args.topology_neighbors,
                   seed=args.seed)
    topology.generate_topology()

    from fedml_tpu_torch.algorithms.decentralized import DecentralizedFedAPI
    api = DecentralizedFedAPI(dataset, spec, args, topology=topology,
                              algorithm=args.algorithm,
                              metrics_logger=logger, device=device)
    states = api.train()
    logger.close()
    return api, states


def _online_main(args, device):
    """The streaming path: the UCI file at ``--data_dir`` when it exists,
    the synthetic stream otherwise."""
    logger = common.setup(args, run_name=f"DecOnline-{args.algorithm}")
    from fedml_tpu_torch.data import uci
    if args.data_dir and os.path.exists(args.data_dir):
        streams = uci.load_streaming_uci(
            args.dataset, args.data_dir, args.client_num_in_total,
            args.stream_length * args.client_num_in_total,
            beta=args.beta, seed=args.seed)
    else:
        streams = uci.load_synthetic_stream(
            client_num=args.client_num_in_total, T=args.stream_length,
            seed=args.seed)

    from fedml_tpu_torch.algorithms.decentralized_online import (
        DecentralizedOnlineAPI)
    api = DecentralizedOnlineAPI(streams, args, algorithm=args.algorithm,
                                 metrics_logger=logger, device=device)
    w = api.train()
    logger.close()
    return api, w


if __name__ == "__main__":
    main()
