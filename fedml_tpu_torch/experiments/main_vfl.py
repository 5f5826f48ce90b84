"""Vertical FL experiment main (counterpart of
``fedml_tpu/experiments/main_vfl.py``; the reference's
``classical_vertical_fl``: the guest/host protocol of
``guest_trainer.py:59-80``), on the card:

    python -m fedml_tpu_torch.experiments.main_vfl \
        --dataset synthetic_vertical --party_num 3
    python -m fedml_tpu_torch.experiments.main_vfl --dataset lending_club \
        --data_dir D --party_num 2
    python -m fedml_tpu_torch.experiments.main_vfl --platform cpu ...

``lending_club`` (2 or 3 parties), ``nus_wide`` (person against animal)
and ``synthetic_vertical`` load the vertical sets
(``data/vertical_finance.py``); any other dataset name loads its 8-tuple
and splits the flattened features column-wise over ``--party_num``
parties, with labels ``y % 2``. Party 0, the guest, holds the labels.
``main(argv)`` returns ``(api, history)``.
"""

from __future__ import annotations

import argparse

import numpy as np

from fedml_tpu_torch.experiments import common


def _load_vertical(args):
    """The vertical sets (the reference's finance loaders)."""
    from fedml_tpu_torch.data import vertical_finance as vf
    if args.dataset == "lending_club":
        return (vf.loan_load_two_party_data(args.data_dir)
                if args.party_num == 2
                else vf.loan_load_three_party_data(args.data_dir))
    if args.dataset == "nus_wide":
        labels = ["person", "animal"]
        xa, xb, y = vf.nus_wide_load_two_party_data(
            args.data_dir, labels, dtype="Train")
        xa_t, xb_t, y_t = vf.nus_wide_load_two_party_data(
            args.data_dir, labels, dtype="Test")
        return [xa, xb, y], [xa_t, xb_t, y_t]
    return vf.load_synthetic_vertical(party_num=args.party_num,
                                      seed=args.seed)


def _column_split(args):
    """Any classification 8-tuple's pooled sets, features split
    column-wise, labels ``y % 2``."""
    from fedml_tpu_torch.data.registry import load_dataset
    dataset = load_dataset(args, args.dataset)
    flat = lambda d: np.asarray(d["x"], np.float32).reshape(
        (len(d["x"]), -1))
    x_train, x_test = flat(dataset[2]), flat(dataset[3])
    y_train = (np.asarray(dataset[2]["y"]) % 2).astype(np.float32)
    y_test = (np.asarray(dataset[3]["y"]) % 2).astype(np.float32)
    splits = np.array_split(np.arange(x_train.shape[1]), args.party_num)
    return ([x_train[:, s] for s in splits], y_train,
            [x_test[:, s] for s in splits], y_test)


def parser():
    p = argparse.ArgumentParser("VerticalFL-torch")
    common.add_base_args(p)
    p.add_argument("--party_num", type=int, default=2)
    p.add_argument("--hidden_dim", type=int, default=16)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    common.refuse_unported(args)
    device = common.device_for(args)
    logger = common.setup(args, run_name="VFL")
    if args.dataset in ("lending_club", "nus_wide", "synthetic_vertical"):
        train, test = _load_vertical(args)
        party_data, y_train = train[:-1], train[-1].reshape(-1)
        test_party_data, y_test = test[:-1], test[-1].reshape(-1)
        args.party_num = len(party_data)
    else:
        party_data, y_train, test_party_data, y_test = _column_split(args)

    from fedml_tpu_torch.models.linear import LocalModel
    party_models = [LocalModel(x.shape[1], hidden_dims=(args.hidden_dim,),
                               output_dim=1) for x in party_data]

    from fedml_tpu_torch.algorithms.vertical import VerticalFLAPI
    api = VerticalFLAPI(party_models, party_data, y_train, args,
                        test_party_data=test_party_data, test_labels=y_test,
                        device=device)
    history = api.fit()
    for record in history:
        logger(record)
    logger.close()
    return api, history


if __name__ == "__main__":
    main()
