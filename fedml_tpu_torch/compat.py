"""The reference's call shapes (counterpart of ``fedml_tpu/compat.py``):
``FedML_init()`` and ``FedML_<Algo>_distributed(process_id,
worker_number, device, comm, model, <dataset fields>, args,
model_trainer=None)``, so launch code written against them runs here.

- ``FedML_init`` joins the process group the environment describes
  (``parallel.multihost.maybe_initialize_distributed``) and returns
  ``(None, rank, world)``; a process alone gets ``(None, 0, 1)``.
- ``model`` is a torch module of the port's zoo. ``device`` places the
  run (``"cpu"``, or None for the card); ``comm``, ``process_id``,
  ``worker_number`` and ``model_trainer`` are accepted for the call
  shape.
- Every rank runs the same round loop: with ``args.mesh`` N the clients
  are sharded over the first N ranks, otherwise each rank runs the
  single-device simulation.

Each call trains for ``args.comm_round`` rounds and returns the API.
"""

from __future__ import annotations

import numpy as np


def FedML_init(device=None):
    """The process group from the environment: ``(None, rank, world)``
    (the first slot is the reference's MPI communicator). ``device="cpu"``
    forms a gloo group, otherwise a card rank binds its GPU and NCCL."""
    from fedml_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed)

    process_id, worker_number = maybe_initialize_distributed(device)
    return None, process_id, worker_number


def _dataset_tuple(train_data_num, train_data_global, test_data_global,
                   train_data_local_num_dict, train_data_local_dict,
                   test_data_local_dict, class_num):
    test_num = (len(test_data_global["y"])
                if test_data_global is not None else 0)
    return [train_data_num, test_num, train_data_global, test_data_global,
            train_data_local_num_dict, train_data_local_dict,
            test_data_local_dict, class_num]


def _device_for(device, args):
    from fedml_tpu_torch.utils.device import resolve_device

    if device is None:
        device = getattr(args, "device", None)
    if device is None and getattr(args, "platform", None) == "cpu":
        device = "cpu"
    return resolve_device(device)


def _mesh_for(args, device):
    """The ``args.mesh`` clients mesh over the first N ranks, or None."""
    n = int(getattr(args, "mesh", 0) or 0)
    if not n:
        return None
    from fedml_tpu_torch.parallel.mesh import make_client_mesh

    return make_client_mesh(n, device=device)


def _run(api_cls, model, device, dataset_fields, args, **api_kw):
    from fedml_tpu_torch.algorithms.specs import make_classification_spec

    (train_data_num, train_data_global, test_data_global,
     train_data_local_num_dict, train_data_local_dict,
     test_data_local_dict) = dataset_fields
    class_num = int(getattr(args, "class_num", 0) or 0)
    if not class_num:
        ys = [np.asarray(d["y"]) for d in train_data_local_dict.values()
              if d is not None and len(d["y"])]
        class_num = int(max(int(y.max()) for y in ys) + 1)
    dataset = _dataset_tuple(train_data_num, train_data_global,
                             test_data_global, train_data_local_num_dict,
                             train_data_local_dict, test_data_local_dict,
                             class_num)
    dev = _device_for(device, args)
    api = api_cls(dataset, make_classification_spec(model), args,
                  mesh=_mesh_for(args, dev), device=dev, **api_kw)
    api.train()
    return api


def FedML_FedAvg_distributed(process_id, worker_number, device, comm, model,
                             train_data_num, train_data_global,
                             test_data_global, train_data_local_num_dict,
                             train_data_local_dict, test_data_local_dict,
                             args, model_trainer=None):
    """The reference's ``FedAvgAPI.py:17-25`` call shape."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI

    return _run(FedAvgAPI, model, device,
                (train_data_num, train_data_global, test_data_global,
                 train_data_local_num_dict, train_data_local_dict,
                 test_data_local_dict), args)


def FedML_FedOpt_distributed(process_id, worker_number, device, comm, model,
                             train_data_num, train_data_global,
                             test_data_global, train_data_local_num_dict,
                             train_data_local_dict, test_data_local_dict,
                             args, model_trainer=None):
    """The reference's ``FedOptAPI.py`` call shape."""
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI

    return _run(FedOptAPI, model, device,
                (train_data_num, train_data_global, test_data_global,
                 train_data_local_num_dict, train_data_local_dict,
                 test_data_local_dict), args)


def FedML_FedNova_distributed(process_id, worker_number, device, comm, model,
                              train_data_num, train_data_global,
                              test_data_global, train_data_local_num_dict,
                              train_data_local_dict, test_data_local_dict,
                              args, model_trainer=None):
    """The reference's FedNova call shape."""
    from fedml_tpu_torch.algorithms.fednova import FedNovaAPI

    return _run(FedNovaAPI, model, device,
                (train_data_num, train_data_global, test_data_global,
                 train_data_local_num_dict, train_data_local_dict,
                 test_data_local_dict), args)


def FedML_FedAvgRobust_distributed(process_id, worker_number, device, comm,
                                   model, train_data_num, train_data_global,
                                   test_data_global,
                                   train_data_local_num_dict,
                                   train_data_local_dict,
                                   test_data_local_dict, args,
                                   model_trainer=None):
    """The reference's ``FedAvgRobustAPI.py`` call shape."""
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustAPI

    return _run(FedAvgRobustAPI, model, device,
                (train_data_num, train_data_global, test_data_global,
                 train_data_local_num_dict, train_data_local_dict,
                 test_data_local_dict), args)


__all__ = ["FedML_init", "FedML_FedAvg_distributed",
           "FedML_FedOpt_distributed", "FedML_FedNova_distributed",
           "FedML_FedAvgRobust_distributed"]
