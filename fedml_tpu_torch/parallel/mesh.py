"""Named grids of ranks for federated rounds (counterpart of
``fedml_tpu/parallel/mesh.py``).

The reference shards clients over the ``clients`` axis of one JAX mesh
driven by one process. Here every rank of a ``torch.distributed`` world
runs the same program on its own device: a :class:`Mesh` lays the ranks
out on named axes over a ``DeviceMesh``, gives each axis its process
group and this rank's coordinate, and binds the rank's device. A second
optional ``model`` axis keeps the reference's ``(clients, model)``
layout.

A mesh needs a process group. When none is initialised, the mesh forms
a one-rank group (``HashStore``, no socket), so ``--mesh 1`` runs
through the same collective calls as a mesh of many ranks. A card mesh
needs an NCCL group and a CPU mesh a gloo group; a group of the other
backend raises, with no fallback.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.parallel.packing import zero_pad_leading

CLIENT_AXIS = "clients"
MODEL_AXIS = "model"


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def ensure_process_group(device: torch.device):
    """The world's process group, formed as one rank when none exists;
    raises when the existing group's backend does not serve ``device``
    (a card needs NCCL)."""
    want = _backend_for(device)
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = str(dist.get_backend())
    if want not in have:
        raise RuntimeError(
            f"the process group's backend is {have!r}, and a "
            f"{device.type} mesh needs {want!r}")
    return dist.group.WORLD


class Mesh:
    """Ranks on named axes (the reference's ``jax.sharding.Mesh``):
    ``shape`` maps each axis name to its size, ``device`` is this rank's
    device, :meth:`group` an axis's process group (all of the mesh's
    ranks for ``None``) and :meth:`index` this rank's coordinate."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.size = int(np.prod(list(self.shape.values())))
        ranks = device_mesh.mesh.flatten().tolist()
        # every rank of the world takes part in forming a group
        self._all = (dist.group.WORLD
                     if len(ranks) == dist.get_world_size()
                     else dist.new_group(ranks))
        if device_mesh.get_coordinate() is None:
            raise ValueError(
                f"rank {dist.get_rank()} is outside the {self.size}-rank "
                "mesh: launch as many ranks as the mesh has")

    def group(self, axis=None):
        return self._all if axis is None else self.device_mesh.get_group(
            axis)

    def index(self, axis) -> int:
        return int(self.device_mesh.get_local_rank(axis))


def make_mesh(shape, axis_names, devices=None, device=None) -> Mesh:
    """A grid of ``shape`` (one size an axis) over the first ranks of the
    world (or over ``devices``, a list of ranks), named ``axis_names``.
    ``device`` is this rank's device: ``"cpu"``, or for None the CUDA
    device the rank is bound to (``multihost.maybe_initialize_distributed``
    binds ``cuda:<local rank>``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from fedml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    ensure_process_group(dev)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    need = int(np.prod(shape))
    if need > len(ranks):
        raise ValueError(f"mesh needs {need} devices, have {len(ranks)}")
    grid = torch.tensor(ranks[:need]).reshape(tuple(shape))
    return Mesh(DeviceMesh(dev.type, grid, mesh_dim_names=tuple(axis_names)),
                dev)


def make_2d_mesh(n_a: int, n_b: int, axis_names, devices=None,
                 device=None) -> Mesh:
    """A ``(n_a, n_b)`` :func:`make_mesh`, the shared constructor behind
    the ``(clients, model)``, ``(data, seq)``, ``(data, model)`` and
    ``(data, expert)`` meshes."""
    return make_mesh((n_a, n_b), axis_names, devices, device)


def make_client_mesh(n_client_shards=None, n_model_shards=1, devices=None,
                     device=None) -> Mesh:
    """A ``(clients, model)`` mesh; ``n_client_shards`` defaults to the
    world's ranks over ``n_model_shards``. One rank alone makes a 1x1
    mesh: the same round program runs on one device and on many."""
    if n_client_shards is None:
        from fedml_tpu_torch.utils.device import resolve_device

        ensure_process_group(resolve_device(device))
        world = (dist.get_world_size() if devices is None
                 else len(devices))
        n_client_shards = max(1, world // n_model_shards)
    return make_2d_mesh(n_client_shards, n_model_shards,
                        (CLIENT_AXIS, MODEL_AXIS), devices, device)


def client_sharding(mesh: Mesh):
    """The placement of arrays whose leading axis is clients: the spec
    ``multihost.global_put`` splits over ``mesh``'s ``clients`` axis (the
    reference's ``NamedSharding(mesh, P(CLIENT_AXIS))``)."""
    return (CLIENT_AXIS,)


def replicated_sharding(mesh: Mesh):
    """Every rank holds the whole array (the reference's ``P()``)."""
    return ()


def pad_cohort_to_multiple(cohort_data, multiple):
    """The cohort's client axis padded to a multiple of ``multiple`` with
    zero-weight dummy clients, so a cohort that does not divide the mesh
    still shards evenly."""
    C = len(next(iter(cohort_data.values())))
    return zero_pad_leading(dict(cohort_data), (-C) % multiple)


def shard_cohort(mesh: Mesh, cohort_data):
    """This rank's block of a host-replicated packed cohort (leading axis
    = clients), padded to the mesh's client axis first and placed on the
    rank's device: a :class:`~fedml_tpu_torch.parallel.multihost.Sharded`."""
    from fedml_tpu_torch.parallel.multihost import global_cohort

    return global_cohort(mesh, cohort_data)


__all__ = ["CLIENT_AXIS", "MODEL_AXIS", "Mesh", "ensure_process_group",
           "make_mesh", "make_2d_mesh", "make_client_mesh", "client_sharding",
           "replicated_sharding", "zero_pad_leading",
           "pad_cohort_to_multiple", "shard_cohort"]
