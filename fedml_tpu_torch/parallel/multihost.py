"""Multi-rank execution over ``torch.distributed`` (counterpart of
``fedml_tpu/parallel/multihost.py``).

The reference runs one SPMD program over a global mesh from one process
per host. The port runs one process per device, every rank the same
Python loop: each holds the host-replicated cohort (the packing draws
from identically seeded generators on every rank), places only its own
row block on its device, and meets the others in collectives. This
module is that control plane:

- :func:`maybe_initialize_distributed`: the process group from the
  environment (``FEDML_TPU_COORDINATOR``, ``FEDML_TPU_NUM_PROCESSES``,
  ``FEDML_TPU_PROCESS_ID``, or torchrun's ``MASTER_ADDR``/
  ``MASTER_PORT``/``WORLD_SIZE``/``RANK``); a process alone gets
  ``(0, 1)``, so every entry point calls it;
- :func:`global_cohort` / :func:`global_put`: this rank's block of a
  host-replicated tree (a :class:`Sharded` for the client axis);
- :func:`all_reduce_sum`, :func:`gather_metrics`, :func:`is_primary`,
  :func:`sync`: one fused fp32 sum, the client-sharded outputs gathered
  to every rank, logging and saving on rank 0, and the barrier.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

#: seconds a rank waits for the others to join the group
DEFAULT_INIT_TIMEOUT_S = 300.0


def _env_world():
    """``(address, world, rank)`` from the environment, or None."""
    coord = os.environ.get("FEDML_TPU_COORDINATOR")
    nproc = os.environ.get("FEDML_TPU_NUM_PROCESSES")
    if coord and nproc and int(nproc) > 1:
        return coord, int(nproc), int(os.environ["FEDML_TPU_PROCESS_ID"])
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if os.environ.get("MASTER_ADDR") and world > 1:
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
        return addr, world, int(os.environ["RANK"])
    return None


def _bind_device(device, rank):
    """This rank's device: ``cuda:<local rank>`` (bound as the current
    device) unless ``device`` asks for something else."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a rank runs on the GPU unless the caller "
            "passes device='cpu' explicitly")
    local = int(os.environ.get("LOCAL_RANK",
                               rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def maybe_initialize_distributed(device=None, timeout_s=None):
    """Join the process group the environment describes and return
    ``(rank, world)``; ``(0, 1)`` for a process alone. A card rank binds
    ``cuda:<local rank>`` and uses NCCL; ``device="cpu"`` uses gloo.
    Calling it again, or inside a group formed by the caller, returns
    that group's ``(rank, world)``. A connect failure raises after
    ``timeout_s`` (default ``FEDML_TPU_INIT_TIMEOUT_S`` or 300 s):
    swallowing it would leave every rank training alone as rank 0."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    spec = _env_world()
    if spec is None:
        return 0, 1
    addr, world, rank = spec
    dev = _bind_device(device, rank)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if timeout_s is None:
        timeout_s = float(os.environ.get("FEDML_TPU_INIT_TIMEOUT_S",
                                         DEFAULT_INIT_TIMEOUT_S))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    except ValueError as e:
        # tolerate only a second initialisation, never a failed connect
        if "twice" not in str(e):
            raise
        logging.debug("process group already initialised: %s", e)
    logging.info("torch.distributed: rank %d/%d via %s (%s)",
                 dist.get_rank(), world, addr, backend)
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


@dataclasses.dataclass
class Sharded:
    """This rank's block of a host-replicated tree whose leading axis is
    sharded over ``mesh[axis]``: ``local`` holds rows ``start ..
    start + block`` of ``total`` (the padded length), on the rank's
    device."""
    local: dict
    start: int
    total: int
    mesh: object
    axis: str


def _to_device(x, device):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device)


def _block(n, parts, index, what):
    if n % parts:
        raise ValueError(f"{what}: {n} rows do not split over {parts} "
                         "ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def global_cohort(mesh, cohort_data):
    """This rank's block of a host-replicated packed cohort, sharded over
    the client axis: the cohort is padded to a multiple of the axis with
    zero-weight dummy clients, and every rank places its own rows
    (:func:`global_put` over ``client_sharding``; the cohort is the
    same on every rank, since the packing is seeded alike). Integer
    labels become int64. Returns a :class:`Sharded`."""
    from fedml_tpu_torch.parallel.mesh import (CLIENT_AXIS, client_sharding,
                                               pad_cohort_to_multiple)

    parts = mesh.shape[CLIENT_AXIS]
    padded = pad_cohort_to_multiple(cohort_data, parts)
    total = len(next(iter(padded.values())))
    local = global_put(mesh, padded, client_sharding(mesh))
    if "y" in local and not local["y"].is_floating_point():
        local["y"] = local["y"].long()
    return Sharded(local, mesh.index(CLIENT_AXIS) * (total // parts), total,
                   mesh, CLIENT_AXIS)


def global_put(mesh, tree, spec=()):
    """This rank's block of a host-replicated tree: ``spec`` names the
    mesh axis each leading dimension is split over (None for a whole
    dimension; ``()`` replicates), as the reference's ``PartitionSpec``.
    Leaves land on the rank's device."""
    if isinstance(tree, dict):
        return {k: global_put(mesh, v, spec) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(global_put(mesh, v, spec) for v in tree)
    x = tree
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        sl = _block(x.shape[dim], mesh.shape[axis], mesh.index(axis),
                    f"axis {axis!r}")
        x = x[(slice(None),) * dim + (sl,)]
    return _to_device(x, mesh.device)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def all_reduce_sum(tree, group=None):
    """Every leaf of ``tree`` summed over ``group``'s ranks in fp32, as
    one flat buffer and one collective (the reference's ``psum``s).
    Returns the tree of fp32 sums, leaves shaped as given."""
    leaves = _leaves(tree)
    flat = torch.cat([t.detach().float().reshape(-1) for t in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, pos = [], 0
    for t in leaves:
        n = t.numel()
        out.append(flat[pos:pos + n].reshape(t.shape))
        pos += n
    return _rebuild(tree, iter(out))


def _gather_rows(t, sh):
    group = sh.mesh.group(sh.axis)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts).cpu().numpy()


def gather_metrics(tree):
    """Round outputs as numpy on every rank: a :class:`Sharded` tree is
    gathered row block by row block over its axis (the padded rows
    included, as the reference's global arrays hold them); tensors and
    arrays are replicated and read locally."""
    if isinstance(tree, Sharded):
        return _rebuild(tree.local, iter(
            [_gather_rows(t, tree) for t in _leaves(tree.local)]))
    return _rebuild(tree, iter(
        [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
         else np.asarray(t) for t in _leaves(tree)]))


def sync(tag: str = "fedml_tpu"):
    """Barrier across the world's ranks (the reference's MPI barrier
    between rounds); nothing for a process alone."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        logging.debug("sync %s", tag)
        if "nccl" in str(dist.get_backend()):
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


__all__ = ["maybe_initialize_distributed", "process_index", "is_primary",
           "Sharded", "global_cohort", "global_put", "all_reduce_sum",
           "gather_metrics", "sync", "DEFAULT_INIT_TIMEOUT_S"]
