"""Spawned ``torch.distributed`` groups for the port's multi-rank tests.

:class:`RankGroup` starts ``n`` processes (``spawn``) that form one
gloo group over a loopback TCP store, each with one torch thread, and
runs functions on every rank: ``group.run(fn, *args)`` calls ``fn(*args)``
on each rank and returns the ranks' results in rank order, or raises
with the first failing rank's traceback. ``fn`` must be importable by
name in a child (a module-level function of a jax-free module such as
``tests/torch_dist_cases.py``), and its arguments and result picklable.
A test module holds one group in a module-scoped fixture."""

import multiprocessing as mp
import os
import socket
import traceback

#: seconds a rank's task may take before the group is torn down
TASK_TIMEOUT_S = 240


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank, world, port, tasks, results, env):
    os.environ.update(env)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:  # noqa: BLE001 (reported to the test)
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankGroup:
    """``n`` spawned ranks of one gloo group (see the module docstring);
    ``env`` is set in every rank before torch is imported there."""

    def __init__(self, n, env=None):
        ctx = mp.get_context("spawn")
        self.n = n
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        port = free_port()
        env = dict(env or {})
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, n, port, self._tasks[r], self._results, env),
            daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args):
        for q in self._tasks:
            q.put((fn, args))
        out, errors = [None] * self.n, []
        for _ in range(self.n):
            rank, ok, value = self._results.get(timeout=TASK_TIMEOUT_S)
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError("\n".join(sorted(errors)))
        return out

    def close(self):
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
