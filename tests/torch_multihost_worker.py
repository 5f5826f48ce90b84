"""One rank of the port's env-launched multi-process round: run as
``python tests/torch_multihost_worker.py`` with the launcher's
environment (``FEDML_TPU_COORDINATOR``, ``FEDML_TPU_NUM_PROCESSES``,
``FEDML_TPU_PROCESS_ID``, or torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``). It joins the group through
``maybe_initialize_distributed``, runs the sharded LR round of the
reference's ``tests/multihost_worker.py``, one seq-parallel LM step
(``seq`` over every rank), one tensor-parallel step (``model`` over
every rank) and one pipeline step (a stage a rank), and prints one
``RESULT`` line. Imports no JAX."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

def main():
    import torch_dist_cases as cases
    from fedml_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed, process_index)

    torch.set_num_threads(1)
    rank, world = maybe_initialize_distributed("cpu")
    assert (rank, world) == (process_index(), torch.distributed
                             .get_world_size())
    init = np.load(sys.argv[1], allow_pickle=True).item()
    out = cases.sharded_round_lr(init["lr"], cases.MULTIHOST_SIZES, 3, 0.3,
                                 5)
    checksum = sum(float(np.float64(v).sum())
                   for part in out["sharded"].values()
                   for v in part.values())
    new, loss, _ = cases.sp_step(init["lm"], init["idx"], 1)
    sp_checksum = sum(float(np.float64(v).sum()) for v in new.values())
    tp = cases.tp_step(init["tp"], init["tp_idx"], 1, cases.MULTIHOST_TP,
                       16)
    pp = cases.pp_step(init["pp"], init["pp_idx"], cases.MULTIHOST_PP, 2)
    sums = {name: sum(float(np.float64(v).sum()) for v in params.values())
            for name, params in (("tp", tp["gathered"]),
                                 ("pp", pp["params"]))}
    print(f"RESULT process={rank} world={world} checksum={checksum!r} "
          f"count={out['count']!r} sp_loss={loss!r} "
          f"sp_checksum={sp_checksum!r} tp_loss={tp['loss']!r} "
          f"tp_checksum={sums['tp']!r} pp_loss={pp['loss']!r} "
          f"pp_checksum={sums['pp']!r}", flush=True)


if __name__ == "__main__":
    main()
