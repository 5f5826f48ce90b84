"""Rank-tagged logging in the reference's line format (counterpart of
``fedml_tpu/utils/logging_utils.py``): every line starts with the
process's tag, by default its ``torch.distributed`` rank (0 outside a
group), as the reference tags its lines with the MPI rank."""

from __future__ import annotations

import logging


def init_logging(process_id=None, level=logging.INFO, proctitle=None):
    """Root logging with ``"<process_id> - <time> <file>:<line>]
    <message>"``; ``proctitle`` is applied when ``setproctitle`` is
    installed. Returns the root logger."""
    if process_id is None:
        from fedml_tpu_torch.parallel.multihost import process_index
        process_id = process_index()
    fmt = (str(process_id)
           + " - %(asctime)s %(filename)s:%(lineno)d] %(message)s")
    logging.basicConfig(level=level, format=fmt,
                        datefmt="%a, %d %b %Y %H:%M:%S", force=True)
    if proctitle:
        try:
            import setproctitle
        except ImportError:
            pass
        else:
            setproctitle.setproctitle(proctitle)
    return logging.getLogger()


__all__ = ["init_logging"]
