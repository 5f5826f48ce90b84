"""Metrics sink of the experiment mains (counterpart of
``fedml_tpu/utils/metrics.py`` and ``init_logging``): every ``log()``
appends one JSON line to ``<run_dir>/metrics.jsonl`` and rewrites
``<run_dir>/summary.json`` (the last value of each key, the
wandb-summary equivalent); ``config.json`` holds the run's arguments.
wandb is not carried (``--enable_wandb`` is refused by the mains)."""

from __future__ import annotations

import json
import logging
import os
import time


def init_logging(proctitle=None):
    """Root logging at INFO with the reference's line format;
    ``proctitle`` is applied when ``setproctitle`` is installed."""
    fmt = "0 - %(asctime)s %(filename)s:%(lineno)d] %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt,
                        datefmt="%a, %d %b %Y %H:%M:%S", force=True)
    if proctitle:
        try:
            import setproctitle
        except ImportError:
            return
        setproctitle.setproctitle(proctitle)


class MetricsLogger:
    """Callable metrics sink: ``logger(dict)`` or ``logger.log(dict)``."""

    def __init__(self, run_dir=None, config=None):
        self.run_dir = run_dir
        self._jsonl = None
        self._summary = {}
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
            if config is not None:
                with open(os.path.join(run_dir, "config.json"), "w") as f:
                    json.dump(_jsonable(vars(config)
                                        if hasattr(config, "__dict__")
                                        else dict(config)),
                              f, indent=2, sort_keys=True)

    def log(self, metrics: dict):
        record = _jsonable(metrics)
        logging.info("%s", record)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"_ts": time.time(), **record},
                                         sort_keys=True) + "\n")
            self._jsonl.flush()
            self._summary.update(record)
            with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
                json.dump(self._summary, f, indent=2, sort_keys=True)

    __call__ = log

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def _jsonable(d):
    return {str(k): _jsonable_value(v) for k, v in d.items()}


def _jsonable_value(v):
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, dict):
        return _jsonable(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable_value(x) for x in v]
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    return str(v)


__all__ = ["MetricsLogger", "init_logging"]
