"""Metrics sink of the experiment mains (counterpart of
``fedml_tpu/utils/metrics.py`` and ``init_logging``): every ``log()``
appends one JSON line to ``<run_dir>/metrics.jsonl`` and rewrites
``<run_dir>/summary.json`` (the last value of each key, the
wandb-summary equivalent); ``config.json`` holds the run's arguments.
With a metrics registry armed (``observability.enable``) every record
also carries the series that moved since the last one (``m/`` keys).
With ``enable_wandb`` the records are mirrored to wandb when the package
imports; where it does not, one log line says so and the JSONL stays
the only sink. Nothing is installed."""

from __future__ import annotations

import json
import logging
import os
import time

from fedml_tpu_torch.core.locks import audited_lock
from fedml_tpu_torch.observability.registry import get_registry


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
    """Callable metrics sink: ``logger(dict)`` or ``logger.log(dict)``.

    Wire accounting: the compressed simulation rounds set
    ``bytes_on_wire`` / ``compression_ratio`` directly on their records;
    the TCP hub feeds its sent and received bytes through
    :meth:`count_wire`, and the accumulated totals attach to the next
    record that does not carry a ``bytes_on_wire`` field (then reset);
    any residual still pending at :meth:`close` is flushed as a final
    ``wire_flush_at_close`` record.
    """

    def __init__(self, run_dir=None, enable_wandb=False, run_name=None,
                 config=None):
        self.run_dir = run_dir
        self._jsonl = None
        self._summary = {}
        self._wire_bytes = 0
        self._wire_raw_bytes = 0
        self._wire_lock = audited_lock()
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
            if config is not None:
                with open(os.path.join(run_dir, "config.json"), "w") as f:
                    json.dump(_jsonable(vars(config)
                                        if hasattr(config, "__dict__")
                                        else dict(config)),
                              f, indent=2, sort_keys=True)
        self._wandb = None
        if enable_wandb:
            try:
                import wandb
            except ImportError:
                logging.info("wandb not installed; metrics go to JSONL only")
            else:
                self._wandb = wandb
                wandb.init(project="fedml_tpu", name=run_name,
                           config=config if config is None else _jsonable(
                               vars(config) if hasattr(config, "__dict__")
                               else dict(config)))

    def count_wire(self, encoded_bytes, raw_bytes=0):
        """Accumulate on-wire payload bytes (and, optionally, what the same
        payload would cost uncompressed) toward the next logged record.
        Several serve threads count at once, so the counters are
        lock-guarded."""
        with self._wire_lock:
            self._wire_bytes += int(encoded_bytes)
            self._wire_raw_bytes += int(raw_bytes)

    def log(self, metrics: dict):
        record = _jsonable(metrics)
        with self._wire_lock:
            if self._wire_bytes and "bytes_on_wire" not in record:
                record["bytes_on_wire"] = self._wire_bytes
                if self._wire_raw_bytes:
                    record["compression_ratio"] = round(
                        self._wire_raw_bytes / self._wire_bytes, 3)
                self._wire_bytes = 0
                self._wire_raw_bytes = 0
        registry = get_registry()
        if registry is not None:
            # every series that moved since the last record rides this
            # one under an ``m/`` prefix
            registry.snapshot_into(record)
        logging.info("%s", record)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"_ts": time.time(), **record},
                                         sort_keys=True) + "\n")
            self._jsonl.flush()
            self._summary.update(record)
            with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
                json.dump(self._summary, f, indent=2, sort_keys=True)
        if self._wandb is not None:
            self._wandb.log(record)

    __call__ = log

    def close(self):
        with self._wire_lock:
            residual = self._wire_bytes
        if residual:
            self.log({"event": "wire_flush_at_close"})
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


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
