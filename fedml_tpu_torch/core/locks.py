"""Lock factories of the control plane: its locks' declared intent and
the race auditor's hook (counterpart of ``fedml_tpu/core/locks.py``).

The threaded control plane (``core/comm/*``, ``resilience/*``, the
metrics wire counters) creates its locks through these factories instead
of bare ``threading.Lock()``, which declares each lock's intent: a
*state* lock guards instance attributes and must never be held across a
blocking call; an ``io_lock`` exists to be held across one peer's
blocking socket write, so a stalled peer serializes only its own pipe.

Inside ``fedml_tpu_torch.analysis.runtime.race_audit()`` the factories
return *audited* locks that record acquisition order (lock-order cycles)
and held-while-blocking events. Outside an audit they return plain
``threading`` primitives: no overhead, no change of behaviour.

Stdlib only, so the transports depend on it without pulling the
analysis machinery in; ``fedml_tpu_torch.analysis.locks`` re-exports it.
"""

from __future__ import annotations

import os
import threading
import traceback

#: Armed by ``fedml_tpu_torch.analysis.runtime.race_audit``; when set,
#: the factories route through ``_auditor.make_lock``.
_auditor = None


def creation_site():
    """``basename.py:lineno`` of the statement creating a lock through
    these factories, skipping the factory and instrumentation frames
    (``locks.py``, ``runtime.py``). This string is the lock's identity
    for the race auditor's order edges and the flight recorder's
    ``held_while_blocking`` events."""
    own = ("locks.py", "runtime.py")
    for frame in reversed(traceback.extract_stack()[:-1]):
        base = os.path.basename(frame.filename)
        if base not in own:
            return f"{base}:{frame.lineno}"
    return "<unknown>"


def _make(kind, reentrant):
    if _auditor is None:
        return threading.RLock() if reentrant else threading.Lock()
    return _auditor.make_lock(kind=kind, reentrant=reentrant)


def audited_lock():
    """A *state* lock: guards instance attributes; never hold it across
    blocking calls (socket writes, sends, joins)."""
    return _make("state", reentrant=False)


def audited_rlock():
    """Reentrant *state* lock (e.g. the resilient server's round-turnover
    lock, whose peer-lost chain may re-enter the abandon path)."""
    return _make("state", reentrant=True)


def io_lock():
    """A dedicated I/O serialization lock: its *purpose* is to be held
    across one blocking write so concurrent writers to the same pipe
    interleave whole frames. Exempt from the held-while-blocking check;
    still part of the lock-order tracking."""
    return _make("io", reentrant=False)


__all__ = ["audited_lock", "audited_rlock", "io_lock", "creation_site"]
