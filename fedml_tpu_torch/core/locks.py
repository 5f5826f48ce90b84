"""Lock factories of the control plane: its locks' declared intent
(counterpart of ``fedml_tpu/core/locks.py``).

The threaded control plane (``core/comm/*``, ``resilience/*``) creates
its locks through these factories instead of bare ``threading.Lock()``,
which declares each lock's intent: a *state* lock guards instance
attributes and must never be held across a blocking call; an
``io_lock`` exists to be held across one peer's blocking socket write,
so a stalled peer serializes only its own pipe. In the reference the
factories are also the hook of the runtime race auditor; here they
return plain ``threading`` primitives until ROADMAP A16 ports the audit
(``--race_audit``).

Stdlib only.
"""

from __future__ import annotations

import threading


def audited_lock():
    """A *state* lock: guards instance attributes; never hold it across
    blocking calls (socket writes, sends, joins)."""
    return threading.Lock()


def audited_rlock():
    """Reentrant *state* lock (e.g. the resilient server's round-turnover
    lock, whose peer-lost chain may re-enter the abandon path)."""
    return threading.RLock()


def io_lock():
    """A dedicated I/O serialization lock: its *purpose* is to be held
    across one blocking write so concurrent writers to the same pipe
    interleave whole frames."""
    return threading.Lock()


__all__ = ["audited_lock", "audited_rlock", "io_lock"]
