"""Analysis-facing alias for the lock factories (counterpart of
``fedml_tpu/analysis/locks.py``).

The implementation lives in :mod:`fedml_tpu_torch.core.locks`, a
stdlib-only leaf, so the transports create declared locks without
importing the analysis machinery;
:func:`fedml_tpu_torch.analysis.runtime.race_audit` arms the
instrumentation by setting ``fedml_tpu_torch.core.locks._auditor``.
"""

from fedml_tpu_torch.core.locks import (audited_lock, audited_rlock,
                                        creation_site, io_lock)

__all__ = ["audited_lock", "audited_rlock", "io_lock", "creation_site"]
