"""The network tier (counterpart of ``fedml_tpu/net``): only
:mod:`.ingest`'s accounting, which the TCP hub uses, is ported; the
event-loop transport, the fan-in tier and the soak harness wait for
ROADMAP A13b."""
