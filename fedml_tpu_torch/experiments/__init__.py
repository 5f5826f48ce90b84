"""Experiment entry points of the port (counterpart of
``fedml_tpu/experiments``)."""
