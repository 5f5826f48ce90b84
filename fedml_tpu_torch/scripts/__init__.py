"""The measurement scripts (counterparts of the reference's
``scripts/{convergence,convergence_summarize,bench_lane_conv,
profile_lane_step,bench_lm,bench_gkt,hw_smoke_flash}.py``), each run as
``python -m fedml_tpu_torch.scripts.<name>``: on the card by default,
on the CPU with ``--platform cpu`` (the kernels' plain versions, the
host clock; no device metric). ``bench_flash_bwd`` has no counterpart
and runs on the card only: B3 and B4 of this tree against another
tree's, in turns."""
