"""Measurement scripts for the port, run as ``python -m
mcrt_tpu_torch.tools.<name>``."""
