"""Measurement scripts of the port, each run as `python -m
nbody_tpu_torch.scripts.<name>`."""
