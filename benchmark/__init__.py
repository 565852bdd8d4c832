"""The benchmark of `nbody_tpu_torch` on the card (README.md)."""
