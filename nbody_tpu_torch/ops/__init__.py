"""Force kernels and integration (fp64 serial-fold path)."""
