"""Force kernels (fp64 serial fold, fp32 rsqrt) and integration."""
