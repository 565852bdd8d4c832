"""Profiling, rescaling, checkpoints and diagnostics."""
