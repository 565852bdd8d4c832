"""Profiling helpers."""
