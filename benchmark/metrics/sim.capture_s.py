"""sim.capture_s: the host seconds of a simulate() call's CUDA graph
captures, the program's capture spans (`capture_s`), mean over the
window's untraced calls."""

from benchmark.spans import mean


def read(ctx: dict):
    return mean(ctx, "capture_s")
