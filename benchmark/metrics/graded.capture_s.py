"""graded.capture_s: seconds of CUDA graph capture a graded solve, the
program's own counter (`ops.graded_step.GRAPHS.capture_s`) over the
window, divided by the solves completed in it."""


def read(ctx: dict):
    c = ctx["counters"]
    if "graph_capture_s" not in c or not ctx["requests"]:
        return None
    return c["graph_capture_s"] / ctx["requests"]
