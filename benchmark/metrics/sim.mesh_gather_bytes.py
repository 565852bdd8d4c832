"""sim.mesh_gather_bytes: the bytes of the all_gathers' gathered outputs
a step, the program's counter (`gather_bytes` of a request's record) over
the window's untraced calls, mean, divided by a call's steps."""

from benchmark.spans import mean


def read(ctx: dict):
    total = mean(ctx, "gather_bytes")
    if total is None:
        return None
    return total / ctx["cell"]["traffic"]["n_steps"]
