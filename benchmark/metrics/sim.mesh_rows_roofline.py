"""sim.mesh_rows_roofline: rank 0's pair work in the traced request (its
rows against every source, each step; `work`) at the card's peak of its
precision (roofline.py), over the summed device time of its kernels less
its NCCL kernels (the operations whose names begin with 'nccl'), in
percent."""

from benchmark.roofline import OPS_PER_PAIR, PEAK_FLOPS


def read(ctx: dict):
    trace, work = ctx.get("trace"), ctx.get("work")
    if not trace or not work:
        return None
    nccl_s = sum(s for name, s in trace["device_ops"]
                 if name.startswith("nccl"))
    rest_s = trace["kernel_s"] - nccl_s
    if rest_s <= 0:
        return None
    least_s = work["pairs"] * OPS_PER_PAIR / PEAK_FLOPS[work["precision"]]
    return 100.0 * least_s / rest_s
