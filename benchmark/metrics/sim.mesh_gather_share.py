"""sim.mesh_gather_share: the device time of the traced request's NCCL
kernels (the operations whose names begin with 'nccl': the mesh's
all_gathers, each with its wait for the slowest card) over the summed
device time of its kernels, on rank 0, in percent."""


def read(ctx: dict):
    trace = ctx.get("trace")
    if not trace or trace["kernel_s"] <= 0:
        return None
    nccl_s = sum(s for name, s in trace["device_ops"]
                 if name.startswith("nccl"))
    return 100.0 * nccl_s / trace["kernel_s"]
