"""graded.kernel_roofline: the traced request's pair work at the card's peak
of its precision (roofline.py) over the summed device time of its kernels,
in percent."""

from benchmark.roofline import kernel_share


def read(ctx: dict):
    return kernel_share(ctx)
