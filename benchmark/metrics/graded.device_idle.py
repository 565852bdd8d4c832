"""graded.device_idle: the share of the traced request's window in which no
operation ran on the card, in percent."""

from benchmark.roofline import idle_share


def read(ctx: dict):
    return idle_share(ctx)
