"""sim.seed_s: the seconds of a simulate() call's leapfrog seed (the force
at the initial positions, one launch of the force kernel before the first
chunk), the program's `seed` spans on the card's clock (`seed_s` of a
request's record), mean over the window's untraced calls. A program
without the span gives None."""

from benchmark.spans import mean


def read(ctx: dict):
    return mean(ctx, "seed_s")
