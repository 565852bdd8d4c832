"""graded.chunk_gaps_s: the card's idle between consecutive chunks of a
graded solve, a chunk's start less the previous chunk's end on the card's
clock, summed (the program's `gaps_s`: host reads, slicing, the base-step
word, captures of a new shape, the hand-over from P1+P2 to P3), mean
over the window's untraced solves."""

from benchmark.spans import mean


def read(ctx: dict):
    return mean(ctx, "gaps_s")
