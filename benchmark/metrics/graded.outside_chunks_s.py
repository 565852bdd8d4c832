"""graded.outside_chunks_s: a graded solve's host seconds before its first
chunk starts on the card and after its last one ends (the program's
`outside_s`: the entry's wall less the chunks' span: the `.in`, the
oscillation table, the carries, the final reads, the `.out`), mean over
the window's untraced solves."""

from benchmark.spans import mean


def read(ctx: dict):
    return mean(ctx, "outside_s")
