"""graded.in_chunk_idle_s: the card's idle while a graded chunk was in
flight: the chunks' summed seconds on the card's clock a solve (the
program's `chunk_s`, mean over the window's untraced solves) less the
summed kernel time of the traced solve."""

from benchmark.spans import mean


def read(ctx: dict):
    chunk_s, trace = mean(ctx, "chunk_s"), ctx.get("trace")
    if chunk_s is None or not trace:
        return None
    return chunk_s - trace["kernel_s"]
