"""The roofline's yardstick: the work a problem needs and the card's peaks.

Work is counted from the problem, never from the program's launches or its
machine code, so a kernel that is rewritten is measured against the same
count.

Pairs. The graded solve: Problem 1 over the whole horizon, Problem 2 up to
its hit step, and Problem 3's scenarios in (arrival, body index) order
up to the first that saves the planet, each from its missile's arrival up
to its hit or the horizon: no later device can be cheaper, so the answer
needs no more (the reference works these row-steps out, see
`reference/hw5.py`); n² pairs a row-step. simulate: n² pairs a step of
every call.

Operations a pair: 20 in both precisions, by the force formula
a_i += G m_j (q_j - q_i) / (|q_j - q_i|² + eps²)^1.5 written out as the
spec program evaluates it, a square root and a division counting one each:
3 subtractions (dx, dy, dz); 3 products and 3 sums for d² (eps² added
last); d2 * sqrt(d2), 2; (G m_j) dx / d3 for each axis, 3 products and 3
divisions (G m_j is formed once a source, not a pair); 3 sums into a_i.
GPU Gems 3 ch. 31 charges the same 20 a pair.

Peaks: the published NVIDIA H100 SXM rates outside the tensor cores, at
the card's full 700 W: 67 TFLOP/s in float32, 34 TFLOP/s in float64. A
run states its card's power limit beside them (`device.power_limit`).
"""

from __future__ import annotations

OPS_PER_PAIR = 20
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


def kernel_share(ctx: dict) -> float | None:
    """The traced request's pair work at the peak of its precision, as a
    percentage of the summed device kernel time in its trace; None without
    a trace that holds kernels."""
    trace, work = ctx.get("trace"), ctx.get("work")
    if not trace or not work or trace["kernel_s"] <= 0:
        return None
    least_s = work["pairs"] * OPS_PER_PAIR / PEAK_FLOPS[work["precision"]]
    return 100.0 * least_s / trace["kernel_s"]


def idle_share(ctx: dict) -> float | None:
    """The percentage of the traced window in which no operation ran on
    the device; None without a trace that holds device operations."""
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
