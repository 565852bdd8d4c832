"""graded.rowstep_yield: the row-steps a graded solve's answers need (the
reference's, `work["pairs"]` over n²) over the row-steps its drivers ran
(the program's `row_steps`, summed over its drivers, mean over the
window's solves), in percent."""

from benchmark.spans import window


def read(ctx: dict):
    recs, work = window(ctx), ctx.get("work")
    if recs is None or not work:
        return None
    n = ctx["cell"]["traffic"]["template"]["n"]
    ran = sum(sum(x["row_steps"].values()) for x in recs) / len(recs)
    return 100.0 * work["pairs"] / (n * n) / ran if ran else None
