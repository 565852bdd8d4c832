"""The program's records of the window's requests, for the readers of the
metrics whose source is a span or a counter of the program.

`nbody_tpu_torch.utils.profiling.RECORDS` keeps one record a request of
the program (a CLI solve, a `simulate()` call), appended when the request
returns. A run makes one warm request, then the window's R =
`ctx["requests"]`, then with `--trace 1` the traced one, so the window's
records are the last R + 1 less the final one: untraced requests. A
program without the recorder, or one that kept fewer than R + 2 records,
gives None, and the metric is left out.
"""

from __future__ import annotations


def window(ctx: dict) -> list | None:
    """The records of the window's requests, or None."""
    try:
        from nbody_tpu_torch.utils.profiling import RECORDS
    except ImportError:
        return None
    recs, r = list(RECORDS), ctx["requests"]
    if r < 1 or len(recs) < r + 2:
        return None
    return recs[-r - 1:-1]


def mean(ctx: dict, key: str) -> float | None:
    """The mean of a record's number over the window's requests."""
    recs = window(ctx)
    if recs is None or any(key not in x for x in recs):
        return None
    return sum(x[key] for x in recs) / len(recs)
