"""The harness's spans and the reduction of a device trace.

A span (`span(name)`) is a host interval of the harness around a call into
the program: set-up, each request, the traced request. It is a
`torch.profiler.record_function` range named `bench.<name>`, so that in a
trace the host's spans and the device's operations share one clock.

`traced(fn)` runs fn() under torch.profiler (CPU and CUDA activities) and
reduces the trace to what the per-layer readers and the breakdown need,
over the window of fn's own span:

- busy_s: the union of the intervals in which a device operation (kernel,
  copy or fill) ran; kernel_s: the summed time of the kernels alone;
- device_ops: the ten operations with most device time, by name;
- idle_gaps: the intervals of the window in which nothing ran on the
  device, summed by what held the host when each began: the innermost
  harness span and the innermost host operation open at that moment;
  the ten largest.
"""

from __future__ import annotations

import bisect
import contextlib
import warnings

import torch

TOP = 10


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function("bench." + name):
        yield


def _events(prof) -> list:
    """(kind, name, start_ns, end_ns) of every event of a finished
    profile; kind is 'kernel', 'device' (a copy or fill on the card) or
    'host'. Annotation ranges that the profiler mirrors onto the card
    (the `bench.*` spans) are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name, s, t = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() != DeviceType.CUDA:
            out.append(("host", name, s, t))
        elif not (name.startswith("bench.")
                  or getattr(e, "is_user_annotation", lambda: False)()):
            out.append(("device" if name.startswith(("Memcpy", "Memset"))
                        else "kernel", name, s, t))
    return out


def traced(fn, name: str = "traced") -> dict:
    """fn() inside span(name) under the profiler, and its trace's
    reduction (module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=acts) as prof:
            with span(name):
                fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return reduce(_events(prof), "bench." + name)


def reduce(events: list, window: str) -> dict:
    """The reduction of `events` (as `_events` gives them) over the span
    named `window`."""
    w0, w1 = next((s, t) for k, n, s, t in events
                  if k == "host" and n == window)
    dev = sorted((max(s, w0), min(t, w1), k, n) for k, n, s, t in events
                 if k != "host" and t > w0 and s < w1)
    by_name: dict = {}
    kernel_ns = 0
    busy = []                       # the union, as disjoint intervals
    for s, t, k, n in dev:
        by_name[n] = by_name.get(n, 0) + (t - s)
        if k == "kernel":
            kernel_ns += t - s
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    gaps, cur = [], w0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if cur < w1:
        gaps.append((cur, w1))
    host = sorted((s, t, n) for k, n, s, t in events
                  if k == "host" and t > w0 and s < w1)
    idle = _name_gaps(gaps, host)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(t - s for s, t in busy) * 1e-9,
        "kernel_s": kernel_ns * 1e-9,
        "device_ops": [[n, ns * 1e-9] for n, ns in top],
        "idle_gaps": [[n, ns * 1e-9] for n, ns in
                      sorted(idle.items(), key=lambda x: -x[1])[:TOP]],
    }


def _name_gaps(gaps: list, host: list) -> dict:
    """Idle nanoseconds by 'harness span / host operation' open at each
    gap's start: a sweep over the host intervals sorted by start."""
    out: dict = {}
    starts = [s for s, _, _ in host]
    open_: list = []                # (-start, end, name) of open ones
    i = 0
    for g0, g1 in gaps:
        j = bisect.bisect_right(starts, g0)
        for s, t, n in host[i:j]:
            open_.append((-s, t, n))
        i = j
        open_ = [x for x in open_ if x[1] > g0]
        live = sorted(open_)        # innermost (latest start) first
        harness = next((n for _, _, n in live if n.startswith("bench.")),
                       "bench")
        inner = next((n for _, _, n in live), "")
        key = harness if inner in ("", harness) else f"{harness} / {inner}"
        out[key] = out.get(key, 0) + (g1 - g0)
    return out
