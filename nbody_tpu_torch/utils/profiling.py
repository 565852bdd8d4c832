"""Phase timers, a device trace and the pair-interaction work count."""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch


class PhaseTimers:
    """Named wall-clock phase timers. On a CUDA device each phase ends with
    `torch.cuda.synchronize()`, so a phase's time includes the device work
    it enqueued and not only the host's enqueueing."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self.phases: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self, stream=sys.stderr, **extra) -> dict:
        rec = {"phases_s": dict(self.phases), **extra}
        print(json.dumps(rec), file=stream, flush=True)
        return rec


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """A torch.profiler trace of the block (the CPU, and the card where
    there is one) written into `logdir` for TensorBoard or Perfetto (a
    `*.pt.trace.json`); does nothing if logdir is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def pair_interactions(n: int, n_steps: int, n_sims: int) -> int:
    """Pair interactions of n_sims full simulations (step 0 evaluates no
    force). An upper bound where early exits shorten runs."""
    return n * n * n_steps * n_sims
