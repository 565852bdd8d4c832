"""Where a graded solve's time goes on the card.

    python -m nbody_tpu_torch.scripts.profile_cli -- <CLI args>

Runs `python -m nbody_tpu_torch <CLI args>` once to warm up (kernel build,
allocator), then once more under `torch.profiler` with CPU and CUDA
activities, and prints one JSON object: the profiled wall, the device time
summed over the device's own events (kernels and copies, not the host ops
that launched them), the device's busy share of the wall, the count of
device events, and the TOP device events by total time. The profiler adds
host time to every launch, so the busy share it reports is a lower bound
for the run without it; take per-step times from the CLI's own `--stats`
run. It is the source of the device busy shares and per-kernel device
times of the graded solve in PERF.md section 5.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import time

TOP = 8   # device events listed, by total device time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.scripts.profile_cli",
        description="profile one CLI solve on the card")
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="arguments of python -m nbody_tpu_torch, after --")
    args = p.parse_args(argv)
    cli_args = args.cli_args[1:] if args.cli_args[:1] == ["--"] \
        else args.cli_args

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..cli import main as cli_main

    def run():
        with contextlib.redirect_stderr(io.StringIO()):
            if cli_main(cli_args) != 0:
                raise SystemExit("the CLI run failed")

    if not torch.cuda.is_available():
        raise SystemExit("profile_cli needs a CUDA card")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise SystemExit("the profile holds no device event")
    device_us = sum(e.self_device_time_total for e in ops)
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(json.dumps({
        "cli_args": cli_args, "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "device_s": device_us * 1e-6,
        "device_busy_share": device_us * 1e-6 / wall,
        "device_events": sum(e.count for e in ops),
        "top": [{"name": e.key, "count": e.count,
                 "device_ms": e.self_device_time_total * 1e-3}
                for e in ops[:TOP]]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
