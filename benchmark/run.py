"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. It refuses (exit 2, no result) where the card
or cards the cell asks for are not there: it never falls back to the CPU.

A run: set-up (import, CUDA, the program's kernel library, the cell's
inputs from the seed, one warm request of the cell's own shapes), then the
window: whole requests until `--seconds` have passed, the window ending
with the last. With `--trace 1` one more request runs under the profiler.
Then the device's memory peak is read, the program's state is let go, the
modules loaded are checked (no `jax`, `jaxlib`, `flax` or `nbody_tpu`;
exit 3, no result), and the reference checks every answer the run
produced (`correct`). The last line of standard output is the result:
`--trace 0` gives the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (each from its reader, `metrics/<name>.py`), the
device's busy and window seconds and the trace's breakdown. Each number
compared stands beside its limit in the result's last key, `checks`, and
in the last lines of standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")


class ForbiddenModules(RuntimeError):
    """Modules of JAX or of the JAX package were loaded in this process."""


def forbidden_modules(names) -> list:
    """The module names whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `nbody_tpu_torch` is not `nbody_tpu`."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                description="run one benchmark cell once")
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True,
                   help="draws the cell's inputs")
    p.add_argument("--seconds", type=float, required=True,
                   help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: the per-layer metrics, from a traced request")
    return p


def power_limit() -> str:
    """The first card's name and power limit as nvidia-smi prints them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
        else "not read"


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of a cell (the module docstring); the result as a dict, its
    keys in the order printed. `device` 'cpu' drives the program's plain
    versions, for the tests alone."""
    import torch

    from benchmark import trace as tr

    cell, config = bench.cell(name)
    driver = bench.driver(cell["traffic"]["kind"])
    with tr.span("setup"):
        traffic = driver.Traffic(cell, config, seed, device)
        traffic.request("warm")
    setup_s = time.perf_counter() - T0

    before = traffic.counters()
    attempted = failed = 0
    ends = []
    w0 = time.perf_counter()
    while True:
        attempted += 1
        try:
            with tr.span("request"):
                traffic.request(f"w{attempted}")
        except Exception as e:          # the run goes on; the answer is lost
            failed += 1
            print(f"request {attempted} failed: {e!r}", file=sys.stderr)
        ends.append(time.perf_counter())
        if ends[-1] - w0 >= seconds:
            break
    window_s = ends[-1] - w0
    after = traffic.counters()
    summary = None
    t1 = time.perf_counter()
    if trace:
        summary = tr.traced(lambda: traffic.request("traced"))
    on_card = device == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.empty_cache()

    found = forbidden_modules(sys.modules)
    if found:
        raise ForbiddenModules(", ".join(found))

    t2 = time.perf_counter()
    numbers, work = traffic.check()
    print(f"seconds: setup {setup_s:.3f} window {window_s:.3f} traced "
          f"{t2 - t1:.3f} reference {time.perf_counter() - t2:.3f}; "
          "requests " + " ".join(f"{b - a:.4f}" for a, b in
                                 zip([w0] + ends, ends)), file=sys.stderr)
    limits = cell["limits"]
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits)
    # a gap with no number (an answer that never came) prints as 'inf'
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                  else str(numbers[k]), "limit": limits[k]} for k in limits}

    completed = attempted - failed
    metrics = {}
    if not trace:
        values = traffic.end_to_end(window_s, completed) if completed \
            else {}
        values["setup_s"] = setup_s
        for m in bench.end_to_end(name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = {"cell": cell, "config": config, "requests": completed,
               "window_s": window_s, "work": work, "trace": summary,
               "counters": {k: after[k] - before[k] for k in after}}
        for m in bench.per_layer(name):
            value = bench.reader(m["name"]).read(ctx) if completed else None
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak,
           "power_limit": power_limit() if on_card else "none"}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from benchmark.cells import Bench

    bench = Bench()
    cell, _ = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except ForbiddenModules as e:
        print(f"modules of jax or the JAX package were loaded: {e}",
              file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
