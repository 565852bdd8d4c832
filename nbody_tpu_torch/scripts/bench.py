"""Headline benchmark: all-pairs force and update throughput on the card.

    python -m nbody_tpu_torch.scripts.bench [--n 65536] [--steps 20]
        [--repeats 3] [--device cuda|cpu]

The port of the root `bench.py`, with its workload: a Plummer sphere
`plummer_scene(n, seed=0)` as a raw float32 state (no rescale), gm = G * m
formed in float64 and rounded to float32, eps = 1e-3, dt = 60, `steps`
symplectic Euler steps; one warm-up run, then `repeats` timed runs from the
same initial state, the best of them reported. The environment variables
BENCH_N, BENCH_STEPS and BENCH_REPEATS set the defaults, as there.

Where the root bench runs the Pallas kernel fused with the update under one
`lax.scan`, a run here is one C call of simulate's float32 step kernel
(`ops/sim_step.sim_chunk_f32`, csrc/sim_step_f32.cu: kernel B2's block
force and the Euler update, Kahan compensation off: at the bench's n one
launch a step and one that forms the first step's inputs, up to 8192
bodies one persistent launch a run). The masses are the gm above with
G = 1 and no oscillating devices, so the kernel's gm is the root bench's
bit for bit. Each timed run is bracketed by `torch.cuda.synchronize()`
and timed on the wall clock.

It runs on the card unless `--device cpu` is given, and raises without
one: it neither falls back to the CPU nor shrinks n, as the root bench
does. On the CPU it runs the step kernel's plain version
(`sim_chunk_f32_ref`) at the n it is given. BENCH_TILE_I and
BENCH_TILE_J size the TPU kernel's VMEM tiles and have no counterpart:
the step kernel picks kernel B2's block shape from n.

Prints one JSON line in the root line's shape: `metric`
(`cuda_allpairs_fp32_n<n>_pairs_per_sec`, `cpu_...` on the CPU), `value`
(pairs/s), `unit` and `vs_baseline` against the same 1e10 pairs/s, and in
`extra` n, steps, the best run's seconds, ms a step, every run's seconds,
the warm-up's, the card as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` prints it, the step kernel's launches
(`sim_chunk_f32.launches`, counted from 0 at the run's start), every
kernel wrapper's launches in the run, and the CUDA graphs' replays and
captures in the run (0: each run is a new carry and one direct C call,
so no timed repeat holds a capture).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.plummer import plummer_scene
from ..ops.chunking import GRAPHS
from ..ops.sim_step import SimCarry, sim_chunk_f32

G, EPS, DT = 6.674e-11, 1e-3, 60.0
# the 1e10 pairs/s single-chip target the root line's vs_baseline divides by
BASELINE_PAIRS_PER_S = 1e10


def card_name() -> str:
    """The cards as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them, one a line ('cpu' without
    nvidia-smi)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "cpu"
    return r.stdout.strip() if r.returncode == 0 else "cpu"


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port, each with its `launches` count."""
    from ..ops import sim_step as ss
    from ..ops.accel_dd import accel_dd
    from ..ops.accel_f32 import accel_f32
    from ..ops.accel_f64 import accel_f64
    from ..ops.accel_mxu import accel_mxu
    from ..ops.graded_step import graded_step_dd, graded_step_f32, \
        graded_step_f64

    return (accel_f64, accel_f32, accel_mxu, accel_dd, graded_step_f64,
            graded_step_f32, graded_step_dd, ss.sim_chunk_f64,
            ss.sim_chunk_f32, ss.sim_chunk_dd, ss.sim_rows_chunk_f64,
            ss.sim_rows_chunk_f32, ss.sim_rows_chunk_dd)


def setup(n: int, steps: int, device: torch.device) -> tuple:
    """The bench's inputs on `device`: (q, v) float32 of plummer_scene(n,
    seed=0), the masses m0 = fl32(G * m) and m_half = 0, the table of
    steps + 1 zeros, and the step kernel's keywords (G = 1, so its gm is
    m0)."""
    q, v, m = plummer_scene(n, seed=0)

    def put(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    m0 = put(G * m)
    kw = {"G": 1.0, "eps": EPS, "dt": DT, "integrator": "euler",
          "compensated": False}
    return (put(q), put(v), m0, torch.zeros_like(m0),
            torch.zeros(steps + 1, dtype=torch.float32, device=device), kw)


def run(q, v, m0, m_half, fst, steps: int, kw: dict) -> SimCarry:
    """`steps` steps from (q, v) through `sim_chunk_f32`: one C call on the
    card, the plain version on the CPU."""
    c = SimCarry(q.clone(), v.clone())
    sim_chunk_f32(c, m0, m_half, fst, 0, steps, **kw)
    return c


def bench(n: int, steps: int, repeats: int, device: str = "cuda") -> tuple:
    """(the JSON record, the last run's final carry) of `repeats` timed runs
    after one warm-up."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    inputs = setup(n, steps, dev)
    launches0 = {k.__name__: k.launches for k in kernel_wrappers()}
    graphs0 = (GRAPHS.replays, GRAPHS.captures)
    t0 = time.perf_counter()
    run(*inputs[:5], steps, inputs[5])
    sync()
    warmup = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        out = run(*inputs[:5], steps, inputs[5])
        sync()
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    if not bool(torch.isfinite(out.q).all()):
        raise FloatingPointError("non-finite positions")
    pairs_per_s = float(n) * n * steps / elapsed
    counts = {k.__name__: k.launches - launches0[k.__name__]
              for k in kernel_wrappers()}
    rec = {
        "metric": f"{dev.type}_allpairs_fp32_n{n}_pairs_per_sec",
        "value": pairs_per_s,
        "unit": "pair-interactions/s",
        "vs_baseline": pairs_per_s / BASELINE_PAIRS_PER_S,
        "extra": {
            "n": n, "steps": steps, "elapsed_s": elapsed,
            "ms_per_step": 1e3 * elapsed / steps, "repeats": repeats,
            "repeat_s": times, "warmup_s": warmup,
            "device": card_name() if dev.type == "cuda" else "cpu",
            "launches": counts["sim_chunk_f32"],
            "launches_by_kernel": counts,
            "graph_replays": GRAPHS.replays - graphs0[0],
            "graph_captures": GRAPHS.captures - graphs0[1],
        },
    }
    return rec, out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.scripts.bench",
        description="All-pairs float32 force and Euler update throughput "
                    "(Plummer sphere) through simulate's float32 step "
                    "kernel; one JSON line")
    p.add_argument("--n", type=int,
                   default=int(os.environ.get("BENCH_N", 65536)),
                   help="bodies (default $BENCH_N or 65536)")
    p.add_argument("--steps", type=int,
                   default=int(os.environ.get("BENCH_STEPS", 20)),
                   help="steps a run (default $BENCH_STEPS or 20)")
    p.add_argument("--repeats", type=int,
                   default=int(os.environ.get("BENCH_REPEATS", 3)),
                   help="timed runs after the warm-up, the best reported "
                        "(default $BENCH_REPEATS or 3)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the step kernel (raises without a card); "
                        "cpu runs its plain PyTorch version")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.n < 1 or args.steps < 1 or args.repeats < 1:
        raise SystemExit("--n, --steps and --repeats must be at least 1")
    rec, _ = bench(args.n, args.steps, args.repeats, args.device)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
