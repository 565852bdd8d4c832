"""float32 error against the horizon: plain against Kahan-compensated.

    python -m nbody_tpu_torch.scripts.study_f32_horizon [--case b20]
        [--testcases DIR | --in PATH] [--steps 200000] [--out PATH]
        [--device cuda|cpu]

The port of the root `scripts/study_f32_horizon.py`, the study behind
simulate's `compensated` default. It marches a scene through the port's
`simulate` three times: 'dd' as the truth (native binary64 in the port,
the simulate step kernel csrc/sim_step_f64.cu on the card), 'f32' without
and with Kahan compensation (csrc/sim_step_f32.cu), one step-kernel
launch a step on the card. At a ladder of 20 horizons (every `steps // 20`
steps, where `on_chunk` reads the state back) it takes the relative RMS
position error of each float32 run against the truth.

The scene is `<case>.in` of `--testcases` (default $NBODY_TESTCASES, else
`testcases`) or the file `--in`; the graded testcases are not in the repo,
so a scene comes from `gen_scene` or a seed. Prints a row a horizon and,
last, the record of the root script (case, n, steps, the three runs' wall
seconds, the rows) as one JSON line; `--out` also writes it to a file.
Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

# the runs of the study: name -> (precision, compensated)
RUNS = {"dd": ("dd", None), "f32_plain": ("f32", False),
        "f32_kahan": ("f32", True)}
# horizons in the ladder
LADDER = 20


def march(scene, steps: int, chunk: int, precision: str,
          compensated=None, device: str = "cuda") -> tuple:
    """({step: (q, v)} at every multiple of `chunk` up to `steps`, the run's
    wall seconds, synchronised with the card)."""
    from ..simulate import simulate

    snaps = {}
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate(scene, n_steps=steps, chunk=chunk, precision=precision,
             compensated=compensated, device=device,
             on_chunk=lambda st: snaps.__setitem__(
                 st.step, (st.q.copy(), st.v.copy())))
    if device == "cuda":
        torch.cuda.synchronize()
    return snaps, time.perf_counter() - t0


def rel_rms(a: np.ndarray, b: np.ndarray) -> float:
    """RMS of a - b over the RMS of b."""
    scale = np.sqrt(np.mean(b * b))
    return float(np.sqrt(np.mean((a - b) ** 2)) / scale)


def study(scene, steps: int, device: str = "cuda", case: str = "") -> tuple:
    """(the record, {run: snapshots}) of the three marches of `scene`."""
    chunk = max(1, steps // LADDER)
    snaps, walls = {}, {}
    for name, (precision, compensated) in RUNS.items():
        snaps[name], walls[name] = march(scene, steps, chunk, precision,
                                         compensated, device)
    truth = snaps["dd"]
    rows = [{"steps": h,
             "err_plain": rel_rms(snaps["f32_plain"][h][0], truth[h][0]),
             "err_comp": rel_rms(snaps["f32_kahan"][h][0], truth[h][0])}
            for h in range(chunk, steps + 1, chunk)]
    rec = {"case": case, "n": scene.n, "steps": steps, "wall_s": walls,
           "rows": rows}
    return rec, snaps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.scripts.study_f32_horizon",
        description="float32 position error against binary64 over a ladder "
                    "of horizons, plain and Kahan-compensated")
    p.add_argument("--case", default="b20")
    p.add_argument("--testcases", default=os.environ.get("NBODY_TESTCASES",
                                                         "testcases"),
                   metavar="DIR",
                   help="the directory of <case>.in (default "
                        "$NBODY_TESTCASES, else testcases)")
    p.add_argument("--in", dest="in_path", default=None, metavar="PATH",
                   help="the scene file, in place of --case")
    p.add_argument("--steps", type=int, default=200000)
    p.add_argument("--out", default=None,
                   help="also write the record to this JSON file")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the step kernels (raises without a "
                        "card); cpu runs their plain PyTorch versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be at least 1")
    from ..device import resolve_device
    from ..io import read_input

    resolve_device(args.device)
    path = args.in_path or os.path.join(args.testcases, f"{args.case}.in")
    case = (os.path.splitext(os.path.basename(path))[0] if args.in_path
            else args.case)
    rec, _ = study(read_input(path), args.steps, args.device, case)
    for row in rec["rows"]:
        print(f"{row['steps']:>8d}  plain {row['err_plain']:.3e}   "
              f"kahan {row['err_comp']:.3e}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
