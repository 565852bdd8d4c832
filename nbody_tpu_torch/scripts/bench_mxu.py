"""Gram-form force (kernel B3) against the dq form (kernel B2).

    python -m nbody_tpu_torch.scripts.bench_mxu [--n 65536] [--steps 20]
        [--variants gram:accum,...] [--device cuda|cpu]

The port of the JAX package's `scripts/bench_mxu.py`. On the raw Plummer
scene `plummer_scene(n, seed=0)` in float32, with G = 6.674e-11, eps = 1e-3
and dt = 60 and no rescaling, as there, it measures:

  * one B2 force evaluation, the accuracy anchor, and the pairs/s of
    `steps` symplectic Euler steps on B2;
  * for each gram:accum variant of B3 (each of 'highest' and 'default'):
    err_max/rms and err_rms/rms of one force evaluation against B2's (rms
    of B2's accelerations), the pairs/s of `steps` steps of `step_mxu`,
    and whether the state is still finite after them.

Each timed loop follows one warm-up step and ends in a synchronise. Runs
on the card unless `--device cpu` is given (then at a small n: the plain
versions). Prints a line per measurement and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.plummer import plummer_scene
from ..ops.accel_f32 import accel_f32_self
from ..ops.accel_mxu import PRECISIONS, accel_mxu, step_mxu

G, EPS, DT = 6.674e-11, 1e-3, 60.0
VARIANTS = "default:default,highest:default,default:highest,highest:highest"


def _variants(text: str) -> list:
    out = []
    for var in text.split(","):
        gram, _, accum = var.partition(":")
        if gram not in PRECISIONS or accum not in PRECISIONS:
            raise argparse.ArgumentTypeError(
                f"variant {var!r} is not gram:accum with each of "
                f"{PRECISIONS}")
        out.append((gram, accum))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.scripts.bench_mxu",
        description="Gram-form force kernel B3 against the dq-form kernel "
                    "B2 on a raw Plummer scene")
    p.add_argument("--n", type=int, default=65536, help="bodies")
    p.add_argument("--steps", type=int, default=20,
                   help="timed steps per variant")
    p.add_argument("--variants", type=_variants, default=_variants(VARIANTS),
                   help=f"comma list of gram:accum (default {VARIANTS})")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the kernels (raises without a card); cpu "
                        "runs their plain PyTorch versions")
    return p


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.n < 1 or args.steps < 1:
        raise SystemExit("--n and --steps must be at least 1")
    dev = resolve_device(args.device)
    n, steps = args.n, args.steps
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}  n={n} steps={steps}", flush=True)

    q, v, m = plummer_scene(n, seed=0)
    qf = torch.from_numpy(q.astype(np.float32)).to(dev)
    vf = torch.from_numpy(v.astype(np.float32)).to(dev)
    gm = torch.from_numpy((G * m).astype(np.float32)).to(dev)

    def bench(step):
        step(qf, vf)                                  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        qs, vs = qf, vf
        for _ in range(steps):
            qs, vs = step(qs, vs)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        return (float(n) * n * steps / elapsed, elapsed,
                bool(torch.isfinite(qs).all()))

    def b2_step(qs, vs):
        a = accel_f32_self(qs, gm, eps=EPS)
        vs = vs + a * DT
        return qs + vs * DT, vs

    a_b2 = accel_f32_self(qf, gm, eps=EPS).double()
    rms = float(a_b2.square().mean().sqrt())
    pps, elapsed, _ = bench(b2_step)
    results = {"b2_dq": {"pairs_per_sec": pps, "elapsed_s": elapsed}}
    print(f"b2_dq             {pps:.4g} pairs/s", flush=True)

    for gram, accum in args.variants:
        var = f"{gram}:{accum}"
        d = accel_mxu(qf, gm, eps=EPS, gram=gram, accum=accum).double() - a_b2
        err_max = float(d.abs().max()) / rms
        err_rms = float(d.square().mean().sqrt()) / rms
        print(f"mxu {var:<17s} err max/rms = {err_max:.3g} / {err_rms:.3g}",
              flush=True)
        pps, elapsed, finite = bench(
            lambda qs, vs: step_mxu(qs, vs, gm, eps=EPS, dt=DT, gram=gram,
                                    accum=accum))
        results[f"mxu_{var}"] = {
            "pairs_per_sec": pps, "elapsed_s": elapsed,
            "finite_after_steps": finite, "err_max_over_rms": err_max,
            "err_rms_over_rms": err_rms}
        print(f"mxu {var:<17s} {pps:.4g} pairs/s   finite={finite}",
              flush=True)

    print(json.dumps({"n": n, "steps": steps, "device": name,
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
