"""Command-line entry point: `python -m nbody_tpu_torch <in> <out>`.

The reference binary's contract (`./hw5 <in> <out>`, hw5.cu:532-535), plus
runtime flags for what the reference fixes at compile time.
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import PRECISIONS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody_tpu_torch",
        description="N-body scenario solver on PyTorch + CUDA "
                    "(NTHU IPC HW5 capabilities)")
    p.add_argument("input", help="testcase .in file")
    p.add_argument("output", help="3-line .out file to write")
    p.add_argument("--n-steps", type=int, default=None,
                   help="override number of steps (default 200000)")
    p.add_argument("--dist3-mode", choices=["dsqrt", "sqrt3", "pow"],
                   default=None,
                   help="how (d^2)^1.5 is formed: dsqrt d2*sqrt(d2) (the "
                        "default on the card), sqrt3 sqrt((d2*d2)*d2), pow "
                        "libm's pow (the default of --precision exact). "
                        "The binary64 precisions take dsqrt and sqrt3, each "
                        "bit-identical to the native core in that mode, and "
                        "refuse pow: neither CUDA's pow nor torch's is "
                        "libm's. f32 and tf3 have one form and ignore it")
    p.add_argument("--precision", choices=PRECISIONS, default="f64",
                   help="f64: native binary64 with the serial force fold, "
                        "bit-identical to the native core in the same "
                        "dist3 mode; e64, dd, ddp, dd+: the same path (on "
                        "the TPU they emulate binary64, which the card "
                        "has); f32: the float32 throughput mode on the "
                        "rescaled scene, not answer-grade; tf3: beyond "
                        "binary64, double-double on the card (the JAX "
                        "package's triple-float32 works around a TPU "
                        "without binary64), answers rounded to binary64; "
                        "exact: the native serial core on the host")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the hand-written kernels (raises without "
                        "a card); cpu runs their plain PyTorch versions")
    p.add_argument("--stats", action="store_true",
                   help="print a JSON run-stats line to stderr")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="save the solver's state at PATH after every chunk "
                        "and resume from it if it exists (Problem 3 keeps "
                        "PATH.p3.npz and PATH.p3progress.json beside it); "
                        "a resumed run's answers are bitwise those of one "
                        "that never stopped")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # after parsing, so `--help` stays instant
    import dataclasses

    import torch

    from .config import SimConfig
    from .device import resolve_device
    from .engine import solve_scene
    from .io import read_input, write_output
    from .ops.accel_dd import accel_dd
    from .ops.accel_f32 import accel_f32
    from .ops.accel_f64 import accel_f64
    from .ops.graded_step import graded_step_dd, graded_step_f32, \
        graded_step_f64
    from .utils.profiling import PhaseTimers, pair_interactions

    cfg = SimConfig()
    if args.n_steps is not None:
        cfg = dataclasses.replace(cfg, n_steps=args.n_steps)
    if args.dist3_mode is not None:
        cfg = dataclasses.replace(cfg, dist3_mode=args.dist3_mode)
    device = None if args.precision == "exact" else resolve_device(args.device)

    timers = PhaseTimers(device)
    kernels = (accel_f64, accel_f32, accel_dd, graded_step_f64,
               graded_step_f32, graded_step_dd)
    launches0 = [k.launches for k in kernels]
    t0 = time.perf_counter()
    with timers.phase("read_input"):
        scene = read_input(args.input)
    ans = solve_scene(scene, cfg, precision=args.precision,
                      device=args.device, timers=timers,
                      checkpoint_path=args.checkpoint)
    with timers.phase("write_output"):
        write_output(args.output, *ans.as_tuple())
    elapsed = time.perf_counter() - t0

    if args.stats:
        n_sims = 2 + (scene.device_cnt if ans.hit_time_step != -2 else 0)
        pairs = pair_interactions(scene.n, cfg.n_steps, n_sims)
        timers.report(stream=sys.stderr, **{
            "n": scene.n, "device_cnt": scene.device_cnt,
            "n_steps": cfg.n_steps, "precision": args.precision,
            "dist3_mode": cfg.resolved_dist3(args.precision),
            "device": (torch.cuda.get_device_name(device)
                       if device is not None and device.type == "cuda"
                       else "cpu"),
            "wall_s": elapsed,
            "pair_interactions": pairs,
            "pairs_per_sec": pairs / elapsed,
            **{f"{k.__name__}_launches": k.launches - k0
               for k, k0 in zip(kernels, launches0)},
            "answers": {"min_dist": ans.min_dist,
                        "hit_time_step": ans.hit_time_step,
                        "gravity_device_id": ans.gravity_device_id,
                        "missile_cost": ans.missile_cost},
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())
