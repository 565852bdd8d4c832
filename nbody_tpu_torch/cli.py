"""Command-line entry point: `python -m nbody_tpu_torch <in> <out>`.

The reference binary's contract (`./hw5 <in> <out>`, hw5.cu:532-535), plus
runtime flags for what the reference fixes at compile time. With `--mesh`
the solve runs over a mesh of ranks: alone as one rank, or under torchrun,

    torchrun --nproc-per-node 4 -m nbody_tpu_torch in out \
        --mesh scen=2,body=2 --device cpu

and rank 0 alone writes the `.out` and the `--stats` line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    p.add_argument("--mesh", default=None, metavar="scen=S,body=B",
                   help="solve over a ('scen','body') mesh of "
                        "torch.distributed ranks, one device each (NCCL on "
                        "cuda, gloo on cpu): the multi-device analog of the "
                        "reference's 2-GPU distribution (hw5.cu:532-615). "
                        "S*B must be the number of ranks (1 when run "
                        "alone; torchrun --nproc-per-node K); one size may "
                        "be -1 (inferred). Binary64 and tf3 answers are "
                        "bitwise the one-device ones. Example: --mesh "
                        "scen=2,body=-1")
    p.add_argument("--tile", type=int, default=None,
                   help="the f32 mesh's force tile in bodies: the force "
                        "sums one partial per group of this many sources, "
                        "in ascending order (default 128, the fp32 "
                        "kernel's tile, where the answers are bitwise the "
                        "one-device f32 ones); one tile gives bitwise the "
                        "same answers on every mesh shape. Any positive "
                        "count: nothing is padded. Binary64 and tf3 ignore "
                        "it. Needs --mesh")
    return p


def check_mesh_args(args, world: int) -> dict | None:
    """The mesh's {axis: size} of parsed CLI args, after the refusals
    (SystemExit): --mesh with 'exact', a --tile below 1 or without
    --mesh, and a mesh of another size than the `world` ranks."""
    if args.tile is not None and args.tile < 1:
        raise SystemExit(f"--tile must be a positive row count, got "
                         f"{args.tile}")
    if args.mesh is None:
        if args.tile is not None:
            raise SystemExit("--tile sets the mesh's f32 force tile; give "
                             "--mesh too")
        return None
    if args.precision == "exact":
        raise SystemExit("--mesh does not apply to the native serial core "
                         "(precision 'exact')")
    from .parallel.mesh import mesh_sizes, parse_mesh_spec
    try:
        axes = parse_mesh_spec(args.mesh)
        mesh_sizes(axes, world)
    except ValueError as e:
        raise SystemExit(str(e))
    return axes


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # after parsing, so `--help` stays instant
    import dataclasses

    import torch.distributed as dist

    from .config import SimConfig
    from .device import resolve_device

    cfg = SimConfig()
    if args.n_steps is not None:
        cfg = dataclasses.replace(cfg, n_steps=args.n_steps)
    if args.dist3_mode is not None:
        cfg = dataclasses.replace(cfg, dist3_mode=args.dist3_mode)
    mesh = None
    if args.mesh is not None or args.tile is not None:
        from .parallel import mesh as pm
        world = dist.get_world_size() if dist.is_initialized() else \
            int(os.environ.get("WORLD_SIZE", "1"))
        axes = check_mesh_args(args, world)
        opened = not dist.is_initialized()
        mesh = pm.make_mesh(axes, device=args.device)
        device = pm.mesh_device(mesh)
        try:
            return _solve(args, cfg, device, mesh)
        finally:
            if opened:
                pm.close()
    device = None if args.precision == "exact" else resolve_device(args.device)
    return _solve(args, cfg, device, None)


def _solve(args, cfg, device, mesh) -> int:
    """Read, solve and write (rank 0 alone on a mesh): one request of the
    span recorder (utils/profiling), whose record `--stats` prints."""
    import torch
    import torch.distributed as dist

    from .engine import solve_scene
    from .io import read_input, write_output
    from .ops.accel_dd import accel_dd
    from .ops.accel_f32 import accel_f32
    from .ops.accel_f64 import accel_f64
    from .ops.chunking import GRAPHS
    from .ops.graded_step import graded_step_dd, graded_step_f32, \
        graded_step_f64
    from .ops.sim_step import sim_chunk_dd, sim_chunk_f32, sim_chunk_f64, \
        sim_rows_chunk_dd, sim_rows_chunk_f32, sim_rows_chunk_f64
    from .utils import profiling

    kernels = (accel_f64, accel_f32, accel_dd, graded_step_f64,
               graded_step_f32, graded_step_dd, sim_chunk_f64, sim_chunk_f32,
               sim_chunk_dd, sim_rows_chunk_f64, sim_rows_chunk_f32,
               sim_rows_chunk_dd)
    launches0 = [k.launches for k in kernels]
    pdl0 = graded_step_f64.pdl_launches
    graphs0 = (GRAPHS.replays, GRAPHS.captures, GRAPHS.capture_s)
    rank0 = mesh is None or dist.get_rank() == 0
    with profiling.entry("solve") as req:
        with profiling.span("read_input"):
            scene = read_input(args.input)
        ans = solve_scene(scene, cfg, precision=args.precision,
                          device=args.device,
                          checkpoint_path=args.checkpoint, mesh=mesh,
                          tile=args.tile)
        if rank0:
            with profiling.span("write_output"):
                write_output(args.output, *ans.as_tuple())

    if args.stats and rank0:
        mesh_stats = {} if mesh is None else {
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "tile": args.tile}
        rec = req.record
        # the pairs the drivers computed: n² a row-step of this process
        pairs = scene.n * scene.n * sum(rec["row_steps"].values())
        print(json.dumps({
            "n": scene.n, "device_cnt": scene.device_cnt,
            "n_steps": cfg.n_steps, "precision": args.precision,
            **mesh_stats,
            "dist3_mode": cfg.resolved_dist3(args.precision),
            "device": (torch.cuda.get_device_name(device)
                       if device is not None and device.type == "cuda"
                       else "cpu"),
            **rec,
            "pairs": pairs, "pairs_per_sec": pairs / rec["wall_s"],
            **{f"{k.__name__}_launches": k.launches - k0
               for k, k0 in zip(kernels, launches0)},
            # of them, B1''s step launches made as programmatic dependents
            # of the step before (csrc/graded.cuh graded_chunk)
            "graded_step_f64_pdl_launches":
                graded_step_f64.pdl_launches - pdl0,
            # the graded chunks' CUDA graphs: a replay a chunk, a capture
            # a chunk shape (ops/graded_step.ChunkGraphs)
            "graph_replays": GRAPHS.replays - graphs0[0],
            "graph_captures": GRAPHS.captures - graphs0[1],
            "graph_capture_s": GRAPHS.capture_s - graphs0[2],
            "answers": {"min_dist": ans.min_dist,
                        "hit_time_step": ans.hit_time_step,
                        "gravity_device_id": ans.gravity_device_id,
                        "missile_cost": ans.missile_cost},
        }), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
