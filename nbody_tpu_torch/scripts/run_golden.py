"""Golden harness: solve testcases and compare with their golden `.out`.

    python -m nbody_tpu_torch.scripts.run_golden --precision f64 \\
        [--testcases DIR] [--cases b20,b30,...] [--n-steps N]
        [--dist3-mode dsqrt|sqrt3|pow] [--mesh scen=S,body=B] [--tile T]
        [--device cuda|cpu] [--out results.json]

The port of the root `scripts/run_golden.py`: for each case `<case>.in`
of DIR it runs the port's `solve_scene` and compares the answers with
`<case>.out`:

  min_dist  relative error against the golden (byte equality implies 0)
  hit_step  exact integer match
  p3 line   device id exact, cost relative error

One JSON record a case (the root script's keys), then a `SUMMARY` line;
`--out` also writes both to a file. `wall_s` is the solve's wall clock,
synchronised with the card before and after: the graded wall.

`--precision` takes every flag of the port's CLI (`config.PRECISIONS`),
`--dist3-mode` the CLI's forms, and `--mesh`/`--tile` solve over a
('scen', 'body') mesh of ranks, alone or under torchrun (rank 0 prints).
`--n-steps` overrides the horizon (default 200000), to read goldens made
at another one. The graded testcases are not in the repo; a corpus is
made with `gen_scene` and `native/oracle <in> <out> <steps> dsqrt`.
DIR defaults to $NBODY_TESTCASES, else `testcases`. A case without its
`.in` or `.out` is an error, never a skip. Runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from ..config import PRECISIONS

ALL_CASES = ["b20", "b30", "b40", "b50", "b60", "b70", "b80", "b90",
             "b100", "b200", "b512", "b1024"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.scripts.run_golden",
        description="Solve testcases and compare with their golden .out")
    p.add_argument("--precision", default="f64", choices=PRECISIONS)
    p.add_argument("--cases", default=",".join(ALL_CASES))
    p.add_argument("--testcases", default=os.environ.get("NBODY_TESTCASES",
                                                         "testcases"),
                   metavar="DIR",
                   help="the directory of <case>.in and <case>.out "
                        "(default $NBODY_TESTCASES, else testcases)")
    p.add_argument("--n-steps", type=int, default=None,
                   help="the horizon the goldens were made at (default "
                        "200000)")
    p.add_argument("--out", default=None)
    p.add_argument("--dist3-mode", default=None,
                   choices=["pow", "dsqrt", "sqrt3"])
    p.add_argument("--mesh", default=None, metavar="scen=S,body=B",
                   help="solve over a mesh of torch.distributed ranks (the "
                        "CLI's --mesh)")
    p.add_argument("--tile", type=int, default=None,
                   help="the f32 mesh's force tile (the CLI's --tile)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the kernels (raises without a card); cpu "
                        "runs their plain PyTorch versions")
    return p


def case_paths(testcases: str, cases: list) -> list:
    """(case, .in path, .out path) of each case; raises FileNotFoundError
    naming every missing file."""
    paths = [(case, os.path.join(testcases, f"{case}.in"),
              os.path.join(testcases, f"{case}.out")) for case in cases]
    missing = [p for _, i, o in paths for p in (i, o)
               if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(f"run_golden: missing testcase files: "
                                f"{missing}")
    return paths


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.n_steps is not None and args.n_steps < 1:
        raise SystemExit("--n-steps must be at least 1")
    cases = case_paths(args.testcases, args.cases.split(","))

    import torch
    import torch.distributed as dist

    from ..config import SimConfig
    from ..device import resolve_device
    from ..engine import solve_scene
    from ..io import format_output, parse_output, read_input

    cfg = SimConfig()
    if args.n_steps is not None:
        cfg = dataclasses.replace(cfg, n_steps=args.n_steps)
    if args.dist3_mode:
        cfg = dataclasses.replace(cfg, dist3_mode=args.dist3_mode)

    mesh, opened = None, False
    if args.mesh is not None:
        from ..parallel import mesh as pm
        opened = not dist.is_initialized()
        mesh = pm.make_mesh(pm.parse_mesh_spec(args.mesh), device=args.device)
        device = pm.mesh_device(mesh)
    elif args.precision == "exact":       # the native core, on the host
        device = torch.device("cpu")
    else:
        device = resolve_device(args.device)
    rank0 = mesh is None or dist.get_rank() == 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = []
    try:
        for case, in_path, gold_path in cases:
            scene = read_input(in_path)
            with open(gold_path) as f:
                gold_text = f.read()
            g_min, g_hit, g_dev, g_cost = parse_output(gold_text)

            sync()
            t0 = time.perf_counter()
            ans = solve_scene(scene, cfg, precision=args.precision,
                              device=args.device, mesh=mesh, tile=args.tile)
            sync()
            wall = time.perf_counter() - t0

            ours = format_output(*ans.as_tuple())
            rel_min = abs(ans.min_dist - g_min) / max(abs(g_min), 1e-300)
            rel_cost = abs(ans.missile_cost - g_cost) / max(abs(g_cost), 1.0)
            rec = {
                "case": case, "n": scene.n, "precision": args.precision,
                "dist3_mode": cfg.resolved_dist3(args.precision),
                **({"mesh": args.mesh, "tile": args.tile}
                   if args.mesh is not None else {}),
                "wall_s": wall,
                "byte_equal": ours == gold_text,
                "min_dist_rel_err": rel_min,
                "hit_step_ours": ans.hit_time_step, "hit_step_gold": g_hit,
                "hit_step_match": ans.hit_time_step == g_hit,
                "p3_dev_ours": ans.gravity_device_id, "p3_dev_gold": g_dev,
                "p3_dev_match": ans.gravity_device_id == g_dev,
                "p3_cost_rel_err": rel_cost,
            }
            results.append(rec)
            if rank0:
                print(json.dumps(rec), flush=True)
    finally:
        if opened:
            pm.close()

    summary = {
        "precision": args.precision, "cases": len(results),
        **({"mesh": args.mesh, "tile": args.tile}
           if args.mesh is not None else {}),
        "byte_equal": sum(r["byte_equal"] for r in results),
        "hit_step_match": sum(r["hit_step_match"] for r in results),
        "p3_dev_match": sum(r["p3_dev_match"] for r in results),
        "max_min_dist_rel_err": max(r["min_dist_rel_err"] for r in results),
    }
    if rank0:
        print("SUMMARY " + json.dumps(summary), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"results": results, "summary": summary}, f,
                          indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
