"""Ring benchmark: the body-sharded float32 step over a ring of ranks.

    torchrun --standalone --nproc-per-node 4 \\
        -m nbody_tpu_torch.scripts.bench_sharded [--bodies 1048576] \\
        [--steps 3]
    python -m nbody_tpu_torch.scripts.bench_sharded          # one rank
    python -m nbody_tpu_torch.scripts.bench_sharded --device cpu

The port of the root `scripts/bench_sharded.py`. Under torchrun every rank
is a process with one card (NCCL; gloo with `--device cpu`); alone it is a
group of one rank (`parallel/mesh.init_process_group`). The mesh is
`make_mesh({"body": world})`, and each rank holds its equal block of
`plummer_scene(n, seed=0)` in float32 (n rounded down to a multiple of the
world size; default 8192 a rank). It times `steps` calls of
`parallel/sharded.make_sharded_step`: each one the force of kernel B2's
cross form over the ring (every rank's block of sources comes round by
`ring_shift`, `batch_isend_irecv` to the next rank; at world size 1 there
is no send), then v += a*dt, q += v*dt. One warm-up step, then the best of
3 repeats from the initial state, each ending in a device-to-host copy of
the positions.

The root script's `--pallas` picks the TPU's block kernel over XLA's; the
port's block is always kernel B2's cross form, so it has no such flag.

Rank 0 prints one JSON line: `metric`
(`sharded_ring_cuda_fp32_n<n>_dev<world>_pairs_per_sec`, `..._cpu_...` on
gloo), `value` (pairs/s), `unit`, and in `extra` n, the world size, steps,
the best repeat's seconds, every repeat's, the platform, the backend
(`nccl` or `gloo`), the host's cards as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` prints them, and rank
0's launches of kernel B2 in the run (world size x (steps x 3 + 1)).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.plummer import plummer_scene
from ..ops.accel_f32 import accel_f32
from ..parallel import mesh as pm
from ..parallel.sharded import body_split, make_sharded_step
from .bench import card_name

G, EPS, DT = 6.674e-11, 1e-3, 60.0
REPEATS = 3
# bodies a rank by default
N_PER_RANK = 8192


def run(mesh, n: int, steps: int, repeats: int = REPEATS) -> tuple:
    """(the JSON record, this rank's final q and v) of one warm-up step and
    `repeats` timed runs of `steps` ring steps from this rank's block of
    plummer_scene(n, seed=0) in float32; every rank of the mesh calls it.
    n must be a multiple of the mesh's body axis."""
    dev = pm.mesh_device(mesh)
    world = mesh.size(pm.AXES.index("body"))
    r0, r1 = body_split(mesh, n)
    q, v, m = plummer_scene(n, seed=0)
    qf, vf, mf = (torch.from_numpy(np.asarray(x[r0:r1], np.float32)).to(dev)
                  for x in (q, v, m))
    step = make_sharded_step(mesh, G=G, eps=EPS, dt=DT)
    launches0 = accel_f32.launches

    q1, v1 = step(qf, vf, mf)                     # warm-up
    q1.cpu()
    times = []
    for _ in range(repeats):
        qr, vr = qf, vf
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            qr, vr = step(qr, vr, mf)
        qr.cpu()                                   # a device-to-host copy
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    if not bool(torch.isfinite(qr).all()):
        raise FloatingPointError("non-finite positions")
    platform = "gpu" if dev.type == "cuda" else "cpu"
    rec = {
        "metric": f"sharded_ring_{dev.type}_fp32_n{n}_dev{world}"
                  f"_pairs_per_sec",
        "value": float(n) * n * steps / elapsed,
        "unit": "pair-interactions/s",
        "extra": {"n": n, "devices": world, "steps": steps,
                  "elapsed_s": elapsed, "repeat_s": times,
                  "platform": platform, "backend": dist.get_backend(),
                  "device": card_name() if platform == "gpu" else "cpu",
                  "launches": accel_f32.launches - launches0},
    }
    return rec, qr, vr


def rank_run(n: int, steps: int, repeats: int = 1) -> tuple:
    """`run` on a mesh {"body": world} of the CPU ranks of an open gloo
    group (parallel/spawn.run_ranks): (record, this rank's rows (r0, r1),
    its final q and v as numpy)."""
    mesh = pm.make_mesh({"body": dist.get_world_size()}, device="cpu")
    rec, q, v = run(mesh, n, steps, repeats)
    return rec, body_split(mesh, n), q.numpy(), v.numpy()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.scripts.bench_sharded",
        description="The body-sharded float32 ring step (kernel B2's cross "
                    "form, sources passed round the ring) on a mesh of "
                    "every rank; rank 0 prints one JSON line")
    p.add_argument("--n", "--bodies", dest="n", type=int, default=None,
                   help=f"bodies in all (default {N_PER_RANK} a rank), "
                        "rounded down to a multiple of the world size; "
                        "under torchrun write --bodies, since torchrun "
                        "reads --n as an abbreviation of its own options")
    p.add_argument("--steps", type=int, default=3, help="steps a repeat")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: one card a rank, NCCL (raises without a "
                        "card); cpu: gloo ranks and the plain PyTorch "
                        "version of kernel B2")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    opened = not dist.is_initialized()
    pm.init_process_group(args.device)
    try:
        world = dist.get_world_size()
        n = args.n or N_PER_RANK * world
        n -= n % world
        if n < world or args.steps < 1:
            raise SystemExit(f"--n must be at least the world size {world} "
                             f"and --steps at least 1")
        mesh = pm.make_mesh({"body": world}, device=args.device)
        rec, _, _ = run(mesh, n, args.steps)
        if dist.get_rank() == 0:
            print(json.dumps(rec), flush=True)
    finally:
        if opened:
            pm.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
