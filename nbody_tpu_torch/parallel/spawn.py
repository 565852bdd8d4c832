"""Run a function in a group of gloo ranks on the CPU, one process each.

    results = run_ranks(fn, 4, args, workdir=tmp, timeout=120)

Each rank is a process started with the 'spawn' method. It opens the
default process group (gloo, through a `file://` store in `workdir`: no
TCP port, so groups started side by side cannot collide), sets torch to
one thread, calls fn(*args) and hands back its return value, which must
pickle. The mesh's CPU tests and `graft_entry.dryrun_multichip` start
their ranks so; `fn` lives in a module that imports no JAX, so the ranks
start light.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import torch.multiprocessing as mp


def _rank_main(fn, rank: int, world: int, store: str, out: str,
               args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=world)
        result = (True, fn(*args))
    except Exception:     # handed to the parent, which raises it
        result = (False, traceback.format_exc())
    try:
        with open(out, "wb") as f:
            pickle.dump(result, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), *,
              workdir: str | None = None, timeout: float = 120.0) -> list:
    """fn(*args) in `world` gloo ranks; their return values in rank order.
    Raises RuntimeError with the traceback of a rank that failed, and
    TimeoutError (the ranks killed) if they are not done in `timeout`
    seconds."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="nbody_ranks_")
    store = os.path.join(workdir, f"store_{os.getpid()}_{time.time_ns()}")
    outs = [f"{store}.rank{r}" for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            raise TimeoutError(f"{world} ranks of {fn.__name__} outlasted "
                               f"{timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r, out in enumerate(outs):
        if not os.path.exists(out):
            raise RuntimeError(f"rank {r} of {fn.__name__} left no result "
                               f"(exit code {procs[r].exitcode})")
        with open(out, "rb") as f:
            ok, value = pickle.load(f)
        if not ok:
            raise RuntimeError(f"rank {r} of {fn.__name__} failed:\n{value}")
        results.append(value)
    if own:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return results
