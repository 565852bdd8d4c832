"""A tiny copy of the four-card cell on four gloo ranks of the CPU, run in a
process of its own (the tests of test_bench_mesh.py start it):

    python benchmark/tests/mesh_cell.py <root> <fault> <trace>

builds, under <root>, a checkout's benchmark with the cell `tiny-mesh`
(the four-card cell's configuration and traffic at n = 256, calls of 20
steps in chunks of 10) added by files alone, starts the workers as
`fault` has them (module `FAULTS`) and prints the run's result as one
JSON line (`benchmark/run.py run_cell`, device 'cpu'); with the fault
`control`, the cell's control instead (`control` of its driver), its
numbers by name.

The faults replace a worker's entry (`simulate_mesh_calls.worker_main`)
by one that breaks rank 1 underneath and then runs the real one.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "plummer-n262144-f32-mesh4"
TINY = {"n": 256, "n_steps": 20, "chunk": 10, "timeout_s": 5,
        "setup_timeout_s": 60}
# at this size (seed 2**31 + 12345, the widest of the four blocks) the
# program reads q_gap 1.2e-3 and v_med_gap 1.9e-4, its uncompensated form
# 1.3e-2 and 3.4e-3, the reference in bfloat16 42 and 9.7: each limit
# lies some 3 to 4x from the program and from the uncompensated form
LIMITS = {"q_gap": 4e-3, "v_med_gap": 8e-4}


def tiny_root(root: str) -> str:
    """The benchmark under `root` with the cell `tiny-mesh`."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "workloads",
                           CELL + ".json")) as f:
        cell = json.load(f)
    cell["name"] = "tiny-mesh"
    cell["traffic"].update(TINY, name="t-calls-n256-body4")
    cell["limits"] = LIMITS
    with open(os.path.join(root, "benchmark", "workloads",
                           "tiny-mesh.json"), "w") as f:
        json.dump(cell, f)
    spec["workloads"].append({"name": "tiny-mesh", "config": cell["config"],
                              "traffic": "t-calls-n256-body4", "chips": 4,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-mesh")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def _real():
    return importlib.import_module(
        "benchmark.traffic.simulate_mesh_calls").worker_main


def _on_rank1(rank: int, patch) -> None:
    if rank == 1:
        patch()


def _halve_sources() -> None:
    """The force folds the first half of each source tile and leaves out
    the rest."""
    from nbody_tpu_torch.ops import sim_step

    orig = sim_step.accel_f32_ref

    def half(qi, qj, gm, **kw):
        h = qj.shape[-2] // 2
        return orig(qi, qj[..., :h, :].contiguous(),
                    gm[..., :h].contiguous(), **kw)

    sim_step.accel_f32_ref = half


def _on_second_call(act) -> None:
    """simulate() as it is for the warm call, `act()` at the next."""
    mod = importlib.import_module("nbody_tpu_torch.simulate")
    orig, calls = mod.simulate, []

    def simulate(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            act()
        return orig(*a, **k)

    mod.simulate = simulate


def halved_worker(rank, *args) -> None:
    _on_rank1(rank, _halve_sources)
    _real()(rank, *args)


def exiting_worker(rank, *args) -> None:
    _on_rank1(rank, lambda: _on_second_call(lambda: os._exit(3)))
    _real()(rank, *args)


def stalling_worker(rank, *args) -> None:
    _on_rank1(rank, lambda: _on_second_call(lambda: time.sleep(3600)))
    _real()(rank, *args)


FAULTS = {"none": None, "halved": halved_worker, "exiting": exiting_worker,
          "stalling": stalling_worker}


def main(root: str, fault: str, trace: bool) -> None:
    sys.path.insert(0, ROOT)
    from benchmark import run
    from benchmark.cells import Bench

    bench, seed = Bench(tiny_root(root)), 2 ** 31 + 12345
    if fault == "control":
        cell, config = bench.cell("tiny-mesh")
        r = bench.driver(cell["traffic"]["kind"]).control(cell, config, seed,
                                                           "cpu")
    else:
        if FAULTS[fault] is not None:
            mod = importlib.import_module(
                "benchmark.traffic.simulate_mesh_calls")
            mod.worker_main = FAULTS[fault]
        r = run.run_cell(bench, "tiny-mesh", seed, 1.0, trace, device="cpu")
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3] == "1")
