"""The four-card cell's driver (`traffic/simulate_mesh_calls.py`) and split
reference (`reference/plummer_cards.py`) on the CPU.

The driver runs end to end on four gloo ranks at a tiny size, each run in
a process of its own (mesh_cell.py): `correct` is true; it is false when
rank 1's force leaves out half of every source tile; a worker that exits,
or stalls, at the window's first request makes that request fail within
the cell's timeout, and the run ends with a result; the cell's control
fails its limits where the program passes them. The split reference
agrees with the one-card reference, and the cell and its configuration
load by name."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mesh_cell
from benchmark.cells import Bench
from benchmark.reference import plummer, plummer_cards, scenes

ROOT = mesh_cell.ROOT
sm = importlib.import_module("benchmark.traffic.simulate_mesh_calls")
HERE = os.path.dirname(os.path.abspath(__file__))


def _run(tmp_path, fault: str, trace: bool = False,
         limit: float = 240.0) -> tuple:
    """(the result, the seconds of the window's requests) of the tiny cell
    with `fault`."""
    p = subprocess.run([sys.executable, os.path.join(HERE, "mesh_cell.py"),
                        str(tmp_path), fault, str(int(trace))],
                       capture_output=True, text=True, timeout=limit,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    times = next((line for line in p.stderr.splitlines()
                  if line.startswith("seconds: ")), "requests ")
    return json.loads(p.stdout.strip().splitlines()[-1]), \
        [float(x) for x in times.split("requests ")[1].split()]


@pytest.mark.parametrize("trace", [False, True])
def test_run_on_four_gloo_ranks(tmp_path, trace):
    r, _ = _run(tmp_path, "none", trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["count"] == 4
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    if trace:
        # the plain path gathers each step's forces: 4 blocks of 64 rows
        assert r["metrics"]["sim.mesh_gather_bytes"]["value"] == \
            4 * 64 * 3 * 4
        assert r["metrics"]["sim.capture_s"]["value"] == 0.0
    else:
        assert set(r["metrics"]) == {"sim_pairs_per_s", "setup_s"}


def test_a_broken_rank_is_not_correct(tmp_path):
    r, _ = _run(tmp_path, "halved")
    assert r["failed"] == 0 and r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("fault", ["exiting", "stalling"])
def test_a_lost_worker_fails_its_request(tmp_path, fault):
    """The window's first request fails (rank 1 exits or sleeps at its
    second call) within the request's timeout and the guard's grace, and
    so does every later one (the mesh is down); the run ends with a
    result."""
    r, seconds = _run(tmp_path, fault)
    assert r["attempted"] == r["failed"] >= 1 and r["correct"] is False
    assert seconds[0] < mesh_cell.TINY["timeout_s"] + sm.GRACE_S
    if fault == "stalling":
        assert seconds[0] >= mesh_cell.TINY["timeout_s"]


def test_control_fails_and_the_program_passes(tmp_path):
    """The control at the tiny cell's size: the reference in bfloat16 and
    the uncompensated program each fail a limit of the cell; the program
    as the cell runs it, on the same seed, passes them."""
    r, _ = _run(tmp_path, "control")
    limits = mesh_cell.LIMITS
    for name in ("bf16", "program_uncompensated"):
        assert any(r[name][k] > limits[k] for k in limits), name
    assert all(r["program"][k] <= limits[k] for k in limits)


def test_split_reference_is_the_one_card_reference():
    q, v, m = scenes.plummer_scene(300, seed=2 ** 31 + 7)
    kw = {"n_steps": 5, "G": 6.674e-11, "eps": 1e-3, "dt": 60.0}
    want = plummer.march(q, v, m, device="cpu", **kw)
    got = plummer_cards.march(q, v, m, devices=["cpu"] * 4, **kw)
    for a, b, x0 in zip(got, want, (q, v)):
        scale = np.abs(b - x0).max()
        assert np.abs(a - b).max() <= 1e-12 * scale
    # the state handed in is left as it was
    assert (q == scenes.plummer_scene(300, seed=2 ** 31 + 7)[0]).all()


def test_cell_and_configuration_load_by_name():
    cell, config = Bench(ROOT).cell("plummer-n262144-f32-mesh4")
    assert config["name"] == "plummer-f32-body4" and config["chips"] == 4
    assert cell["traffic"]["kind"] == "simulate_mesh_calls"
    assert cell["traffic"]["mesh"] == config["mesh"] == {"scen": 1,
                                                         "body": 4}
    assert (cell["traffic"]["n"], cell["traffic"]["n_steps"],
            cell["traffic"]["chunk"]) == (262144, 500, 100)
