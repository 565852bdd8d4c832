"""The port's graded solve over a ('scen', 'body') mesh of gloo ranks
(nbody_tpu_torch/parallel/solver_sharded.py) on the CPU.

Each mesh shape (1x1, 1x2, 2x1, 2x2, 1x4 and 1x3, whose row blocks of
n=20 are uneven) is one group of spawned ranks that runs all of its solves
(tests/torch_mesh_workers.py); every rank must return the same answers.
The scenes: a fuzz scene of n=20 built as tests/test_fuzz_differential.py
builds them (seed 103, three devices: a hit at step 90 that device 2's
destruction prevents) and the 32-body saving scene of the dry run, both
over 300 steps.

Contracts:
  * binary64 ('f64'): answers bitwise the port's one-device CPU solve on
    every shape, and the `.out` byte-equal to `native/oracle ... dsqrt`
    (built here with `make -C native`); against the JAX package's mesh
    f64 (its ring at tile 4, on 4 of the 8 virtual CPU devices): discrete
    answers equal, min distance within 1e-9, the tolerance of
    tests/test_fuzz_differential.py (XLA's ring reassociates);
  * 'f32': bitwise the same on every shape at a pinned tile (4), bitwise
    the one-device 'f32' at tile 128; against JAX's mesh f32: discrete
    answers equal, min distance within 1e-3;
  * 'tf3': bitwise the port's one-device 'tf3' on every shape it runs on;
    against the JAX package's 'tf3': discrete answers equal, min distance
    within 1e-12 (tests/test_torch_tf3_graded.py's tolerance). The JAX
    side is its one-device solve: its mesh 'tf3' solve of this scene
    compiles for about 124 s on this CPU (its 'ddp' 144 s), and its own
    tests/test_solver_sharded_tf3.py:72 holds the mesh's answers equal to
    the one-device ones;
  * checkpoint: stopped on one shape, resumed on another, bitwise the
    uninterrupted run;
  * the drivers' P1+P2 carries (min distance, hit, arrivals, snapshots)
    and Problem-3 flags bitwise the one-device drivers'.
"""

import dataclasses
import os
import subprocess

import numpy as np
import pytest
import torch

from nbody_tpu_torch import SimConfig, solve_scene
from nbody_tpu_torch.graft_entry import saving_scene
from nbody_tpu_torch.io import format_output, write_input
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.parallel.spawn import run_ranks
from nbody_tpu_torch.physics import oscillation_table
import torch_mesh_workers as W

STEPS = 300
TILE = 4                  # the pinned f32 tile of the cross-shape checks
SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (1, 3)]
FUZZ = (103, 20, 3)       # seed, n, devices
# the shapes that also run tf3 and f32 at tile 128 (each costs seconds;
# test_drivers_bitwise_equal_to_one_device runs tf3 on 2x2)
TF3_SHAPES = {(1, 1), (1, 3)}
F32_128_SHAPES = {(1, 1), (1, 2)}
TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes():
    return {"fuzz20": W.fuzz_scene(*FUZZ), "saving32": saving_scene()}


def _jobs(shape, tmp):
    scenes = _scenes()
    jobs = [(f"f64/{name}", s, STEPS, "f64", None, None)
            for name, s in scenes.items()]
    jobs.append(("f32/tile4", scenes["fuzz20"], STEPS, "f32", TILE, None))
    if shape in TF3_SHAPES:
        jobs.append(("tf3/fuzz20", scenes["fuzz20"], STEPS, "tf3", None,
                     None))
    if shape in F32_128_SHAPES:
        jobs.append(("f32/tile128", scenes["fuzz20"], STEPS, "f32", None,
                     None))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape: every rank's answers} of one group of ranks a shape."""
    out = {}
    for shape in SHAPES:
        tmp = str(tmp_path_factory.mktemp("mesh"))
        axes = {"scen": shape[0], "body": shape[1]}
        out[shape] = run_ranks(W.solve_jobs, shape[0] * shape[1],
                               (axes, _jobs(shape, tmp)), workdir=tmp,
                               timeout=TIMEOUT)
    return out


@pytest.fixture(params=SHAPES, ids=[f"{s}x{b}" for s, b in SHAPES])
def mesh_run(request, runs):
    return request.param, runs[request.param]


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device CPU answers of every job."""
    scenes = _scenes()
    cfg = SimConfig(n_steps=STEPS)
    out = {f"f64/{name}": solve_scene(s, cfg, device="cpu").as_tuple()
           for name, s in scenes.items()}
    out["f32/tile128"] = solve_scene(scenes["fuzz20"], cfg, precision="f32",
                                     device="cpu").as_tuple()
    out["tf3/fuzz20"] = solve_scene(scenes["fuzz20"], cfg, precision="tf3",
                                    device="cpu").as_tuple()
    return out


def _bits(ans):
    return tuple(np.float64(x).tobytes() for x in ans)


def test_every_rank_returns_the_same_answers(mesh_run):
    _, ranks = mesh_run
    for r in ranks[1:]:
        assert {k: _bits(v) for k, v in r.items()} == \
            {k: _bits(v) for k, v in ranks[0].items()}


@pytest.mark.parametrize("scene", ["fuzz20", "saving32"])
def test_f64_bitwise_equal_to_one_device(mesh_run, one_device, scene):
    _, ranks = mesh_run
    assert _bits(ranks[0][f"f64/{scene}"]) == \
        _bits(one_device[f"f64/{scene}"])


def test_scenes_exercise_every_problem(one_device):
    """Both scenes hit, and a device saves the planet (Problem 3 runs)."""
    for scene in ("fuzz20", "saving32"):
        md, hit, dev, cost = one_device[f"f64/{scene}"]
        assert hit != -2 and dev != -1 and cost > 0


@pytest.mark.parametrize("scene", ["fuzz20", "saving32"])
def test_f64_out_byte_equal_to_native_oracle(mesh_run, scene, tmp_path):
    from nbody_tpu_torch import native

    oracle = native.build("oracle")
    s = _scenes()[scene]
    path, ref = str(tmp_path / "s.in"), str(tmp_path / "ref.out")
    write_input(path, s)
    subprocess.run([oracle, path, ref, str(STEPS), "dsqrt"], check=True)
    with open(ref) as f:
        want = f.read()
    assert format_output(*mesh_run[1][0][f"f64/{scene}"]) == want


def test_f32_bitwise_the_same_on_every_shape_at_a_pinned_tile(mesh_run,
                                                              runs):
    _, ranks = mesh_run
    assert _bits(ranks[0]["f32/tile4"]) == _bits(runs[(1, 1)][0]["f32/tile4"])


def test_f32_at_tile_128_bitwise_equal_to_one_device(mesh_run, one_device):
    shape, ranks = mesh_run
    if shape not in F32_128_SHAPES:
        assert "f32/tile128" not in ranks[0]
        return
    assert _bits(ranks[0]["f32/tile128"]) == _bits(one_device["f32/tile128"])


def test_tf3_bitwise_equal_to_one_device(mesh_run, one_device):
    shape, ranks = mesh_run
    if shape not in TF3_SHAPES:
        assert "tf3/fuzz20" not in ranks[0]
        return
    assert _bits(ranks[0]["tf3/fuzz20"]) == _bits(one_device["tf3/fuzz20"])


@pytest.fixture(scope="module")
def jax_mesh_answers():
    """The JAX package's mesh solves of the fuzz scene at tile 4 on a 2x2
    mesh of virtual CPU devices, the scene padded only to the mesh
    (NBODY_MESH_MIN_BUCKET=8: the 128 bucket is a TPU signature cache)."""
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.engine import solve_scene as jax_solve
    from nbody_tpu.io import Scene as JaxScene
    from nbody_tpu.parallel import make_mesh

    old = os.environ.get("NBODY_MESH_MIN_BUCKET")
    os.environ["NBODY_MESH_MIN_BUCKET"] = "8"
    try:
        scene = JaxScene(**W.scene_fields(W.fuzz_scene(*FUZZ)))
        cfg = dataclasses.replace(JaxSimConfig(), n_steps=STEPS)
        mesh = make_mesh({"scen": 2, "body": 2})
        return {p: jax_solve(scene, cfg, precision=p, platform="cpu",
                             mesh=mesh, tile=TILE).as_tuple()
                for p in ("f64", "f32")}
    finally:
        if old is None:
            del os.environ["NBODY_MESH_MIN_BUCKET"]
        else:
            os.environ["NBODY_MESH_MIN_BUCKET"] = old


def test_tf3_against_jax_tf3(runs):
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.engine import solve_scene as jax_solve
    from nbody_tpu.io import Scene as JaxScene

    scene = JaxScene(**W.scene_fields(W.fuzz_scene(*FUZZ)))
    cfg = dataclasses.replace(JaxSimConfig(), n_steps=STEPS)
    want = jax_solve(scene, cfg, precision="tf3", platform="cpu").as_tuple()
    for shape in TF3_SHAPES:
        got = runs[shape][0]["tf3/fuzz20"]
        assert got[1:] == want[1:]
        assert got[0] == pytest.approx(want[0], rel=1e-12)


@pytest.mark.parametrize("precision,rtol", [("f64", 1e-9), ("f32", 1e-3)])
def test_against_jax_mesh(mesh_run, jax_mesh_answers, precision, rtol):
    _, ranks = mesh_run
    label = "f64/fuzz20" if precision == "f64" else "f32/tile4"
    got, want = ranks[0][label], jax_mesh_answers[precision]
    assert got[1:] == want[1:]
    assert got[0] == pytest.approx(want[0], rel=rtol)


def test_checkpoint_resumes_on_another_mesh_shape(tmp_path):
    """Stopped at step 150 on 1x2, resumed to 300 on 2x1 (and the f32 run
    at tile 4 likewise): bitwise the uninterrupted runs."""
    s = W.fuzz_scene(*FUZZ)
    half = [(f"{p}", s, STEPS // 2, p, tile, str(tmp_path / f"{p}.ck"))
            for p, tile in (("f64", None), ("f32", TILE))]
    run_ranks(W.solve_jobs, 2, ({"scen": 1, "body": 2}, half),
              workdir=str(tmp_path), timeout=TIMEOUT)
    assert all(os.path.exists(j[5]) for j in half)
    whole = [(lbl, sc, STEPS, p, tile, ck)
             for lbl, sc, _, p, tile, ck in half]
    fresh = [(lbl + "/fresh", sc, STEPS, p, tile, None)
             for lbl, sc, _, p, tile, _ in half]
    got = run_ranks(W.solve_jobs, 2, ({"scen": 2, "body": 1},
                                      whole + fresh),
                    workdir=str(tmp_path), timeout=TIMEOUT)[0]
    for p in ("f64", "f32"):
        assert _bits(got[p]) == _bits(got[p + "/fresh"])
    assert _bits(got["f64"]) == _bits(solve_scene(
        s, SimConfig(n_steps=STEPS), device="cpu").as_tuple())


def test_drivers_bitwise_equal_to_one_device(tmp_path):
    """The mesh drivers' carries on a 2x2 mesh, binary64 and tf3, against
    the one-device drivers: min distance, hit, arrivals, snapshots and the
    Problem-3 flags, bit for bit."""
    s = W.fuzz_scene(*FUZZ)
    cfg = SimConfig(n_steps=STEPS)
    fst = oscillation_table(cfg)
    runs = run_ranks(W.drivers_jobs, 4, ({"scen": 2, "body": 2}, s, STEPS,
                                         ("f64", "tf3")),
                     workdir=str(tmp_path), timeout=TIMEOUT)[0]
    for precision, dtype in (("f64", torch.float64), ("tf3", ds.DD)):
        got = runs[precision]
        one = ds.OneDevice(torch.device("cpu"))
        p12 = ds.run_problems_12(s, fst, cfg, layout=one, dtype=dtype)
        saved = ds.run_problem_3(s, p12, fst, cfg, layout=one, dtype=dtype)
        assert got["min_dist"] == p12.min_dist
        assert got["hit"] == p12.hit_time_step
        elig = (p12.arrivals != -2) & (p12.arrivals <= p12.hit_time_step)
        np.testing.assert_array_equal(got["arrivals"][elig],
                                      p12.arrivals[elig])
        for k in np.nonzero(elig)[0]:
            np.testing.assert_array_equal(got["q_snaps"][k],
                                          p12.q_snaps[k].numpy())
            np.testing.assert_array_equal(got["v_snaps"][k],
                                          p12.v_snaps[k].numpy())
        np.testing.assert_array_equal(got["saved"], saved)
