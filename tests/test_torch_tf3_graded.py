"""The graded solve at precision 'tf3' against the JAX package's 'tf3'.

The port runs double-double binary64 on the raw scene; the JAX package
triple-float32 on the rescaled one. Both go beyond binary64, so the
discrete answers (hit step, saving device, its cost) must be equal, and
the min distances, each rounded to binary64 at the end, within
MIN_DIST_RTOL = 1e-12 (they were bit-equal on these scenes; the JAX
triple's 2^-70 an op leaves the last of binary64's 52 bits uncertain).
The fused driver runs at n=16 in both packages; the phased drivers run at
n=16 too, in JAX through its own switch (NBODY_P123=0), in the port by
calling them: the JAX package's tf3 phased solve at n=140 takes some 150 s
of XLA:CPU time, so the n >= 129 phased runs are held against the port's
f64 and the native core instead (tests/test_torch_tf3.py).
"""

import dataclasses

import pytest
import torch

from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu.engine import solve_scene as jax_solve_scene
from nbody_tpu_torch import Scene, SimConfig, solve_scene
from nbody_tpu_torch.engine import select_winner
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.physics import oscillation_table
from test_fuzz_differential import _fuzz_scene

STEPS = 240
MIN_DIST_RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(s) -> Scene:
    return Scene(**{f.name: getattr(s, f.name) for f in dataclasses.fields(s)})


def _agree(got: tuple, want):
    assert got[1:] == (want.hit_time_step, want.gravity_device_id,
                       want.missile_cost)
    assert got[0] == pytest.approx(want.min_dist, rel=MIN_DIST_RTOL)


@pytest.mark.parametrize("seed", [79, 5])
def test_fused_tf3_agrees_with_jax_tf3(seed):
    """79 hits at step 73 and device 3 saves it; 5 hits at 148 unsaved."""
    want = jax_solve_scene(_fuzz_scene(seed), dataclasses.replace(
        JaxSimConfig(), n_steps=STEPS), precision="tf3", platform="cpu")
    got = solve_scene(_port(_fuzz_scene(seed)), SimConfig(n_steps=STEPS),
                      precision="tf3", device="cpu")
    assert got.hit_time_step != -2
    _agree(got.as_tuple(), want)


def test_phased_tf3_agrees_with_jax_tf3(monkeypatch):
    """Seed 91: a hit at step 101 saved by device 2, through Problems 1+2
    with the early exit (16-step chunks) and a batched Problem 3."""
    monkeypatch.setenv("NBODY_P123", "0")
    want = jax_solve_scene(_fuzz_scene(91), dataclasses.replace(
        JaxSimConfig(), n_steps=STEPS), precision="tf3", platform="cpu")
    scene = _port(_fuzz_scene(91))
    cfg = SimConfig(n_steps=STEPS, chunk_steps=16)
    fst = oscillation_table(cfg)
    p12 = ds.run_problems_12(scene, fst, cfg, device=torch.device("cpu"),
                             dtype=ds.DD)
    saved = ds.run_problem_3(scene, p12, fst, cfg,
                             device=torch.device("cpu"), dtype=ds.DD)
    assert p12.q_snaps.shape == (scene.device_cnt, scene.n, 3, 2)
    _agree((p12.min_dist, p12.hit_time_step,
            *select_winner(scene, p12.arrivals, saved, cfg)), want)
    assert want.gravity_device_id != -1
