"""The port's graded solve at the precisions beyond f64/e64/exact.

'f32' (float32 on the power-of-2-rescaled scene, kernel B2 over the
scenario batch) against the JAX package's `solve_scene(precision='f32',
platform='cpu')`, whose force is XLA's `pairwise_accel_fast`: the two sum
in other orders, so they agree to float32 rounding amplified by the
dynamics, not bit for bit. Over 300 steps of the fuzz corpus's 20 seeds
their min distances differed by at most 4.5e-4 (relative), and every
discrete answer was equal; JAX_RTOL = 1e-3 holds them. Against the port's
own binary64 path the f32 min distance moved by at most 2.8e-3 on the same
seeds, with discrete answers equal; F64_RTOL = 1e-2 is the JAX package's
own f32 bound (tests/test_semantics_corners.py:151), the loosest accepted.

'dd', 'ddp' and 'dd+' emulate binary64 on the TPU; on the card they are the
f64 path, so their answers equal f64's bit for bit, and agree with JAX 'dd'
on the CPU at tests/test_fuzz_differential.py's tolerance.
"""

import dataclasses

import numpy as np
import pytest

from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu.engine import solve_scene as jax_solve_scene
from nbody_tpu_torch import Scene, SimConfig, solve_scene
from test_fuzz_differential import _fuzz_scene

STEPS = 300
CFG = SimConfig(n_steps=STEPS)
JCFG = dataclasses.replace(JaxSimConfig(), n_steps=STEPS)
JAX_RTOL = 1e-3
F64_RTOL = 1e-2
SEEDS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 35, 50, 57, 62, 64, 69, 70, 73, 79,
         91]


def _port(scene) -> Scene:
    return Scene(**{f.name: getattr(scene, f.name)
                    for f in dataclasses.fields(scene)})


def _grown(seed: int, n: int) -> Scene:
    """A fuzz scene with light far-off stars appended up to n bodies: the
    phased solvers' sizes (n > 128; n >= 256 runs Problem 3 one row at a
    time)."""
    s = _fuzz_scene(seed)
    rng = np.random.RandomState(1000 + seed)
    k = n - s.n
    return Scene(n=n, planet=s.planet, asteroid=s.asteroid,
                 q=np.concatenate([s.q, rng.randn(k, 3) * 1e12]),
                 v=np.concatenate([s.v, rng.randn(k, 3) * 1e2]),
                 m=np.concatenate([s.m, np.abs(rng.randn(k)) * 1e18]),
                 types=list(s.types) + ["star"] * k,
                 device_idx=s.device_idx)


def _no_devices(seed: int) -> Scene:
    s = _fuzz_scene(seed)
    return Scene(n=s.n, planet=s.planet, asteroid=s.asteroid, q=s.q, v=s.v,
                 m=s.m, types=["star"] * s.n,
                 device_idx=np.zeros((0,), np.int64))


def _agree(got, want, rtol):
    assert got.hit_time_step == want.hit_time_step
    assert got.gravity_device_id == want.gravity_device_id
    assert got.missile_cost == want.missile_cost
    assert got.min_dist == pytest.approx(want.min_dist, rel=rtol)


@pytest.mark.parametrize("seed", SEEDS)
def test_f32_close_to_jax_f32_and_to_f64(seed):
    """The fused solver (n = 16 with devices) on every fuzz seed."""
    scene = _port(_fuzz_scene(seed))
    got = solve_scene(scene, CFG, precision="f32", device="cpu")
    _agree(got, jax_solve_scene(_fuzz_scene(seed), JCFG, precision="f32",
                                platform="cpu"), JAX_RTOL)
    _agree(got, solve_scene(scene, CFG, device="cpu"), F64_RTOL)


@pytest.mark.parametrize("seed,n,n_steps", [(79, 140, 120), (91, 256, 110),
                                            (5, 200, 200)])
def test_f32_phased_sizes_close_to_jax_f32(seed, n, n_steps):
    scene = _grown(seed, n)
    got = solve_scene(scene, dataclasses.replace(CFG, n_steps=n_steps),
                      precision="f32", device="cpu")
    assert got.hit_time_step != -2
    jcfg = dataclasses.replace(JCFG, n_steps=n_steps)
    _agree(got, jax_solve_scene(scene, jcfg, precision="f32",
                                platform="cpu"), JAX_RTOL)
    _agree(got, solve_scene(scene, dataclasses.replace(CFG, n_steps=n_steps),
                            device="cpu"), F64_RTOL)


@pytest.mark.parametrize("seed", [5, 79, 0])
def test_f32_scene_without_devices(seed):
    scene = _no_devices(seed)
    got = solve_scene(scene, CFG, precision="f32", device="cpu")
    assert (got.gravity_device_id, got.missile_cost) == (-1, 0.0)
    _agree(got, jax_solve_scene(scene, JCFG, precision="f32",
                                platform="cpu"), JAX_RTOL)


@pytest.mark.parametrize("scene_of", [lambda: _port(_fuzz_scene(79)),
                                      lambda: _port(_fuzz_scene(5)),
                                      lambda: _grown(91, 256),
                                      lambda: _no_devices(50)],
                         ids=["fused_saved", "fused_hit", "phased_seq_p3",
                              "no_devices"])
def test_f32_answers_do_not_depend_on_chunk_steps(scene_of):
    scene = scene_of()
    keys = set()
    for cs in (2000, 64, 7):
        a = solve_scene(scene, dataclasses.replace(CFG, chunk_steps=cs),
                        precision="f32", device="cpu")
        keys.add((np.float64(a.min_dist).tobytes(), a.hit_time_step,
                  a.gravity_device_id, a.missile_cost))
    assert len(keys) == 1, (scene.n, keys)


@pytest.mark.parametrize("scene_of", [lambda: _port(_fuzz_scene(0)),
                                      lambda: _no_devices(0),
                                      lambda: _grown(0, 140)],
                         ids=["fused", "phased", "phased_grown"])
def test_f32_overflow_raises(scene_of):
    """A star fast enough to leave float32's range within the horizon: the
    once-per-chunk check raises instead of returning NaN answers."""
    scene = scene_of()
    v = scene.v.copy()
    v[5] = 1e40
    scene = dataclasses.replace(scene, v=v)
    with pytest.raises(FloatingPointError, match="non-finite"):
        solve_scene(scene, dataclasses.replace(CFG, chunk_steps=50),
                    precision="f32", device="cpu")
    assert np.isfinite(solve_scene(scene, CFG, device="cpu").min_dist)


@pytest.mark.parametrize("precision", ["dd", "ddp", "dd+", "e64"])
@pytest.mark.parametrize("seed", [79, 5])
def test_f64_aliases_are_the_f64_path(precision, seed):
    scene = _port(_fuzz_scene(seed))
    got = solve_scene(scene, CFG, precision=precision, device="cpu")
    want = solve_scene(scene, CFG, device="cpu")
    assert np.float64(got.min_dist).tobytes() == \
        np.float64(want.min_dist).tobytes()
    assert got.as_tuple()[1:] == want.as_tuple()[1:]


@pytest.mark.parametrize("seed", [0, 5, 79, 91])
def test_dd_agrees_with_jax_dd(seed):
    got = solve_scene(_port(_fuzz_scene(seed)), CFG, precision="dd",
                      device="cpu")
    _agree(got, jax_solve_scene(_fuzz_scene(seed), JCFG, precision="dd",
                                platform="cpu"), 1e-9)


def test_f32_accepts_any_dist3_mode_and_f64_does_not():
    """The f32 force is the rsqrt form whatever dist3_mode says, as in the
    JAX package; the binary64 path implements only dsqrt."""
    scene = _port(_fuzz_scene(5))
    cfg = dataclasses.replace(CFG, dist3_mode="pow")
    assert solve_scene(scene, cfg, precision="f32", device="cpu") == \
        solve_scene(scene, CFG, precision="f32", device="cpu")
    for precision in ("dd", "ddp"):
        with pytest.raises(ValueError, match="dsqrt"):
            solve_scene(scene, cfg, precision=precision, device="cpu")
