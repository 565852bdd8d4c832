"""The port's graded solve on the CPU against the native core and JAX.

`solve_scene(device='cpu')` runs the scenario solvers of nbody_tpu_torch
with the plain twin of kernel B1. Its four answers must be bit-equal to the
native serial core in dsqrt mode (the port's fold IS the serial fold), and
within test_fuzz_differential's 1e-9 of the JAX f64 engine, whose XLA j-sum
order differs from the serial fold by ulps. The fused one-pass solver, the
phased solvers at any chunk length, and Problem 3's batched and sequential
strategies must all agree bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu.engine import solve_scene as jax_solve_scene
from nbody_tpu.native import solve_exact
from nbody_tpu_torch import Scene, SimConfig, solve_scene
from nbody_tpu_torch.engine import select_winner
from nbody_tpu_torch.models.direct_sum import (run_problem_3, run_problems_12,
                                               run_problems_123)
from nbody_tpu_torch.physics import oscillation_table
from test_fuzz_differential import N_STEPS, _fuzz_scene

CPU = torch.device("cpu")
CFG = SimConfig(n_steps=N_STEPS, dist3_mode="dsqrt")
JCFG = dataclasses.replace(JaxSimConfig(), n_steps=N_STEPS, dist3_mode="dsqrt")
# the fuzz corpus's seeds that hit within the horizon (79 and 91 are also
# saved by a device), plus misses
HIT_SEEDS = [5, 7, 35, 50, 57, 62, 64, 69, 70, 73, 79, 91]
SEEDS = [0, 1, 2, 3, 4, 6, 8, 9] + HIT_SEEDS


@pytest.fixture(autouse=True, scope="module")
def _native_built():
    """Build the native core under the port's lock before the JAX
    package's binding (which builds unlocked) looks for it."""
    from nbody_tpu_torch.native import build
    build("libnbody_core.so")


def _port(scene) -> Scene:
    return Scene(**{f.name: getattr(scene, f.name)
                    for f in dataclasses.fields(scene)})


def _bits(x):
    return np.float64(x).view(np.uint64)


def _key(ans):
    md, hs, dev, cost = ans
    return _bits(md), hs, dev, _bits(cost)


def _grown(seed: int, n: int):
    """A fuzz scene with light far-off stars appended up to n bodies: the
    phased solvers' sizes (n > 128 for P1+P2, n >= 256 for the sequential
    Problem 3) at a short horizon."""
    s = _fuzz_scene(seed)
    rng = np.random.RandomState(1000 + seed)
    k = n - s.n
    q = np.concatenate([s.q, rng.randn(k, 3) * 1e12])
    v = np.concatenate([s.v, rng.randn(k, 3) * 1e2])
    m = np.concatenate([s.m, np.abs(rng.randn(k)) * 1e18])
    return Scene(n=n, planet=s.planet, asteroid=s.asteroid, q=q, v=v, m=m,
                 types=list(s.types) + ["star"] * k, device_idx=s.device_idx)


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_bit_equal_to_native_and_close_to_jax(seed):
    scene = _fuzz_scene(seed)
    want = solve_exact(scene, JCFG, dist3_mode="dsqrt")
    got = solve_scene(_port(scene), CFG, device="cpu")
    assert _key(got.as_tuple()) == _key(want)

    jax = jax_solve_scene(scene, JCFG, precision="f64", platform="cpu")
    assert got.hit_time_step == jax.hit_time_step
    assert got.gravity_device_id == jax.gravity_device_id
    assert got.min_dist == pytest.approx(jax.min_dist, rel=1e-9)
    assert got.missile_cost == pytest.approx(jax.missile_cost, rel=1e-9)


def test_seeds_cover_every_outcome():
    outs = [solve_exact(_fuzz_scene(s), JCFG, dist3_mode="dsqrt")
            for s in SEEDS]
    assert any(hs == -2 for _, hs, _, _ in outs)
    assert any(hs != -2 and dev == -1 for _, hs, dev, _ in outs)
    assert any(dev != -1 for _, _, dev, _ in outs)


@pytest.mark.parametrize("seed", [5, 64, 79, 91])
def test_fused_phased_and_p3_strategies_bit_equal(seed):
    """Fused vs phased, P3 batched vs sequential, and the phased solvers
    with a chunk shorter than the horizon (the P2 early exit and the P3
    skip-ahead and early exit act at chunk boundaries)."""
    scene = _port(_fuzz_scene(seed))
    fst = oscillation_table(CFG)
    fused = run_problems_123(scene, fst, CFG, device=CPU)
    keys = {_key((fused.min_dist, fused.hit_time_step,
                  *select_winner(scene, fused.arrivals, fused.saved, CFG)))}
    for cfg in (CFG, dataclasses.replace(CFG, chunk_steps=16)):
        p12 = run_problems_12(scene, fst, cfg, device=CPU)
        assert p12.hit_time_step == fused.hit_time_step
        for strategy in ("batched", "sequential"):
            saved = run_problem_3(scene, p12, fst, cfg, device=CPU,
                                  strategy=strategy)
            keys.add(_key((p12.min_dist, p12.hit_time_step,
                           *select_winner(scene, p12.arrivals, saved, cfg))))
    assert len(keys) == 1


@pytest.mark.parametrize("seed,n,n_steps", [(79, 140, 120), (91, 256, 110)])
def test_phased_sizes_bit_equal_to_native(seed, n, n_steps):
    scene = _grown(seed, n)
    cfg = dataclasses.replace(CFG, n_steps=n_steps, chunk_steps=40)
    want = solve_exact(scene, dataclasses.replace(JCFG, n_steps=n_steps),
                       dist3_mode="dsqrt")
    assert want[1] != -2
    got = solve_scene(scene, cfg, device="cpu")
    assert _key(got.as_tuple()) == _key(want)


def test_hit_at_step_zero():
    s = _fuzz_scene(5)
    q = s.q.copy()
    q[s.asteroid] = q[s.planet] + 1e6          # inside the planet radius
    scene = Scene(n=s.n, planet=s.planet, asteroid=s.asteroid, q=q, v=s.v,
                  m=s.m, types=s.types, device_idx=s.device_idx)
    want = solve_exact(scene, JCFG, dist3_mode="dsqrt")
    assert want[1] == 0
    cfg = dataclasses.replace(CFG, n_steps=30)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(scene, fst, cfg, device=CPU)
    assert p12.hit_time_step == 0 and (p12.arrivals == -2).all()
    got = solve_scene(scene, cfg, device="cpu")
    assert _key(got.as_tuple()) == _key(
        solve_exact(scene, dataclasses.replace(JCFG, n_steps=30),
                    dist3_mode="dsqrt"))


@pytest.mark.parametrize("seed", [5, 79])
def test_scene_without_devices(seed):
    """No devices: the phased solvers (the fused one needs devices) with
    empty arrival and snapshot tensors."""
    s = _fuzz_scene(seed)
    scene = Scene(n=s.n, planet=s.planet, asteroid=s.asteroid, q=s.q, v=s.v,
                  m=s.m, types=["star"] * s.n,
                  device_idx=np.zeros((0,), np.int64))
    got = solve_scene(scene, CFG, device="cpu")
    assert _key(got.as_tuple()) == _key(
        solve_exact(scene, JCFG, dist3_mode="dsqrt"))


@pytest.mark.parametrize("seed", [0, 79])
def test_tf3_answers_as_binary64_does_here(seed):
    """'tf3' (double-double, beyond binary64) answers; on these scenes its
    discrete answers are binary64's and its min distance within 1e-9
    (tests/test_torch_tf3.py holds it to JAX 'tf3')."""
    scene = _port(_fuzz_scene(seed))
    got = solve_scene(scene, CFG, precision="tf3", device="cpu")
    want = solve_scene(scene, CFG, device="cpu")
    assert got.as_tuple()[1:] == want.as_tuple()[1:]
    assert got.min_dist == pytest.approx(want.min_dist, rel=1e-9)


def test_bad_precision_dist3_and_strategy_raise():
    scene = _port(_fuzz_scene(0))
    with pytest.raises(ValueError, match="unknown precision"):
        solve_scene(scene, CFG, precision="f16", device="cpu")
    with pytest.raises(ValueError, match="dsqrt"):
        solve_scene(scene, dataclasses.replace(CFG, dist3_mode="pow"),
                    device="cpu")
    p12 = run_problems_12(_port(_fuzz_scene(79)), oscillation_table(CFG),
                          CFG, device=CPU)
    with pytest.raises(ValueError, match="strategy"):
        run_problem_3(_port(_fuzz_scene(79)), p12, oscillation_table(CFG),
                      CFG, device=CPU, strategy="greedy")


def test_e64_is_the_f64_path():
    scene = _port(_fuzz_scene(79))
    assert _key(solve_scene(scene, CFG, precision="e64",
                            device="cpu").as_tuple()) == \
        _key(solve_scene(scene, CFG, device="cpu").as_tuple())


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_scene(_port(_fuzz_scene(0)), CFG, device="cuda")

