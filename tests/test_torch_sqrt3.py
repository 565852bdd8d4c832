"""The binary64 paths' second form of d2^1.5, 'sqrt3' = sqrt((d2*d2)*d2),
and the refusal of 'pow'.

Every op of 'sqrt3' is correctly rounded, so the port's plain chunks (and
the kernels on a card) must be bit-equal to the native serial core in its
sqrt3 mode (native/core.cc:57-61), as 'dsqrt' is in its own. `simulate`
in f64 'sqrt3' is held against the JAX package's f64 'sqrt3' (XLA's sum
order) at rtol 1e-12, the tolerance of the dsqrt comparison in
tests/test_torch_simulate.py. 'pow' is libm's pow, which neither CUDA nor
torch reproduces: the binary64 paths refuse it and say why; 'exact' (the
native core) takes all three.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import io as jio
from nbody_tpu.native import solve_exact
from nbody_tpu.simulate import simulate as jax_simulate
from nbody_tpu_torch import Scene, SimConfig, simulate, solve_scene
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.io import write_input
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.ops.accel_f64 import accel_f64, accel_f64_ref
from nbody_tpu_torch.physics import oscillation_table
from test_fuzz_differential import _fuzz_scene

STEPS = 240


@pytest.fixture(autouse=True, scope="module")
def _native_built():
    from nbody_tpu_torch.native import build
    build("libnbody_core.so")


def _port(s) -> Scene:
    return Scene(**{f.name: getattr(s, f.name) for f in dataclasses.fields(s)})


def _grown(seed: int, n: int) -> Scene:
    s = _fuzz_scene(seed)
    rng = np.random.RandomState(1000 + seed)
    k = n - s.n
    return Scene(n=n, planet=s.planet, asteroid=s.asteroid,
                 q=np.concatenate([s.q, rng.randn(k, 3) * 1e12]),
                 v=np.concatenate([s.v, rng.randn(k, 3) * 1e2]),
                 m=np.concatenate([s.m, np.abs(rng.randn(k)) * 1e18]),
                 types=list(s.types) + ["star"] * k, device_idx=s.device_idx)


def _bits(ans):
    md, hs, dev, cost = ans
    return np.float64(md).tobytes(), hs, dev, np.float64(cost).tobytes()


def _native(scene, n_steps, mode="sqrt3"):
    cfg = dataclasses.replace(JaxSimConfig(), n_steps=n_steps,
                              dist3_mode=mode)
    return solve_exact(scene, cfg, dist3_mode=mode)


def test_plain_force_is_the_serial_sqrt3_form():
    """The twin of kernel B1 in 'sqrt3' against a host loop of Python
    floats, math.sqrt((d2*d2)*d2), folded over ascending j."""
    rng = np.random.RandomState(0)
    q = rng.randn(1, 9, 3) * 1e10
    gm = np.abs(rng.randn(1, 9)) * 1e13
    got = accel_f64_ref(torch.from_numpy(q), torch.from_numpy(gm), eps=1e-3,
                        dist3_mode="sqrt3")[0].numpy()
    for i in range(9):
        acc = [0.0, 0.0, 0.0]
        for j in range(9):
            d = [q[0, j, c] - q[0, i, c] for c in range(3)]
            d2 = ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) + 1e-3 * 1e-3
            d3 = math.sqrt((d2 * d2) * d2)
            acc = [acc[c] + (gm[0, j] * d[c]) / d3 for c in range(3)]
        assert got[i].tolist() == acc
    dsqrt = accel_f64_ref(torch.from_numpy(q), torch.from_numpy(gm),
                          eps=1e-3)[0].numpy()
    assert not np.array_equal(got, dsqrt)     # the forms differ in ulps


@pytest.mark.parametrize("chunk", [7, 2000])
@pytest.mark.parametrize("seed", [5, 79, 91, 0])
def test_fused_bit_equal_to_native_sqrt3(seed, chunk):
    scene = _port(_fuzz_scene(seed))
    cfg = SimConfig(n_steps=STEPS, chunk_steps=chunk, dist3_mode="sqrt3")
    assert _bits(solve_scene(scene, cfg, device="cpu").as_tuple()) == \
        _bits(_native(scene, STEPS))


@pytest.mark.parametrize("seed,n,n_steps", [(79, 140, 120), (91, 256, 110)])
def test_phased_bit_equal_to_native_sqrt3(seed, n, n_steps):
    """P1+P2 with the early exit, then Problem 3 batched (n=140) and
    sequential (n=256)."""
    scene = _grown(seed, n)
    want = _native(scene, n_steps)
    assert want[1] != -2
    cfg = SimConfig(n_steps=n_steps, chunk_steps=40, dist3_mode="sqrt3")
    assert _bits(solve_scene(scene, cfg, device="cpu").as_tuple()) == \
        _bits(want)


@pytest.mark.parametrize("mode", [gs.P12, gs.P3, gs.P123])
def test_plain_chunks_follow_the_carry_form(mode):
    """The carry's dist3 reaches the force: the same chunk in the two forms
    ends in different velocities. (The bodies start at rest, so the forms'
    differences of an ulp in the force are not lost in v += a*dt; the
    positions, 1e9 m and more, absorb them.)"""
    scene = dataclasses.replace(_port(_fuzz_scene(5)),
                                v=np.zeros((16, 3)))
    states = []
    for form in ("dsqrt", "sqrt3"):
        cfg = SimConfig(n_steps=60, dist3_mode=form)
        fst = oscillation_table(cfg)
        if mode == gs.P12:
            c = ds._p12_carry(scene, fst, cfg, "cpu", torch.float64)
        elif mode == gs.P123:
            c = ds._p123_carry(scene, fst, cfg, "cpu", torch.float64)
        else:
            q = torch.from_numpy(np.stack([scene.q] * 2))
            p12 = ds.P12Result(min_dist=0.0, hit_time_step=50,
                               arrivals=np.asarray([3, 20]), q_snaps=q,
                               v_snaps=torch.from_numpy(
                                   np.stack([scene.v] * 2)))
            c = ds._p3_carry(scene, p12, fst, cfg, np.arange(2), "cpu",
                             torch.float64)
        assert c.dist3 == form
        gs.graded_chunk(mode, c, 0, 40)
        states.append(c.v)
    assert not torch.equal(*states)


def _scene_file(tmp_path, seed):
    s = _fuzz_scene(seed)
    path = str(tmp_path / f"s{seed}.in")
    write_input(path, _port(s))
    return s, path


@pytest.mark.parametrize("seed", [79, 5])
def test_cli_out_byte_equal_to_native_sqrt3(tmp_path, seed):
    scene, inp = _scene_file(tmp_path, seed)
    out = str(tmp_path / "o.out")
    assert main([inp, out, "--device", "cpu", "--dist3-mode", "sqrt3",
                 "--n-steps", str(STEPS)]) == 0
    with open(out) as f:
        assert f.read() == jio.format_output(*_native(scene, STEPS))


@pytest.mark.parametrize("mode", ["dsqrt", "sqrt3", "pow"])
def test_cli_exact_honours_the_mode(tmp_path, mode):
    scene, inp = _scene_file(tmp_path, 91)
    out = str(tmp_path / "o.out")
    assert main([inp, out, "--precision", "exact", "--dist3-mode", mode,
                 "--n-steps", "60"]) == 0
    with open(out) as f:
        assert f.read() == jio.format_output(*_native(scene, 60, mode))


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_simulate_sqrt3_matches_jax(integrator):
    scene = _fuzz_scene(2)
    jcfg = dataclasses.replace(JaxSimConfig(), dist3_mode="sqrt3")
    want = jax_simulate(scene, jcfg, n_steps=50, precision="f64",
                        platform="cpu", integrator=integrator)
    cfg = SimConfig(dist3_mode="sqrt3")
    got = simulate(_port(scene), cfg, n_steps=50, precision="f64",
                   device="cpu", integrator=integrator)
    np.testing.assert_allclose(got.q, want.q, rtol=1e-12)
    np.testing.assert_allclose(got.v, want.v, rtol=1e-12)
    # the form reaches the force (bodies at rest, as above)
    rest = dataclasses.replace(_port(scene), v=np.zeros((scene.n, 3)))
    a, b = (simulate(rest, c, n_steps=5, precision="f64", device="cpu",
                     integrator=integrator) for c in (cfg, SimConfig()))
    assert not np.array_equal(a.v, b.v)


@pytest.mark.parametrize("precision", ["f64", "e64", "dd", "ddp"])
def test_pow_is_refused_with_its_reason(precision):
    scene = _port(_fuzz_scene(0))
    cfg = SimConfig(n_steps=5, dist3_mode="pow")
    with pytest.raises(ValueError, match="libm"):
        solve_scene(scene, cfg, precision=precision, device="cpu")
    if precision != "ddp":           # simulate's ddp is double-double
        with pytest.raises(ValueError, match="libm"):
            simulate(scene, cfg, n_steps=2, precision=precision,
                     device="cpu")


def test_pow_refused_through_the_cli_and_named_in_help(tmp_path, capsys):
    _, inp = _scene_file(tmp_path, 0)
    with pytest.raises(ValueError, match="libm"):
        main([inp, str(tmp_path / "o.out"), "--device", "cpu",
              "--dist3-mode", "pow", "--n-steps", "5"])
    with pytest.raises(SystemExit):
        main(["--help"])
    assert "libm" in capsys.readouterr().out


def test_one_form_precisions_take_any_mode():
    """f32 and tf3 have one force form each, as in the JAX package."""
    scene = _port(_fuzz_scene(5))
    for precision in ("f32", "tf3"):
        a = solve_scene(scene, SimConfig(n_steps=30, dist3_mode="pow"),
                        precision=precision, device="cpu")
        b = solve_scene(scene, SimConfig(n_steps=30), precision=precision,
                        device="cpu")
        assert _bits(a.as_tuple()) == _bits(b.as_tuple())


def test_wrappers_refuse_unknown_forms():
    q = torch.zeros((1, 4, 3), dtype=torch.float64)
    with pytest.raises(KeyError):
        accel_f64(q, torch.ones((1, 4), dtype=torch.float64), eps=1e-3,
                  dist3_mode="pow")
    c = ds._p12_carry(_port(_fuzz_scene(0)), oscillation_table(
        SimConfig(n_steps=10)), SimConfig(n_steps=10), "cpu", torch.float64)
    c.dist3 = "pow"
    with pytest.raises(ValueError, match="dist3"):
        gs.graded_chunk(gs.P12, c, 0, 5)
