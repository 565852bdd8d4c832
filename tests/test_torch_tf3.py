"""Precision 'tf3' (beyond binary64) in `simulate()` and the graded plain
chunks, on the CPU.

The port runs double-double binary64 (about 2^-104 an operation, no
rescale) where the JAX package runs triple-float32 (about 2^-70, on a
rescaled scene). `simulate` in 'tf3', 'ddp' and 'dd+' (one path) is held
against JAX `simulate(precision='tf3', platform='cpu')` over 25 steps of
fuzz scene 0, both states taken beyond binary64 (the port's q + q_lo, the
JAX triple as caught on its way to binary64): within JAX_TOL = 1e-20 of
the peak |q| and |v| (measured 2.2e-22 and 2.7e-22, Euler and leapfrog),
and at least 100x closer than the port's 'f64' is (2.2e-16). Against the
port's own 'f64' at rtol 1e-13, the JAX package's own bound for tf3
against f64 (tests/test_simulate.py:61-83). Results are bitwise invariant
to `chunk`.

The graded plain dd chunks: answers bitwise equal at chunk lengths 1, 7
and 2000; the phased drivers (n=140 with a batched Problem 3, n=256 with
a sequential one) against the port's f64 and the native core: discrete
answers equal and min distance within 1e-9 (binary64's rounding, which
tf3 removes, moves it by less). tests/test_torch_tf3_graded.py holds the
graded answers against JAX 'tf3'.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from nbody_tpu_torch import Scene, SimConfig, SimState, simulate, \
    solve_scene
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.ops import ddfloat as ddf
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.ops import integrate, sim_step
from nbody_tpu_torch.physics import oscillation_table
from test_fuzz_differential import _fuzz_scene
from test_torch_accel_dd import _tf3_to_dd

STEPS = 25
JAX_TOL = 1e-20
F64_RTOL = 1e-13


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor ops a step: one thread each runs them
    many times faster than the default pool on this kind of host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def jax_tf3():
    """JAX simulate 'tf3' on fuzz scene 0 per integrator: its final q and v
    as exact double-double (the TF3 triples as `host_qv` rounds them),
    unscaled."""
    import nbody_tpu.ops.tfloat as tfloat
    from nbody_tpu.simulate import simulate as jax_simulate

    out = {}
    for integrator in ("euler", "leapfrog"):
        seen = []
        orig = tfloat.to_f64

        def spy(a):
            seen.append(a)
            return orig(a)

        tfloat.to_f64 = spy
        try:
            w = jax_simulate(_fuzz_scene(0), n_steps=STEPS, chunk=STEPS,
                             precision="tf3", platform="cpu",
                             integrator=integrator)
        finally:
            tfloat.to_f64 = orig
        q3, v3 = seen[-2:]
        inv = float(w.q[0, 0]) / float(orig(q3)[0, 0])   # 2^-qe, exact
        out[integrator] = tuple(
            ddf.DD(x.hi * inv, x.lo * inv)
            for x in (_tf3_to_dd(q3), _tf3_to_dd(v3)))
    return out


def _dd(x: np.ndarray, lo) -> ddf.DD:
    lo = np.zeros_like(x) if lo is None else lo
    return ddf.DD(torch.from_numpy(x), torch.from_numpy(lo))


def _err(got: ddf.DD, want: ddf.DD) -> float:
    d = ddf.to_f64(ddf.join(ddf.sub(got, want))).abs().max()
    return float(d) / float(want.hi.abs().max())


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("precision", ["tf3", "ddp", "dd+"])
def test_simulate_matches_jax_tf3(jax_tf3, precision, integrator):
    scene = _port(_fuzz_scene(0))
    got = simulate(scene, n_steps=STEPS, precision=precision, device="cpu",
                   integrator=integrator)
    f64 = simulate(scene, n_steps=STEPS, precision="f64", device="cpu",
                   integrator=integrator)
    wq, wv = jax_tf3[integrator]
    for x, lo, want, x64 in ((got.q, got.q_lo, wq, f64.q),
                             (got.v, got.v_lo, wv, f64.v)):
        e = _err(_dd(x, lo), want)
        assert e <= JAX_TOL
        assert _err(_dd(x64, None), want) >= 100 * e


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("seed", [0, 5])
def test_simulate_tf3_close_to_f64(seed, integrator):
    scene = _port(_fuzz_scene(seed))
    got = simulate(scene, n_steps=STEPS, precision="tf3", device="cpu",
                   integrator=integrator)
    want = simulate(scene, n_steps=STEPS, precision="f64", device="cpu",
                    integrator=integrator)
    np.testing.assert_allclose(got.q, want.q, rtol=F64_RTOL)
    np.testing.assert_allclose(got.v, want.v, rtol=F64_RTOL)
    assert not np.array_equal(got.v, want.v)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_simulate_tf3_bitwise_invariant_to_chunk(integrator):
    scene = _port(_fuzz_scene(1))
    runs = [simulate(scene, n_steps=STEPS, precision="tf3", device="cpu",
                     integrator=integrator, chunk=chunk)
            for chunk in (7, STEPS, 1000)]
    for r in runs[1:]:
        for f in ("q", "v", "q_lo", "v_lo"):
            np.testing.assert_array_equal(getattr(r, f), getattr(runs[0], f))


def test_on_chunk_sees_the_binary64_rounding_and_the_rest():
    scene = _port(_fuzz_scene(4))
    states = []
    final = simulate(scene, n_steps=30, precision="tf3", device="cpu",
                     chunk=10, on_chunk=states.append)
    assert [s.step for s in states] == [10, 20, 30]
    assert all(isinstance(s, SimState) and s.q.dtype == np.float64
               and s.q_lo.shape == s.q.shape for s in states)
    np.testing.assert_array_equal(states[-1].q, final.q)
    # q is hi + lo rounded, q_lo the exact rest
    assert np.all(final.q + final.q_lo == final.q)
    assert np.any(final.q_lo != 0)
    f64 = simulate(scene, n_steps=30, precision="f64", device="cpu")
    assert f64.q_lo is None and f64.v_lo is None


@pytest.mark.parametrize("integrator,calls", [("euler", STEPS),
                                              ("leapfrog", STEPS + 1)])
def test_simulate_tf3_goes_through_kernel_b4(monkeypatch, integrator,
                                              calls):
    """Every step's force is kernel B4's, inside the double-double step
    kernel's wrapper (once a chunk); B4's own wrapper runs the leapfrog's
    seed alone, and kernel B1 never runs."""
    seen = []
    orig, orig_chunk = integrate.accel_dd, sim_step.sim_chunk_dd

    def spy(qi, qj, gm, *, eps):
        seen.append(qi.shape)
        return orig(qi, qj, gm, eps=eps)

    def chunk_spy(c, m0, m_half, fst, s0, s1, **kw):
        seen.extend([c.q[None].shape] * (s1 - s0))
        return orig_chunk(c, m0, m_half, fst, s0, s1, **kw)

    monkeypatch.setattr(integrate, "accel_dd", spy)
    monkeypatch.setattr(integrate, "accel_f64", None)
    monkeypatch.setattr(sys.modules["nbody_tpu_torch.simulate"],
                        "sim_chunk_dd", chunk_spy)
    simulate(_port(_fuzz_scene(6)), n_steps=STEPS, precision="tf3",
             device="cpu", integrator=integrator, chunk=7)
    assert seen == [(1, 16, 3, 2)] * calls


@pytest.mark.parametrize("precision", ["tf3", "ddp", "dd+", "dd"])
def test_compensation_is_refused_beyond_the_native_paths(precision):
    with pytest.raises(ValueError, match="compensated"):
        simulate(_port(_fuzz_scene(0)), n_steps=2, precision=precision,
                 device="cpu", compensated=True)


def _bits(ans):
    md, hs, dev, cost = ans
    return np.float64(md).tobytes(), hs, dev, np.float64(cost).tobytes()


@pytest.mark.parametrize("seed", [5, 79])
def test_graded_tf3_bitwise_invariant_to_chunk(seed):
    scene = _port(_fuzz_scene(seed))
    keys = {_bits(solve_scene(scene, SimConfig(n_steps=240, chunk_steps=cs),
                              precision="tf3", device="cpu").as_tuple())
            for cs in (1, 7, 2000)}
    assert len(keys) == 1


@pytest.mark.parametrize("mode", [gs.P12, gs.P3, gs.P123])
def test_plain_dd_chunks_split_anywhere(mode):
    """Two plain dd chunks equal one over the same steps, every carry."""
    scene = _port(_fuzz_scene(5))
    cfg = SimConfig(n_steps=50)
    fst = oscillation_table(cfg)

    def make():
        if mode == gs.P12:
            return ds._p12_carry(scene, fst, cfg, "cpu", ds.DD)
        if mode == gs.P123:
            return ds._p123_carry(scene, fst, cfg, "cpu", ds.DD)
        qv = [ds._t(np.stack([x] * 2), "cpu", ds.DD)
              for x in (scene.q, scene.v)]
        p12 = ds.P12Result(min_dist=0.0, hit_time_step=40,
                           arrivals=np.asarray([3, 20]), q_snaps=qv[0],
                           v_snaps=qv[1])
        return ds._p3_carry(scene, p12, fst, cfg, np.arange(2), "cpu", ds.DD)

    whole, split = make(), make()
    assert whole.q.shape[-1] == 2
    gs._REF[mode](whole, 0, 30)
    for s0, s1 in ((0, 1), (1, 8), (8, 30)):
        gs.graded_chunk(mode, split, s0, s1)
    for f in dataclasses.fields(whole):
        x = getattr(whole, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, getattr(split, f.name)), f.name


@pytest.mark.parametrize("seed,n,n_steps", [(79, 140, 120), (91, 256, 110)])
def test_graded_tf3_phased_close_to_f64_and_native(seed, n, n_steps):
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.native import solve_exact

    scene = _grown(seed, n)
    cfg = SimConfig(n_steps=n_steps, chunk_steps=40)
    got = solve_scene(scene, cfg, precision="tf3", device="cpu")
    f64 = solve_scene(scene, cfg, device="cpu")
    native = solve_exact(scene, dataclasses.replace(
        JaxSimConfig(), n_steps=n_steps, dist3_mode="dsqrt"),
        dist3_mode="dsqrt")
    assert got.hit_time_step != -2
    for want in (f64.as_tuple(), native):
        assert got.as_tuple()[1:] == tuple(want[1:])
        assert got.min_dist == pytest.approx(want[0], rel=1e-9)


def test_step_tables_in_double_double():
    """r^2 = pr*pr and md^2 = (fl64(speed*dt)*s)^2 carried exactly (both
    products need at most 106 bits), fst with lo = 0."""
    from fractions import Fraction

    cfg = SimConfig(n_steps=300)
    hi, lo = ds._r2(cfg, ds.DD)
    assert Fraction(hi) + Fraction(lo) == Fraction(cfg.planet_radius) ** 2
    md2 = ds._md2_table(cfg, "cpu", ds.DD)
    sdt = Fraction(cfg.missile_speed * cfg.dt)
    for s in (0, 1, 7, 300):
        assert Fraction(float(md2[s, 0])) + Fraction(float(md2[s, 1])) == \
            (sdt * s) ** 2
    fst = ds._fst_table(oscillation_table(cfg), "cpu", ds.DD)
    assert fst[:, 0].tolist() == oscillation_table(cfg).tolist()
    assert not fst[:, 1].any()


def test_graded_tf3_wrapper_refuses_cpu_and_other_representations():
    scene = _port(_fuzz_scene(5))
    cfg = SimConfig(n_steps=10)
    fst = oscillation_table(cfg)
    dd = ds._p12_carry(scene, fst, cfg, "cpu", ds.DD)
    f64 = ds._p12_carry(scene, fst, cfg, "cpu", torch.float64)
    before = gs.graded_step_dd.launches
    with pytest.raises(ValueError, match="cuda"):
        gs.graded_step_dd(gs.P12, dd, 0, 5)
    with pytest.raises(TypeError):
        gs.graded_step_dd(gs.P12, f64, 0, 5)
    with pytest.raises(TypeError):
        gs.graded_step_f64(gs.P12, dd, 0, 5)
    dd.md2 = dd.md2[:, 0].contiguous()          # a table without its los
    with pytest.raises(ValueError, match="md2"):
        gs.graded_chunk(gs.P12, dd, 0, 5)
    assert gs.graded_step_dd.launches == before
