"""The port's general simulation API against the JAX package's `simulate`.

On the CPU the port runs the plain versions of its kernels. Held against
`nbody_tpu.simulate.simulate(platform='cpu')`:
  * 'f64' (Euler and leapfrog) at rtol 1e-12: the port folds the force
    serially (kernel B1's order), XLA sums in its own order, so the two
    differ by ulps that 50 steps do not amplify past that;
  * 'f32', with and without Kahan compensation, at rtol 1e-5 with an atol
    of 1e-5 of the peak: the port folds each 128-wide j-tile serially
    and adds the tile sums in order (kernel B2's order), JAX sums over all
    j at once, and the rsqrt implementations differ, all by float32
    roundings (the state itself is held to ~2e-8 of the peak).
The port's results are bitwise invariant to the chunk size, on any device.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu.io import Scene as JaxScene
from nbody_tpu.simulate import simulate as jax_simulate
from nbody_tpu_torch import Scene, SimConfig, SimState, simulate
from nbody_tpu_torch.models.plummer import plummer_scene
from nbody_tpu_torch.ops import integrate
from nbody_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from nbody_tpu_torch.utils.rescale import compute_rescale
from test_fuzz_differential import _fuzz_scene

CFG = SimConfig()
JCFG = JaxSimConfig()
STEPS = 50


def _port(scene) -> Scene:
    return Scene(**{f.name: getattr(scene, f.name)
                    for f in dataclasses.fields(scene)})


def _plummer(n: int, seed: int) -> JaxScene:
    """A Plummer sphere with its first two bodies as planet and asteroid and
    the next two as gravity devices (so the oscillation table matters)."""
    q, v, m = plummer_scene(n, seed=seed)
    types = ["planet", "asteroid", "device", "device"] + ["star"] * (n - 4)
    return JaxScene(n=n, planet=0, asteroid=1, q=q, v=v, m=m, types=types,
                    device_idx=np.asarray([2, 3], np.int64))


SCENES = {"fuzz0": lambda: _fuzz_scene(0), "fuzz5": lambda: _fuzz_scene(5),
          "plummer64": lambda: _plummer(64, 3)}


def _both(scene, **kw):
    want = jax_simulate(scene, JCFG, platform="cpu", **kw)
    got = simulate(_port(scene), CFG, device="cpu", **kw)
    assert got.step == want.step == kw["n_steps"]
    assert got.q.dtype == got.v.dtype == np.float64
    return got, want


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_f64_matches_jax(scene, integrator):
    got, want = _both(SCENES[scene](), n_steps=STEPS, precision="f64",
                      integrator=integrator, chunk=16)
    np.testing.assert_allclose(got.q, want.q, rtol=1e-12)
    np.testing.assert_allclose(got.v, want.v, rtol=1e-12)


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_f32_matches_jax(scene, integrator, compensated):
    got, want = _both(SCENES[scene](), n_steps=STEPS, precision="f32",
                      integrator=integrator, chunk=16,
                      compensated=compensated)
    for g, w in ((got.q, want.q), (got.v, want.v)):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_devices_off_matches_jax(precision):
    got, want = _both(_fuzz_scene(7), n_steps=30, precision=precision,
                      devices_on=False)
    rtol = 1e-5 if precision == "f32" else 1e-12
    np.testing.assert_allclose(got.q, np.asarray(want.q, np.float64),
                               rtol=rtol)
    on = simulate(_port(_fuzz_scene(7)), CFG, n_steps=30,
                  precision=precision, device="cpu")
    assert not np.array_equal(on.q, got.q)    # the devices' mass matters


@pytest.mark.parametrize("precision,integrator,compensated", [
    ("f32", "euler", True), ("f32", "leapfrog", True),
    ("f32", "euler", False), ("f64", "euler", None),
    ("f64", "leapfrog", True)])
def test_bitwise_invariant_to_chunk(precision, integrator, compensated):
    scene = _port(_fuzz_scene(1))
    runs = [simulate(scene, CFG, n_steps=STEPS, precision=precision,
                     device="cpu", integrator=integrator, chunk=chunk,
                     compensated=compensated) for chunk in (7, STEPS, 1000)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.q, runs[0].q)
        np.testing.assert_array_equal(r.v, runs[0].v)


def test_e64_is_the_f64_path():
    scene = _port(_fuzz_scene(2))
    a = simulate(scene, CFG, n_steps=20, precision="e64", device="cpu",
                 integrator="leapfrog")
    b = simulate(scene, CFG, n_steps=20, precision="f64", device="cpu",
                 integrator="leapfrog")
    np.testing.assert_array_equal(a.q, b.q)
    np.testing.assert_array_equal(a.v, b.v)


def test_zero_steps_returns_the_initial_state():
    scene = _port(_fuzz_scene(3))
    out = simulate(scene, CFG, n_steps=0, precision="f64", device="cpu",
                   integrator="leapfrog")
    assert out.step == 0
    np.testing.assert_array_equal(out.q, scene.q)
    np.testing.assert_array_equal(out.v, scene.v)


def test_on_chunk_and_checkpoint_resume(tmp_path):
    """on_chunk sees host float64 states every `chunk` steps; a state saved
    at step 20 and resumed for 10 steps is bit-equal to the one-shot run
    (devices off, so the masses do not depend on the absolute step)."""
    scene = _port(_fuzz_scene(4))
    states = []
    final = simulate(scene, CFG, n_steps=30, precision="f64", device="cpu",
                     devices_on=False, chunk=10, on_chunk=states.append)
    assert [s.step for s in states] == [10, 20, 30]
    assert all(isinstance(s, SimState) and s.q.dtype == np.float64
               for s in states)
    np.testing.assert_array_equal(states[-1].q, final.q)

    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, step=states[1].step, q=states[1].q, v=states[1].v)
    step, q, v, _, _ = load_checkpoint(path)
    assert step == 20
    resumed = simulate(dataclasses.replace(scene, q=q, v=v), CFG,
                       n_steps=30 - step, precision="f64", device="cpu",
                       devices_on=False)
    np.testing.assert_array_equal(resumed.q, final.q)
    np.testing.assert_array_equal(resumed.v, final.v)


@pytest.mark.parametrize("precision,integrator,force_calls", [
    ("f32", "euler", STEPS), ("f32", "leapfrog", STEPS + 1),
    ("f64", "euler", STEPS), ("f64", "leapfrog", STEPS + 1)])
def test_force_goes_through_the_kernel_wrappers(monkeypatch, precision,
                                                integrator, force_calls):
    """f32 calls the float32 step kernel's wrapper once a chunk, each of
    whose steps runs kernel B2's force, and B2's wrapper for the leapfrog
    seed; f64 the binary64 step kernel's wrapper once a chunk, each of
    whose steps runs kernel B1's force, and B1's wrapper (as a batch of 1)
    for the leapfrog seed."""
    calls = {"f32": 0, "f64": 0}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    def chunk_spy(name, fn):
        def wrapped(c, m0, m_half, fst, s0, s1, **kw):
            calls[name] += s1 - s0
            return fn(c, m0, m_half, fst, s0, s1, **kw)
        return wrapped

    sim_module = sys.modules["nbody_tpu_torch.simulate"]
    monkeypatch.setattr(integrate, "accel_f32_self",
                        spy("f32", integrate.accel_f32_self))
    monkeypatch.setattr(integrate, "accel_f64",
                        spy("f64", integrate.accel_f64))
    for name in ("f32", "f64"):
        monkeypatch.setattr(sim_module, f"sim_chunk_{name}",
                            chunk_spy(name, getattr(sim_module,
                                                    f"sim_chunk_{name}")))
    simulate(_port(_fuzz_scene(6)), CFG, n_steps=STEPS, precision=precision,
             device="cpu", integrator=integrator)
    other = "f64" if precision == "f32" else "f32"
    assert calls == {precision: force_calls, other: 0}


@pytest.mark.parametrize("kw,err", [
    ({"mesh": object()}, TypeError),
    ({"tile": 64}, ValueError),
    ({"precision": "e64", "compensated": True}, ValueError),
    ({"precision": "tf3", "compensated": True}, ValueError),
    ({"precision": "dd", "compensated": True}, ValueError),
    ({"precision": "ddp", "compensated": True}, ValueError),
    ({"precision": "bf16"}, ValueError),
    ({"integrator": "rk4"}, ValueError),
    ({"chunk": 0}, ValueError),
])
def test_rejected_options(kw, err):
    with pytest.raises(err):
        simulate(_port(_fuzz_scene(0)), CFG, n_steps=2, device="cpu", **kw)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("scene", ["fuzz0", "plummer64"])
def test_dd_matches_jax(scene, integrator):
    """'dd' runs binary64 (kernel B1), where the JAX package runs its
    double-double on the rescaled scene: within 1e-9, the graded 'dd'
    tolerance (tests/test_torch_precisions.py); measured 4.4e-16 here."""
    got, want = _both(SCENES[scene](), n_steps=STEPS, precision="dd",
                      integrator=integrator, chunk=16)
    np.testing.assert_allclose(got.q, want.q, rtol=1e-9)
    np.testing.assert_allclose(got.v, want.v, rtol=1e-9)


def test_dd_is_the_binary64_path_on_the_rescaled_scene():
    """'dd' is 'f64' on the raw scene: the JAX package's power-of-two
    rescale is exact in binary64, so running on the rescaled scene and
    scaling back gives the same bits."""
    scene = _port(_fuzz_scene(2))
    a = simulate(scene, CFG, n_steps=20, precision="dd", device="cpu")
    b = simulate(scene, CFG, n_steps=20, precision="f64", device="cpu")
    np.testing.assert_array_equal(a.q, b.q)
    np.testing.assert_array_equal(a.v, b.v)
    rs = compute_rescale(scene, eps=CFG.eps)
    c = simulate(rs.apply_scene(scene), rs.apply_cfg(CFG), n_steps=20,
                 precision="f64", device="cpu")
    np.testing.assert_array_equal(c.q / rs.length_scale, b.q)
    np.testing.assert_array_equal(c.v / rs.length_scale, b.v)


def test_f64_rejects_other_dist3_forms():
    cfg = dataclasses.replace(CFG, dist3_mode="pow")
    with pytest.raises(ValueError, match="dsqrt"):
        simulate(_port(_fuzz_scene(0)), cfg, n_steps=2, device="cpu")


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        simulate(_port(_fuzz_scene(0)), CFG, n_steps=2, precision="f32",
                 device="cuda")
