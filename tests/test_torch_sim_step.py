"""simulate()'s binary64 step kernel: its plain version and its wrapper on
the CPU (ops/sim_step.py), and the kernel on a card.

On the CPU:
  * `sim_chunk_f64_ref` bitwise equal to simulate's eager loop as it
    stood before the step kernel (a copy of that loop below), for Euler
    and leapfrog, with Kahan compensation on and off, devices on and off,
    in chunks of 1, 7 and 50 steps, in dsqrt and sqrt3;
  * within 1e-12 of JAX `simulate(precision='f64', platform='cpu')`, the
    tolerance tests/test_torch_simulate.py holds the f64 path to (the JAX
    package sums the force in XLA's order, the port in the serial one);
  * an emulation of the kernel's control flow in PyTorch ops (the state
    buffer's slots, the chunk's first launch that forms gm and the
    leapfrog's kick and drift, each step's update and what it forms for
    the next step) bitwise equal to the plain version;
  * a run stopped at half its steps, its carry saved and loaded, and
    resumed, bitwise equal to the run that never stopped;
  * simulate routes one-device binary64 (also when asked for 'cuda') to
    the wrapper, the mesh to the row-range form of the step kernel;
  * the wrapper's refusals, and the build covering the new sources.
On a card (marked `cuda`, skipped here) the kernel is held bitwise against
the plain version and against the eager loop around kernel B1:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sim_step.py
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from nbody_tpu_torch import Scene, SimConfig, simulate
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import sim_step as ss
from nbody_tpu_torch.ops.accel_f64 import accel_f64_ref
from nbody_tpu_torch.ops.integrate import accel, kdk_leapfrog_step, \
    scalar, symplectic_euler_step
from nbody_tpu_torch.physics import oscillation_table
from nbody_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

CFG = SimConfig()
STEPS = 50
VARIANTS = [(i, c) for i in ss.INTEGRATORS for c in (False, True)]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain force is a loop of tiny ops; torch's thread pool only
    slows it down on this host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(seed: int = 1, n: int = 16) -> Scene:
    """A fuzz scene built as tests/test_fuzz_differential.py builds its
    own, with two gravity devices, so the oscillation table matters."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 3) * 10.0 ** rng.uniform(9, 11)
    v = rng.randn(n, 3) * 10.0 ** rng.uniform(2, 4)
    m = np.abs(rng.randn(n)) * 10.0 ** rng.uniform(20, 26, size=n)
    m[2:4] = 10.0 ** rng.uniform(25.5, 28, size=2)
    types = ["planet", "asteroid", "device", "device"] + ["star"] * (n - 4)
    return Scene(n=n, planet=0, asteroid=1, q=q, v=v, m=m, types=types,
                 device_idx=np.asarray([2, 3], np.int64))


def _t(x, device="cpu"):
    return torch.from_numpy(np.asarray(x, np.float64)).to(device)


def _inputs(scene, n_steps, devices_on=True, device="cpu"):
    """simulate's masses and table for the scene, as tensors."""
    mask = scene.device_mask()
    m0 = scene.m * (1.0 if devices_on else (1.0 - mask))
    return (_t(m0, device), _t(0.5 * m0 * mask, device),
            _t(oscillation_table(CFG, n_steps), device))


def _carry(scene, integrator, compensated, m0, m_half, fst, dist3="dsqrt",
           device="cpu"):
    """simulate's carry at step 0: the leapfrog seeded with the first
    step's masses through kernel B1's wrapper, zero compensations."""
    c = ss.SimCarry(_t(scene.q, device), _t(scene.v, device))
    if integrator == "leapfrog":
        c.a = accel(c.q, m0 + m_half * float(fst[1]), G=CFG.G, eps=CFG.eps,
                    dist3_mode=dist3)
    if compensated:
        c.qc, c.vc = torch.zeros_like(c.q), torch.zeros_like(c.v)
    return c


def _kw(integrator, compensated, dist3="dsqrt"):
    return {"G": CFG.G, "eps": CFG.eps, "dt": CFG.dt,
            "integrator": integrator, "compensated": compensated,
            "dist3_mode": dist3}


def _run(fn, c, m0, m_half, fst, n_steps, chunk, **kw):
    for s0 in range(0, n_steps, chunk):
        fn(c, m0, m_half, fst, s0, min(s0 + chunk, n_steps), **kw)
    return c


def _parent_loop(q, v, m0t, m_halft, fst, n_steps, *, integrator,
                 compensated, dist3):
    """simulate's binary64 loop before the step kernel, as it was: eager
    ops around kernel B1's wrapper, fst host floats."""
    G, eps, dt = CFG.G, CFG.eps, CFG.dt

    def comp(x, c, d):
        y = d - c
        t = x + y
        return t, (t - x) - y

    a = None
    if integrator == "leapfrog":
        a = accel(q, m0t + m_halft * fst[min(1, n_steps)], G=G, eps=eps,
                  dist3_mode=dist3)
    if compensated:
        qc, vc = torch.zeros_like(q), torch.zeros_like(v)
        kick, drift = scalar(0.5 * dt, q.dtype), scalar(dt, q.dtype)
    for s in range(1, n_steps + 1):
        m_eff = m0t + m_halft * fst[s]
        if integrator == "leapfrog" and compensated:
            v, vc = comp(v, vc, a * kick)
            q, qc = comp(q, qc, v * drift)
            a = accel(q, m_eff, G=G, eps=eps, dist3_mode=dist3)
            v, vc = comp(v, vc, a * kick)
        elif integrator == "leapfrog":
            q, v, a = kdk_leapfrog_step(q, v, a, m_eff, G=G, eps=eps, dt=dt,
                                        dist3_mode=dist3)
        elif compensated:
            a = accel(q, m_eff, G=G, eps=eps, dist3_mode=dist3)
            v, vc = comp(v, vc, a * drift)
            q, qc = comp(q, qc, v * drift)
        else:
            q, v = symplectic_euler_step(q, v, m_eff, G=G, eps=eps, dt=dt,
                                         dist3_mode=dist3)
    return q, v


def _equal(got: ss.SimCarry, want: ss.SimCarry):
    for f in dataclasses.fields(ss.SimCarry):
        if not f.compare:     # the graph path's cache and buffers
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert (g is None) == (w is None), f.name
        if g is not None:
            assert torch.equal(g.cpu(), w.cpu()), f.name


# --- the plain version on the CPU -------------------------------------------

@pytest.mark.parametrize("dist3", ["dsqrt", "sqrt3"])
@pytest.mark.parametrize("chunk", [1, 7, STEPS])
@pytest.mark.parametrize("devices_on", [True, False])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_ref_bitwise_equal_to_parent_eager_loop(integrator, compensated,
                                                devices_on, chunk, dist3):
    scene = _scene()
    m0, m_half, fst = _inputs(scene, STEPS, devices_on)
    c = _carry(scene, integrator, compensated, m0, m_half, fst, dist3)
    _run(ss.sim_chunk_f64_ref, c, m0, m_half, fst, STEPS, chunk,
         **_kw(integrator, compensated, dist3))
    q0, v0 = (torch.from_numpy(x) for x in (scene.q, scene.v))
    q, v = _parent_loop(q0, v0, m0, m_half, fst.tolist(), STEPS,
                        integrator=integrator, compensated=compensated,
                        dist3=dist3)
    assert torch.equal(c.q, q) and torch.equal(c.v, v)


@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_simulate_matches_jax_f64(integrator, compensated):
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.io import Scene as JaxScene
    from nbody_tpu.simulate import simulate as jax_simulate

    scene = _scene(2)
    jscene = JaxScene(**{f.name: getattr(scene, f.name)
                         for f in dataclasses.fields(scene)})
    want = jax_simulate(jscene, JaxSimConfig(), platform="cpu",
                        n_steps=STEPS, precision="f64",
                        integrator=integrator, compensated=compensated,
                        chunk=16)
    got = simulate(scene, CFG, n_steps=STEPS, precision="f64", device="cpu",
                   integrator=integrator, compensated=compensated, chunk=16)
    np.testing.assert_allclose(got.q, want.q, rtol=1e-12)
    np.testing.assert_allclose(got.v, want.v, rtol=1e-12)


def _kernel_emulation(c, m0, m_half, fst, s0, s1, *, G, eps, dt,
                      integrator, compensated, dist3_mode):
    """csrc/sim_step_f64.cu's control flow in PyTorch ops, each one op as
    the kernel's intrinsics round it: the state buffer's slots over a
    ping-pong pair, sim_pre_kernel on the first buffer, then each step's
    force from the slots p (leapfrog) or q and gm, its update, and what it
    forms for step t + 1 unless t ends the chunk."""
    Q, V, A, QC, VC, P, VH, PC, VHC, GM = range(ss.SLOTS)
    n, kick = c.q.shape[0], 0.5 * dt
    st = torch.full((2, ss.SLOTS, n, 3), float("nan"), dtype=torch.float64)
    for slot, x in enumerate((c.q, c.v, c.a, c.qc, c.vc)):
        if x is not None:
            st[0, slot] = x
    f = fst.tolist()

    def comp(x, cc, d):
        y = d - cc
        t = x + y
        return t, (t - x) - y

    def form(buf, t, q, v, acc, qc, vc):
        buf[GM, :, 0] = (m0 + m_half * f[t]) * G
        if integrator == "euler":
            return
        if compensated:
            buf[VH], buf[VHC] = comp(v, vc, acc * kick)
            buf[P], buf[PC] = comp(q, qc, buf[VH] * dt)
        else:
            buf[VH] = v + acc * kick
            buf[P] = q + buf[VH] * dt

    b0 = st[0]
    form(b0, s0 + 1, b0[Q], b0[V], b0[A], b0[QC], b0[VC])
    for t in range(s0 + 1, s1 + 1):
        src, out = st[(t - s0 - 1) & 1], st[(t - s0) & 1]
        lf = integrator == "leapfrog"
        pos = src[P] if lf else src[Q]
        acc = accel_f64_ref(pos[None], pos[None], src[GM, :, 0][None],
                            eps=eps, dist3_mode=dist3_mode)[0]
        q, v = pos, src[VH] if lf else src[V]
        qc, vc = (src[PC], src[VHC]) if lf else (src[QC], src[VC])
        h = kick if lf else dt
        if compensated:
            out[V], out[VC] = comp(v, vc, acc * h)
        else:
            out[V] = v + acc * h
        if not lf:
            if compensated:
                out[Q], out[QC] = comp(q, qc, out[V] * dt)
            else:
                out[Q] = q + out[V] * dt
        else:
            out[Q], out[QC], out[A] = q, qc, acc
        if t < s1:
            form(out, t + 1, out[Q], out[V], out[A], out[QC], out[VC])
    end = st[(s1 - s0) & 1]
    c.q, c.v = end[Q].clone(), end[V].clone()
    if c.a is not None:
        c.a = end[A].clone()
    if compensated:
        c.qc, c.vc = end[QC].clone(), end[VC].clone()


@pytest.mark.parametrize("chunks", [[(0, 1), (1, 2), (2, 9)], [(0, 9)]])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_kernel_control_flow_bitwise_equal_to_ref(integrator, compensated,
                                                  chunks):
    scene = _scene(4)
    m0, m_half, fst = _inputs(scene, 9)
    kw = _kw(integrator, compensated, "sqrt3")
    got = _carry(scene, integrator, compensated, m0, m_half, fst, "sqrt3")
    want = _carry(scene, integrator, compensated, m0, m_half, fst, "sqrt3")
    for s0, s1 in chunks:
        _kernel_emulation(got, m0, m_half, fst, s0, s1, **kw)
        ss.sim_chunk_f64_ref(want, m0, m_half, fst, s0, s1, **kw)
    _equal(got, want)


@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_checkpoint_at_half_resumes_bitwise(tmp_path, integrator,
                                            compensated):
    """The carry saved at half the run (utils.checkpoint, the rest of the
    carry as extra arrays) and resumed through the chunk function: bitwise
    the run that never stopped."""
    scene = _scene(5)
    m0, m_half, fst = _inputs(scene, STEPS)
    kw = _kw(integrator, compensated)
    whole = _carry(scene, integrator, compensated, m0, m_half, fst)
    _run(ss.sim_chunk_f64, whole, m0, m_half, fst, STEPS, 20, **kw)

    half = _carry(scene, integrator, compensated, m0, m_half, fst)
    _run(ss.sim_chunk_f64, half, m0, m_half, fst, STEPS // 2, 20, **kw)
    path = str(tmp_path / "ck.npz")
    extra = {k: getattr(half, k).numpy() for k in ("a", "qc", "vc")
             if getattr(half, k) is not None}
    save_checkpoint(path, step=STEPS // 2, q=half.q.numpy(),
                    v=half.v.numpy(), extra=extra)
    step, q, v, extra, _ = load_checkpoint(path)
    resumed = ss.SimCarry(torch.from_numpy(q), torch.from_numpy(v),
                          **{k: torch.from_numpy(x)
                             for k, x in extra.items()})
    for s0 in range(step, STEPS, 20):
        ss.sim_chunk_f64(resumed, m0, m_half, fst, s0,
                         min(s0 + 20, STEPS), **kw)
    _equal(resumed, whole)


def test_fst_table_holds_the_host_floats():
    """The kernel reads the oscillation table from a float64 device table
    where the eager loop multiplies by host floats: the same values, bit
    for bit."""
    table = oscillation_table(CFG, 2000).astype(np.float64)
    floats = table.tolist()
    t = torch.from_numpy(table)
    assert t.dtype == torch.float64
    assert np.array_equal(np.asarray(floats).view(np.uint64),
                          t.numpy().view(np.uint64))
    assert all(float(t[s]) == floats[s] for s in range(0, 2001, 97))


# --- routing ---------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("precision", ["f64", "e64", "dd"])
@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
def test_simulate_routes_binary64_to_the_step_kernel(monkeypatch, device,
                                                     precision, integrator):
    """One-device binary64 goes to sim_chunk_f64 once a chunk, kernel B1's
    wrapper only for the leapfrog seed; with device='cuda' (the device
    resolved to the CPU here, as no card is present) the same."""
    sim_module = sys.modules["nbody_tpu_torch.simulate"]
    chunks, b1 = [], []
    real_chunk, real_b1 = sim_module.sim_chunk_f64, accel_f64_ref

    def chunk_spy(c, m0, m_half, fst, s0, s1, **kw):
        chunks.append((s0, s1))
        return real_chunk(c, m0, m_half, fst, s0, s1, **kw)

    from nbody_tpu_torch.ops import integrate

    def b1_spy(*args, **kw):
        b1.append(1)
        return real_b1(*args, **kw)

    monkeypatch.setattr(sim_module, "sim_chunk_f64", chunk_spy)
    monkeypatch.setattr(integrate, "accel_f64", b1_spy)
    monkeypatch.setattr(sim_module, "resolve_device",
                        lambda name: torch.device("cpu"))
    simulate(_scene(6), CFG, n_steps=12, precision=precision, device=device,
             integrator=integrator, chunk=5)
    assert chunks == [(0, 5), (5, 10), (10, 12)]
    assert len(b1) == (integrator == "leapfrog")


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
def test_mesh_runs_b1_cross_form_not_the_step_kernel(shape):
    """Since the mesh's row-range step kernels, the name's old route is
    gone: an f64 Euler simulate on the mesh makes one call of the binary64
    step kernel's row-range chunk, and no B1 cross form from simulate
    itself nor the one-device chunk."""
    import torch_mesh_workers as W
    from nbody_tpu_torch.parallel.spawn import run_ranks

    out = run_ranks(W.simulate_step_routes, int(np.prod(shape)),
                    ({"scen": shape[0], "body": shape[1]}, _scene(7), 6,
                     "f64"), timeout=120)
    for counts in out:
        assert counts == {"sim_rows_chunk_f64": 1}


# --- the wrapper's refusals ------------------------------------------------

def _good(integrator="euler", compensated=False):
    scene = _scene(8, 5)
    m0, m_half, fst = _inputs(scene, 4)
    c = _carry(scene, integrator, compensated, m0, m_half, fst)
    return c, m0, m_half, fst


REFUSALS = {
    "float32 state": (TypeError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, q=c.q.float()), m0, mh, fst, 0, 2, {})),
    "float32 masses": (TypeError, lambda c, m0, mh, fst: (
        c, m0.float(), mh, fst, 0, 2, {})),
    "batched state": (ValueError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, q=c.q[None], v=c.v[None]), m0, mh, fst, 0, 2,
        {})),
    "masses of another n": (ValueError, lambda c, m0, mh, fst: (
        c, m0[:-1], mh, fst, 0, 2, {})),
    "steps past the table": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 2, 5, {})),
    "no steps": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 2, 2, {})),
    "leapfrog without a": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 0, 2, {"integrator": "leapfrog"})),
    "compensated without qc": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 0, 2, {"compensated": True})),
    "unknown integrator": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 0, 2, {"integrator": "rk4"})),
    "pow": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 0, 2, {"dist3_mode": "pow"})),
    "non-contiguous": (ValueError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, q=c.q.t().contiguous().t()), m0, mh, fst, 0,
        2, {})),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses(case):
    err, make = REFUSALS[case]
    c, m0, mh, fst, s0, s1, kw = make(*_good())
    before = ss.sim_chunk_f64.launches
    with pytest.raises(err):
        ss.sim_chunk_f64(c, m0, mh, fst, s0, s1, **{**_kw("euler", False),
                                                    **kw})
    assert ss.sim_chunk_f64.launches == before


def test_build_digest_covers_the_new_sources(tmp_path, monkeypatch):
    """sim_step_f64.cu is compiled, and an edit to it or to the shared
    binary64 block force (f64_force.cuh) rebuilds the library."""
    import shutil

    assert "sim_step_f64.cu" in _build.SOURCES
    assert {"f64_force.cuh", "sim_step_f64.cu"} <= set(os.listdir(_build.CSRC))
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    digest = _build.source_digest()
    for name in ("f64_force.cuh", "sim_step_f64.cu"):
        path = csrc / name
        path.write_text(path.read_text() + "\n")
        edited = _build.source_digest()
        assert edited != digest
        digest = edited


# --- on a card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dist3", ["dsqrt", "sqrt3"])
@pytest.mark.parametrize("n", [5, 64, 1000])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_kernel_bitwise_equal_to_ref_on_card(cuda, integrator, compensated,
                                             n, dist3):
    scene = _scene(9, n)
    m0, m_half, fst = _inputs(scene, 7, device=cuda)
    kw = _kw(integrator, compensated, dist3)
    got = _carry(scene, integrator, compensated, m0, m_half, fst, dist3,
                 cuda)
    want = _carry(scene, integrator, compensated, m0, m_half, fst, dist3,
                  cuda)
    before = ss.sim_chunk_f64.launches
    for s0, s1 in ((0, 1), (1, 4), (4, 7)):
        ss.sim_chunk_f64(got, m0, m_half, fst, s0, s1, **kw)
        ss.sim_chunk_f64_ref(want, m0, m_half, fst, s0, s1, **kw)
    torch.cuda.synchronize()
    # three chunks: one persistent launch each up to 512 bodies, above
    # it the pre-launch and one a step (7 steps)
    assert ss.sim_chunk_f64.launches == before + (3 if n <= 512 else 7 + 3)
    _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_simulate_on_card_bitwise_invariant_to_chunk(cuda, integrator,
                                                     compensated):
    scene = _scene(10, 300)
    runs = [simulate(scene, CFG, n_steps=40, precision="f64", device="cuda",
                     integrator=integrator, compensated=compensated,
                     chunk=chunk) for chunk in (1, 13, 40)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.q, runs[0].q)
        np.testing.assert_array_equal(r.v, runs[0].v)
