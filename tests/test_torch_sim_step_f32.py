"""simulate()'s float32 step kernel: its plain version and its wrapper on
the CPU (ops/sim_step.py), and the kernel on a card.

On the CPU:
  * `sim_chunk_f32_ref` bitwise equal to simulate's float32 loop as it
    stood before the step kernel (a copy of that loop below: eager ops
    around kernel B2's wrapper), for Euler and leapfrog, with Kahan
    compensation on and off, devices on and off, in chunks of 1, 7 and
    50 steps, on the scene rescaled as simulate rescales it;
  * within rtol 1e-5 and 1e-5 of the peak of JAX
    `simulate(precision='f32', platform='cpu')`, the tolerance
    tests/test_torch_simulate.py holds the f32 path to (the JAX package
    sums the force in XLA's order and its own rsqrt, the port in kernel
    B2's tile order; on the CPU the JAX package runs no Pallas kernel in
    simulate);
  * an emulation of the kernel's control flow in PyTorch ops (the state
    buffer's slots, the chunk's first launch that forms gm and the
    leapfrog's kick and drift, each step's update and what it forms for
    the next step) bitwise equal to the plain version;
  * a run stopped at half its steps, its carry saved and loaded, and
    resumed, bitwise equal to the run that never stopped;
  * simulate routes one-device 'f32' (also when asked for 'cuda') to the
    wrapper, kernel B2's own wrapper only for the leapfrog's seed; the
    mesh to the row-range form of the step kernel;
  * the wrapper's refusals, and the build covering the new sources.
On a card (marked `cuda`, skipped here) the kernel is held bitwise against
the plain version on the card and the eager loop around kernel B2, in
both of B2's block shapes:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sim_step_f32.py
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from nbody_tpu_torch import SimConfig, simulate
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import sim_step as ss
from nbody_tpu_torch.ops.accel_f32 import accel_f32_ref, eps2_f32
from nbody_tpu_torch.ops.integrate import accel, kdk_leapfrog_step, \
    scalar, symplectic_euler_step
from nbody_tpu_torch.physics import oscillation_table
from nbody_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from nbody_tpu_torch.utils.rescale import compute_rescale
from test_torch_sim_step import _equal, _run, _scene, cuda  # noqa: F401

CFG = SimConfig()
STEPS = 50
VARIANTS = [(i, c) for i in ss.INTEGRATORS for c in (False, True)]
F32 = torch.float32


@pytest.fixture(autouse=True)
def one_thread():
    """The plain force is a loop of tiny ops; torch's thread pool only
    slows it down on this host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x, device="cpu"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def _setup(scene, n_steps, integrator, compensated, devices_on=True,
           device="cpu"):
    """simulate's float32 run of the scene: the rescaled config, the masses
    and table as tensors, the carry at step 0 (the leapfrog seeded with
    the first step's masses through kernel B2's wrapper, zero
    compensations) and the unit of length to undo."""
    rs = compute_rescale(scene, eps=CFG.eps)
    run, cfg = rs.apply_scene(scene), rs.apply_cfg(CFG)
    mask = run.device_mask()
    m0 = run.m * (1.0 if devices_on else (1.0 - mask))
    m0t, mht = _t(m0, device), _t(0.5 * m0 * mask, device)
    fst = _t(oscillation_table(cfg, n_steps), device)
    c = ss.SimCarry(_t(run.q, device), _t(run.v, device))
    if integrator == "leapfrog":
        c.a = accel(c.q, m0t + mht * float(fst[1]), G=cfg.G, eps=cfg.eps)
    if compensated:
        c.qc, c.vc = torch.zeros_like(c.q), torch.zeros_like(c.v)
    kw = {"G": cfg.G, "eps": cfg.eps, "dt": cfg.dt, "integrator": integrator,
          "compensated": compensated}
    return c, m0t, mht, fst, kw, 1.0 / rs.length_scale


def _parent_loop(q, v, a, m0t, m_halft, fst, n_steps, *, G, eps, dt,
                 integrator, compensated):
    """simulate's float32 loop before the step kernel, as it was: eager
    ops around kernel B2's wrapper, fst host floats, the constants rounded
    to float32 first."""

    def comp(x, c, d):
        y = d - c
        t = x + y
        return t, (t - x) - y

    if compensated:
        qc, vc = torch.zeros_like(q), torch.zeros_like(v)
        kick, drift = scalar(0.5 * dt, q.dtype), scalar(dt, q.dtype)
    for s in range(1, n_steps + 1):
        m_eff = m0t + m_halft * fst[s]
        if integrator == "leapfrog" and compensated:
            v, vc = comp(v, vc, a * kick)
            q, qc = comp(q, qc, v * drift)
            a = accel(q, m_eff, G=G, eps=eps)
            v, vc = comp(v, vc, a * kick)
        elif integrator == "leapfrog":
            q, v, a = kdk_leapfrog_step(q, v, a, m_eff, G=G, eps=eps, dt=dt)
        elif compensated:
            a = accel(q, m_eff, G=G, eps=eps)
            v, vc = comp(v, vc, a * drift)
            q, qc = comp(q, qc, v * drift)
        else:
            q, v = symplectic_euler_step(q, v, m_eff, G=G, eps=eps, dt=dt)
    return q, v


# --- the plain version on the CPU -------------------------------------------

@pytest.mark.parametrize("chunk", [1, 7, STEPS])
@pytest.mark.parametrize("devices_on", [True, False])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_ref_bitwise_equal_to_parent_eager_loop(integrator, compensated,
                                                devices_on, chunk):
    c, m0, m_half, fst, kw, _ = _setup(_scene(), STEPS, integrator,
                                       compensated, devices_on)
    q0, v0, a0 = c.q, c.v, c.a
    _run(ss.sim_chunk_f32_ref, c, m0, m_half, fst, STEPS, chunk, **kw)
    q, v = _parent_loop(q0, v0, a0, m0, m_half, fst.tolist(), STEPS, **kw)
    assert c.q.dtype == F32
    assert torch.equal(c.q, q) and torch.equal(c.v, v)


@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_ref_matches_jax_f32(integrator, compensated):
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.io import Scene as JaxScene
    from nbody_tpu.simulate import simulate as jax_simulate

    scene = _scene(2)
    jscene = JaxScene(**{f.name: getattr(scene, f.name)
                         for f in dataclasses.fields(scene)})
    want = jax_simulate(jscene, JaxSimConfig(), platform="cpu",
                        n_steps=STEPS, precision="f32",
                        integrator=integrator, compensated=compensated,
                        chunk=16)
    c, m0, m_half, fst, kw, inv = _setup(scene, STEPS, integrator,
                                         compensated)
    _run(ss.sim_chunk_f32_ref, c, m0, m_half, fst, STEPS, 16, **kw)
    for g, w in ((c.q, want.q), (c.v, want.v)):
        g = g.numpy().astype(np.float64) * inv
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def _kernel_emulation(c, m0, m_half, fst, s0, s1, *, G, eps, dt,
                      integrator, compensated):
    """csrc/sim_step_f32.cu's control flow in PyTorch ops, each one op as
    the kernel's intrinsics round it, every constant a float32 value: the
    state buffer's slots over a ping-pong pair, sim_pre_kernel on the
    first buffer, then each step's force from the slots p (leapfrog) or q
    and gm, its update, and what it forms for step t + 1 unless t ends the
    chunk."""
    Q, V, A, QC, VC, P, VH, PC, VHC, GM = range(ss.SLOTS)
    n = c.q.shape[0]
    G, kick, dt = scalar(G, F32), scalar(0.5 * dt, F32), scalar(dt, F32)
    st = torch.full((2, ss.SLOTS, n, 3), float("nan"), dtype=F32)
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
        acc = accel_f32_ref(pos, pos, src[GM, :, 0].contiguous(), eps=eps)
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
    got, m0, m_half, fst, kw, _ = _setup(scene, 9, integrator, compensated)
    want, *_ = _setup(scene, 9, integrator, compensated)
    for s0, s1 in chunks:
        _kernel_emulation(got, m0, m_half, fst, s0, s1, **kw)
        ss.sim_chunk_f32_ref(want, m0, m_half, fst, s0, s1, **kw)
    _equal(got, want)


@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_checkpoint_at_half_resumes_bitwise(tmp_path, integrator,
                                            compensated):
    """The carry saved at half the run (utils.checkpoint, the rest of the
    carry as extra arrays) and resumed through the chunk function: bitwise
    the run that never stopped."""
    scene = _scene(5)
    whole, m0, m_half, fst, kw, _ = _setup(scene, STEPS, integrator,
                                           compensated)
    _run(ss.sim_chunk_f32, whole, m0, m_half, fst, STEPS, 20, **kw)

    half, *_ = _setup(scene, STEPS, integrator, compensated)
    _run(ss.sim_chunk_f32, half, m0, m_half, fst, STEPS // 2, 20, **kw)
    path = str(tmp_path / "ck.npz")
    extra = {k: getattr(half, k).numpy() for k in ("a", "qc", "vc")
             if getattr(half, k) is not None}
    save_checkpoint(path, step=STEPS // 2, q=half.q.numpy(),
                    v=half.v.numpy(), extra=extra)
    step, q, v, extra, _ = load_checkpoint(path)
    resumed = ss.SimCarry(torch.from_numpy(q), torch.from_numpy(v),
                          **{k: torch.from_numpy(x)
                             for k, x in extra.items()})
    assert resumed.q.dtype == F32
    for s0 in range(step, STEPS, 20):
        ss.sim_chunk_f32(resumed, m0, m_half, fst, s0,
                         min(s0 + 20, STEPS), **kw)
    _equal(resumed, whole)


def test_fst_table_and_constants_hold_the_host_floats():
    """The kernel reads the oscillation table from a float32 device table
    where the eager loop multiplies by host floats, and takes G, dt, dt / 2
    and eps^2 as float32 arguments where the eager loop rounds each to
    float32 first: the same values, bit for bit."""
    table = oscillation_table(CFG, 2000).astype(np.float32)
    floats = table.tolist()
    t = torch.from_numpy(table)
    assert t.dtype == F32
    assert all(float(t[s]) == floats[s] for s in range(0, 2001, 97))
    for x in (CFG.G, CFG.dt, 0.5 * CFG.dt, CFG.eps * CFG.eps):
        assert float(np.float32(scalar(x, F32))) == scalar(x, F32)
    assert eps2_f32(CFG.eps) == scalar(CFG.eps * CFG.eps, F32)


# --- routing ---------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
@pytest.mark.parametrize("compensated", [True, False])
def test_simulate_routes_f32_to_the_step_kernel(monkeypatch, device,
                                                integrator, compensated):
    """One-device f32 goes to sim_chunk_f32 once a chunk, kernel B2's
    wrapper only for the leapfrog seed; with device='cuda' (the device
    resolved to the CPU here, as no card is present) the same."""
    sim_module = sys.modules["nbody_tpu_torch.simulate"]
    chunks, b2 = [], []
    real_chunk = sim_module.sim_chunk_f32

    def chunk_spy(c, m0, m_half, fst, s0, s1, **kw):
        assert c.q.dtype == fst.dtype == F32
        assert (c.qc is not None) == compensated
        chunks.append((s0, s1))
        return real_chunk(c, m0, m_half, fst, s0, s1, **kw)

    from nbody_tpu_torch.ops import integrate

    real_b2 = integrate.accel_f32_self

    def b2_spy(*args, **kw):
        b2.append(1)
        return real_b2(*args, **kw)

    monkeypatch.setattr(sim_module, "sim_chunk_f32", chunk_spy)
    monkeypatch.setattr(integrate, "accel_f32_self", b2_spy)
    monkeypatch.setattr(sim_module, "resolve_device",
                        lambda name: torch.device("cpu"))
    simulate(_scene(6), CFG, n_steps=12, precision="f32", device=device,
             integrator=integrator, compensated=compensated, chunk=5)
    assert chunks == [(0, 5), (5, 10), (10, 12)]
    assert len(b2) == (integrator == "leapfrog")


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
def test_mesh_runs_the_ordered_ring_not_the_step_kernel(shape):
    """Since the mesh's row-range step kernels, the name's old route is
    gone: an Euler f32 simulate on the mesh makes one call of the float32
    step kernel's row-range chunk and runs neither the ordered ring nor
    the one-device chunk."""
    import torch_mesh_workers as W
    from nbody_tpu_torch.parallel.spawn import run_ranks

    out = run_ranks(W.simulate_step_routes, int(np.prod(shape)),
                    ({"scen": shape[0], "body": shape[1]}, _scene(7), 6,
                     "f32"), timeout=120)
    for counts in out:
        assert counts == {"sim_rows_chunk_f32": 1}


# --- the wrapper's refusals ------------------------------------------------

def _good(integrator="euler", compensated=False):
    c, m0, m_half, fst, kw, _ = _setup(_scene(8, 5), 4, integrator,
                                       compensated)
    return c, m0, m_half, fst, kw


REFUSALS = {
    "float64 state": (TypeError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, q=c.q.double()), m0, mh, fst, 0, 2, {})),
    "float64 masses": (TypeError, lambda c, m0, mh, fst: (
        c, m0.double(), mh, fst, 0, 2, {})),
    "float64 table": (TypeError, lambda c, m0, mh, fst: (
        c, m0, mh, fst.double(), 0, 2, {})),
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
    "non-contiguous": (ValueError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, q=c.q.t().contiguous().t()), m0, mh, fst, 0,
        2, {})),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses(case):
    err, make = REFUSALS[case]
    c, m0, mh, fst, kw0 = _good()
    c, m0, mh, fst, s0, s1, kw = make(c, m0, mh, fst)
    before = ss.sim_chunk_f32.launches
    with pytest.raises(err):
        ss.sim_chunk_f32(c, m0, mh, fst, s0, s1, **{**kw0, **kw})
    assert ss.sim_chunk_f32.launches == before


def test_build_digest_covers_the_new_sources(tmp_path, monkeypatch):
    """sim_step_f32.cu is compiled, and an edit to it, to kernel B2's
    block force (f32_force.cuh) or to the steps' shared update
    (sim_step.cuh) rebuilds the library."""
    import shutil

    assert "sim_step_f32.cu" in _build.SOURCES
    names = ("f32_force.cuh", "sim_step.cuh", "sim_step_f32.cu")
    assert set(names) <= set(os.listdir(_build.CSRC))
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    digest = _build.source_digest()
    for name in names:
        path = csrc / name
        path.write_text(path.read_text() + "\n")
        edited = _build.source_digest()
        assert edited != digest
        digest = edited


# --- on a card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 64, 1000, 40000])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_kernel_bitwise_equal_to_ref_and_eager_b2_on_card(
        cuda, integrator, compensated, n):
    """The kernel against its plain version on the card and the eager loop
    around kernel B2, in B2's small block shape (n up to 33664 at B=1)
    and its large one (n = 40000)."""
    scene = _scene(9, n)
    got, m0, m_half, fst, kw, _ = _setup(scene, 7, integrator, compensated,
                                         device=cuda)
    want = dataclasses.replace(got)
    eager = dataclasses.replace(got)
    before = ss.sim_chunk_f32.launches
    for s0, s1 in ((0, 1), (1, 4), (4, 7)):
        ss.sim_chunk_f32(got, m0, m_half, fst, s0, s1, **kw)
        if n <= 1000:
            ss.sim_chunk_f32_ref(want, m0, m_half, fst, s0, s1, **kw)
        ss.eager_chunk(eager, m0, m_half, fst.tolist(), s0, s1, **kw)
    torch.cuda.synchronize()
    # three chunks: one persistent launch each up to 8192 bodies, above
    # it the pre-launch and one a step (7 steps)
    assert ss.sim_chunk_f32.launches == before + (3 if n <= 8192 else 7 + 3)
    _equal(got, eager)
    if n <= 1000:
        _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_simulate_on_card_bitwise_invariant_to_chunk(cuda, integrator,
                                                     compensated):
    scene = _scene(10, 300)
    runs = [simulate(scene, CFG, n_steps=40, precision="f32", device="cuda",
                     integrator=integrator, compensated=compensated,
                     chunk=chunk) for chunk in (1, 13, 40)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.q, runs[0].q)
        np.testing.assert_array_equal(r.v, runs[0].v)
