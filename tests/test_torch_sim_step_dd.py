"""simulate()'s double-double step kernel (precisions 'tf3', 'ddp', 'dd+'):
its plain version and its wrapper on the CPU (ops/sim_step.py), and the
kernel on a card.

On the CPU:
  * `sim_chunk_dd_ref` bitwise equal to simulate's double-double loop as
    it stood before the step kernel (a copy of that loop below: eager
    ops/ddfloat ops around kernel B4's wrapper), for Euler and leapfrog,
    devices on and off, in chunks of 1, 7 and 25 steps;
  * within 1e-20 of the peak of JAX `simulate(precision='tf3',
    platform='cpu')` beyond binary64, and at least 100x closer than
    binary64 is, the tolerance tests/test_torch_tf3.py holds 'tf3' to;
  * an emulation of the kernel's control flow in PyTorch ops (the state
    buffer's slots, the chunk's first launch that forms gm and the
    leapfrog's kick and drift, each step's update and what it forms for
    the next step) bitwise equal to the plain version;
  * a run stopped at half its steps, its carry saved and loaded, and
    resumed, bitwise equal to the run that never stopped;
  * simulate routes one-device 'tf3', 'ddp' and 'dd+' (also when asked
    for 'cuda') to the wrapper, kernel B4's own wrapper only for the
    leapfrog's seed; the mesh to the row-range form of the step kernel;
  * the wrapper's refusals, and the build covering the new sources.
On a card (marked `cuda`, skipped here) the kernel is held bitwise against
the plain version on the card and the eager loop around kernel B4:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sim_step_dd.py
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from nbody_tpu_torch import SimConfig, simulate
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import ddfloat as ddf
from nbody_tpu_torch.ops import sim_step as ss
from nbody_tpu_torch.ops.accel_dd import accel_dd_ref
from nbody_tpu_torch.ops.integrate import accel_dd_state, \
    kdk_leapfrog_step_dd, symplectic_euler_step_dd
from nbody_tpu_torch.physics import oscillation_table
from nbody_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from test_fuzz_differential import _fuzz_scene
from test_torch_sim_step import _equal, _run, _scene, cuda  # noqa: F401
from test_torch_tf3 import _err, _port, jax_tf3  # noqa: F401 (a fixture)

CFG = SimConfig()
STEPS = 25
N = 12            # bodies of the plain double-double runs
JAX_TOL = 1e-20


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small tensor ops a step: one thread runs them many
    times faster than torch's default pool on this host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dd(x, device="cpu"):
    return ddf.from_f64(np.asarray(x, np.float64)).to(device)


def _setup(scene, n_steps, integrator, devices_on=True, device="cpu"):
    """simulate's double-double run of the scene: the masses (n, 2) and
    the binary64 table as tensors, the carry at step 0 (the leapfrog
    seeded with the first step's masses through kernel B4's wrapper) and
    the chunk functions' keywords."""
    mask = scene.device_mask()
    m0 = scene.m * (1.0 if devices_on else (1.0 - mask))
    m0t, mht = _dd(m0, device), _dd(0.5 * m0 * mask, device)
    table = oscillation_table(CFG, n_steps)
    fst = torch.from_numpy(table).to(device)
    c = ss.SimCarry(_dd(scene.q, device), _dd(scene.v, device))
    if integrator == "leapfrog":
        c.a = accel_dd_state(c.q, ss.m_eff_dd(m0t, mht, float(table[1])),
                             G=CFG.G, eps=CFG.eps)
    kw = {"G": CFG.G, "eps": CFG.eps, "dt": CFG.dt, "integrator": integrator}
    return c, m0t, mht, fst, kw


def _parent_loop(q, v, a, m0, m_half, fst, n_steps, *, G, eps, dt,
                 integrator):
    """simulate's double-double loop before the step kernel, as it was:
    eager ops/ddfloat ops around kernel B4's wrapper, fst host floats."""
    m0t, m_halft = ddf.split(m0), ddf.split(m_half)

    def m_eff(s: int) -> torch.Tensor:
        return ddf.join(ddf.add(m0t, ddf.mul(m_halft, ddf.const(fst[s]))))

    for s in range(1, n_steps + 1):
        if integrator == "leapfrog":
            q, v, a = kdk_leapfrog_step_dd(q, v, a, m_eff(s), G=G, eps=eps,
                                           dt=dt)
        else:
            q, v = symplectic_euler_step_dd(q, v, m_eff(s), G=G, eps=eps,
                                            dt=dt)
    return q, v


# --- the plain version on the CPU -------------------------------------------

@pytest.mark.parametrize("chunk", [1, 7, STEPS])
@pytest.mark.parametrize("devices_on", [True, False])
@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
def test_ref_bitwise_equal_to_parent_eager_loop(integrator, devices_on,
                                                chunk):
    c, m0, m_half, fst, kw = _setup(_scene(1, N), STEPS, integrator, devices_on)
    q0, v0, a0 = c.q, c.v, c.a
    _run(ss.sim_chunk_dd_ref, c, m0, m_half, fst, STEPS, chunk, **kw)
    q, v = _parent_loop(q0, v0, a0, m0, m_half, fst.tolist(), STEPS, **kw)
    assert c.q.shape == (N, 3, 2)
    assert torch.equal(c.q, q) and torch.equal(c.v, v)


@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
def test_ref_matches_jax_tf3(jax_tf3, integrator):
    """jax_tf3 (tests/test_torch_tf3.py): JAX simulate 'tf3' on fuzz scene
    0, its final q and v as exact double-double."""
    scene = _port(_fuzz_scene(0))
    c, m0, m_half, fst, kw = _setup(scene, STEPS, integrator)
    f64 = simulate(scene, n_steps=STEPS, precision="f64", device="cpu",
                   integrator=integrator)
    _run(ss.sim_chunk_dd_ref, c, m0, m_half, fst, STEPS, 10, **kw)
    for x, want, x64 in ((c.q, jax_tf3[integrator][0], f64.q),
                         (c.v, jax_tf3[integrator][1], f64.v)):
        e = _err(ddf.split(x), want)
        assert e <= JAX_TOL
        assert _err(ddf.split(ddf.from_f64(x64)), want) >= 100 * e


def _kernel_emulation(c, m0, m_half, fst, s0, s1, *, G, eps, dt,
                      integrator):
    """csrc/sim_step_dd.cu's control flow in PyTorch ops, each the
    double-double op of csrc/dd.cuh: the state buffer's slots over a
    ping-pong pair, sim_pre_kernel on the first buffer, then each step's
    force from the slots p (leapfrog) or q and gm, its update, and what it
    forms for step t + 1 unless t ends the chunk."""
    Q, V, A, QC, VC, P, VH, PC, VHC, GM = range(ss.SLOTS)
    n = c.q.shape[0]
    st = torch.full((2, ss.SLOTS, n, 3, 2), float("nan"),
                    dtype=torch.float64)
    for slot, x in enumerate((c.q, c.v, c.a)):
        if x is not None:
            st[0, slot] = x
    f = fst.tolist()

    def axpy(x, a, h):        # x + a*h, the kernel's rn_add(x, rn_mul(a, h))
        return ddf.join(ddf.add(ddf.split(x),
                                ddf.mul(ddf.split(a), ddf.const(h))))

    def form(buf, t, q, v, acc):
        m_eff = ddf.add(ddf.split(m0), ddf.mul(ddf.split(m_half),
                                               ddf.const(f[t])))
        buf[GM, :, 0] = ddf.join(ddf.mul(m_eff, ddf.const(G)))
        if integrator == "leapfrog":
            buf[VH] = axpy(v, acc, 0.5 * dt)
            buf[P] = axpy(q, buf[VH], dt)

    b0 = st[0]
    form(b0, s0 + 1, b0[Q], b0[V], b0[A])
    for t in range(s0 + 1, s1 + 1):
        src, out = st[(t - s0 - 1) & 1], st[(t - s0) & 1]
        lf = integrator == "leapfrog"
        pos = src[P] if lf else src[Q]
        acc = accel_dd_ref(pos[None], pos[None],
                           src[GM, :, 0][None].contiguous(), eps=eps)[0]
        q, v = pos, src[VH] if lf else src[V]
        out[V] = axpy(v, acc, 0.5 * dt if lf else dt)
        if lf:
            out[Q], out[A] = q, acc
        else:
            out[Q] = axpy(q, out[V], dt)
        if t < s1:
            form(out, t + 1, out[Q], out[V], out[A])
    end = st[(s1 - s0) & 1]
    c.q, c.v = end[Q].clone(), end[V].clone()
    if c.a is not None:
        c.a = end[A].clone()


@pytest.mark.parametrize("chunks", [[(0, 1), (1, 2), (2, 9)], [(0, 9)]])
@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
def test_kernel_control_flow_bitwise_equal_to_ref(integrator, chunks):
    scene = _scene(4, N)
    got, m0, m_half, fst, kw = _setup(scene, 9, integrator)
    want = dataclasses.replace(got)
    for s0, s1 in chunks:
        _kernel_emulation(got, m0, m_half, fst, s0, s1, **kw)
        ss.sim_chunk_dd_ref(want, m0, m_half, fst, s0, s1, **kw)
    _equal(got, want)


@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
def test_checkpoint_at_half_resumes_bitwise(tmp_path, integrator):
    """The carry saved at half the run (utils.checkpoint, the leapfrog's a
    as an extra array; every array keeps its (hi, lo) pairs) and resumed
    through the chunk function: bitwise the run that never stopped."""
    scene = _scene(5, N)
    whole, m0, m_half, fst, kw = _setup(scene, STEPS, integrator)
    _run(ss.sim_chunk_dd, whole, m0, m_half, fst, STEPS, 10, **kw)

    half, *_ = _setup(scene, STEPS, integrator)
    _run(ss.sim_chunk_dd, half, m0, m_half, fst, 12, 10, **kw)
    path = str(tmp_path / "ck.npz")
    extra = {"a": half.a.numpy()} if half.a is not None else None
    save_checkpoint(path, step=12, q=half.q.numpy(), v=half.v.numpy(),
                    extra=extra)
    step, q, v, extra, _ = load_checkpoint(path)
    resumed = ss.SimCarry(torch.from_numpy(q), torch.from_numpy(v),
                          **{k: torch.from_numpy(x)
                             for k, x in (extra or {}).items()})
    for s0 in range(step, STEPS, 10):
        ss.sim_chunk_dd(resumed, m0, m_half, fst, s0, min(s0 + 10, STEPS),
                        **kw)
    _equal(resumed, whole)


def test_host_constants_and_table_are_binary64_pairs():
    """The kernel takes G, dt, dt / 2 and the table's values as (x, 0)
    pairs of binary64 values, as the eager loop's ddfloat.const does, and
    eps^2 as two_prod(eps, eps)."""
    from nbody_tpu_torch.ops.accel_dd import eps2_dd

    table = oscillation_table(CFG, 500)
    t = torch.from_numpy(table)
    assert t.dtype == torch.float64
    assert all(ddf.const(float(t[s])) == (table.tolist()[s], 0.0)
               for s in range(0, 501, 37))
    hi, lo = eps2_dd(CFG.eps)
    assert hi == CFG.eps * CFG.eps and (hi, lo) == tuple(
        ddf.two_prod(CFG.eps, CFG.eps))


# --- routing ---------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("precision", ["tf3", "ddp", "dd+"])
@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
def test_simulate_routes_double_double_to_the_step_kernel(
        monkeypatch, device, precision, integrator):
    """One-device double-double goes to sim_chunk_dd once a chunk, kernel
    B4's wrapper only for the leapfrog seed; with device='cuda' (the
    device resolved to the CPU here, as no card is present) the same."""
    sim_module = sys.modules["nbody_tpu_torch.simulate"]
    chunks, b4 = [], []
    real_chunk = sim_module.sim_chunk_dd

    def chunk_spy(c, m0, m_half, fst, s0, s1, **kw):
        assert c.q.shape[-1] == 2 and fst.dtype == torch.float64
        chunks.append((s0, s1))
        return real_chunk(c, m0, m_half, fst, s0, s1, **kw)

    from nbody_tpu_torch.ops import integrate

    real_b4 = integrate.accel_dd

    def b4_spy(*args, **kw):
        b4.append(1)
        return real_b4(*args, **kw)

    monkeypatch.setattr(sim_module, "sim_chunk_dd", chunk_spy)
    monkeypatch.setattr(integrate, "accel_dd", b4_spy)
    monkeypatch.setattr(sim_module, "resolve_device",
                        lambda name: torch.device("cpu"))
    out = simulate(_scene(6, 8), CFG, n_steps=12, precision=precision,
                   device=device, integrator=integrator, chunk=5)
    assert chunks == [(0, 5), (5, 10), (10, 12)]
    assert len(b4) == (integrator == "leapfrog")
    assert out.q_lo is not None


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
def test_mesh_runs_b4_cross_form_not_the_step_kernel(shape):
    """Since the mesh's row-range step kernels, the name's old route is
    gone: a tf3 Euler simulate on the mesh makes one call of the
    double-double step kernel's row-range chunk, and no B4 cross form
    from simulate itself nor the one-device chunk."""
    import torch_mesh_workers as W
    from nbody_tpu_torch.parallel.spawn import run_ranks

    out = run_ranks(W.simulate_step_routes, int(np.prod(shape)),
                    ({"scen": shape[0], "body": shape[1]}, _scene(7, 8), 4,
                     "tf3"), timeout=120)
    for counts in out:
        assert counts == {"sim_rows_chunk_dd": 1}


# --- the wrapper's refusals ------------------------------------------------

def _good(integrator="euler"):
    return _setup(_scene(8, 5), 4, integrator)


REFUSALS = {
    "float32 state": (TypeError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, q=c.q.float()), m0, mh, fst, 0, 2, {})),
    "float32 table": (TypeError, lambda c, m0, mh, fst: (
        c, m0, mh, fst.float(), 0, 2, {})),
    "binary64 state": (ValueError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, q=c.q[..., 0].contiguous(),
                            v=c.v[..., 0].contiguous()), m0, mh, fst, 0, 2,
        {})),
    "binary64 masses": (ValueError, lambda c, m0, mh, fst: (
        c, m0[..., 0].contiguous(), mh, fst, 0, 2, {})),
    "masses of another n": (ValueError, lambda c, m0, mh, fst: (
        c, m0[:-1], mh, fst, 0, 2, {})),
    "steps past the table": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 2, 5, {})),
    "no steps": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 2, 2, {})),
    "leapfrog without a": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 0, 2, {"integrator": "leapfrog"})),
    "a compensation": (ValueError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, qc=torch.zeros_like(c.q),
                            vc=torch.zeros_like(c.v)), m0, mh, fst, 0, 2,
        {})),
    "unknown integrator": (ValueError, lambda c, m0, mh, fst: (
        c, m0, mh, fst, 0, 2, {"integrator": "rk4"})),
    "non-contiguous": (ValueError, lambda c, m0, mh, fst: (
        dataclasses.replace(c, q=c.q.transpose(0, 1).contiguous()
                            .transpose(0, 1)), m0, mh, fst, 0, 2, {})),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses(case):
    err, make = REFUSALS[case]
    c, m0, mh, fst, kw0 = _good()
    c, m0, mh, fst, s0, s1, kw = make(c, m0, mh, fst)
    before = ss.sim_chunk_dd.launches
    with pytest.raises(err):
        ss.sim_chunk_dd(c, m0, mh, fst, s0, s1, **{**kw0, **kw})
    assert ss.sim_chunk_dd.launches == before


def test_build_digest_covers_the_new_sources(tmp_path, monkeypatch):
    """sim_step_dd.cu is compiled, and an edit to it, to kernel B4's block
    force (dd_force.cuh) or to the steps' shared update (sim_step.cuh)
    rebuilds the library."""
    import shutil

    assert "sim_step_dd.cu" in _build.SOURCES
    names = ("dd_force.cuh", "sim_step.cuh", "sim_step_dd.cu")
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
@pytest.mark.parametrize("n", [5, 63, 1000])
@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
def test_kernel_bitwise_equal_to_ref_and_eager_b4_on_card(cuda, integrator,
                                                          n):
    got, m0, m_half, fst, kw = _setup(_scene(9, n), 7, integrator,
                                      device=cuda)
    want = dataclasses.replace(got)
    eager = dataclasses.replace(got)
    before = ss.sim_chunk_dd.launches
    for s0, s1 in ((0, 1), (1, 4), (4, 7)):
        ss.sim_chunk_dd(got, m0, m_half, fst, s0, s1, **kw)
        ss.sim_chunk_dd_ref(want, m0, m_half, fst, s0, s1, **kw)
        ss.eager_chunk_dd(eager, m0, m_half, fst.tolist(), s0, s1, **kw)
    torch.cuda.synchronize()
    assert ss.sim_chunk_dd.launches == before + 7 + 3
    _equal(got, want)
    _equal(got, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ss.INTEGRATORS)
def test_simulate_on_card_bitwise_invariant_to_chunk(cuda, integrator):
    scene = _scene(10, 300)
    runs = [simulate(scene, CFG, n_steps=40, precision="tf3", device="cuda",
                     integrator=integrator, chunk=chunk)
            for chunk in (1, 13, 40)]
    for r in runs[1:]:
        for f in ("q", "v", "q_lo", "v_lo"):
            np.testing.assert_array_equal(getattr(r, f), getattr(runs[0], f))
