"""Rank functions of the port's mesh tests (tests/test_torch_mesh.py,
test_torch_solver_sharded.py, test_torch_simulate_mesh.py).

Each runs inside one gloo rank started by
`nbody_tpu_torch.parallel.spawn.run_ranks`, so this module imports no JAX
and nothing that does: the ranks start light. Each takes the mesh's
shape and a list of jobs, runs them all on one mesh and returns plain
Python values and numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def fuzz_scene(seed: int, n: int, n_devices: int):
    """A scene built like tests/test_fuzz_differential.py::_fuzz_scene (the
    same draws in the same order) with n bodies and n_devices devices;
    chip_smoke.py builds its graded scenes so too."""
    from nbody_tpu_torch.io import Scene

    rng = np.random.RandomState(seed)
    q = rng.randn(n, 3) * 10.0 ** rng.uniform(9, 11)
    v = rng.randn(n, 3) * 10.0 ** rng.uniform(2, 4)
    m = np.abs(rng.randn(n)) * 10.0 ** rng.uniform(20, 26, size=n)
    planet, asteroid = 0, 1
    m[planet] = 10.0 ** rng.uniform(24, 26)
    m[asteroid] = 10.0 ** rng.uniform(20, 23)
    q[planet] = rng.randn(3) * 1e9
    sep_dir = rng.randn(3)
    sep_dir /= np.linalg.norm(sep_dir)
    dist = 10.0 ** rng.uniform(8.5, 10.5)
    q[asteroid] = q[planet] + sep_dir * dist
    steps_to_close = rng.uniform(30, 400 if seed % 2 else 150)
    speed = dist / (steps_to_close * 60.0)
    v[asteroid] = -sep_dir * speed
    lat = rng.randn(3)
    lat -= lat @ sep_dir * sep_dir
    lat /= np.linalg.norm(lat)
    v[asteroid] += lat * speed * (rng.uniform(0.0, 3e7) / dist)
    v[planet] = rng.randn(3) * 1e2
    device_idx = []
    for k in range(n_devices):
        i = 2 + k
        device_idx.append(i)
        ddir = rng.randn(3)
        ddir /= np.linalg.norm(ddir)
        q[i] = q[planet] + ddir * 10.0 ** rng.uniform(8.3, 9.8)
        v[i] = v[planet] + rng.randn(3) * 1e2
        m[i] = 10.0 ** rng.uniform(25.5, 28)
    types = (["planet", "asteroid"] + ["device"] * n_devices
             + ["star"] * (n - 2 - n_devices))
    return Scene(n=n, planet=planet, asteroid=asteroid, q=q, v=v, m=m,
                 types=types, device_idx=np.asarray(device_idx, np.int64))


def _mesh(axes: dict):
    from nbody_tpu_torch.parallel import make_mesh

    return make_mesh(axes, device="cpu")


def solve_jobs(axes: dict, jobs: list) -> dict:
    """{label: answers tuple} of graded solves on one mesh; a job is
    (label, scene, n_steps, precision, tile, checkpoint path or None)."""
    from nbody_tpu_torch import SimConfig, solve_scene

    mesh = _mesh(axes)
    out = {}
    for label, scene, n_steps, precision, tile, ck in jobs:
        out[label] = solve_scene(scene, SimConfig(n_steps=n_steps),
                                 precision=precision, mesh=mesh, tile=tile,
                                 checkpoint_path=ck).as_tuple()
    return out


def drivers_jobs(axes: dict, scene, n_steps: int,
                 precisions: tuple) -> dict:
    """{precision: the mesh's P1+P2 result (host arrays) and Problem-3
    flags}, binary64 ('f64') or double-double ('tf3'): the drivers of
    models/direct_sum on the mesh's layout."""
    from nbody_tpu_torch import SimConfig
    from nbody_tpu_torch.models.direct_sum import DD, run_problem_3, \
        run_problems_12
    from nbody_tpu_torch.parallel.solver_sharded import Layout
    from nbody_tpu_torch.physics import oscillation_table

    import torch

    mesh = _mesh(axes)
    cfg = SimConfig(n_steps=n_steps)
    fst = oscillation_table(cfg)
    out = {}
    for precision in precisions:
        dtype = {"f64": torch.float64, "tf3": DD}[precision]
        layout = Layout(mesh, scene.n, dtype)
        p12 = run_problems_12(scene, fst, cfg, layout=layout, dtype=dtype)
        saved = run_problem_3(scene, p12, fst, cfg, layout=layout,
                              dtype=dtype)
        out[precision] = {
            "min_dist": p12.min_dist, "hit": p12.hit_time_step,
            "arrivals": p12.arrivals, "q_snaps": p12.q_snaps.numpy(),
            "v_snaps": p12.v_snaps.numpy(), "saved": saved}
    return out


def simulate_jobs(axes: dict, jobs: list) -> dict:
    """{label: (q, v, q_lo, steps seen by on_chunk)} of simulate() runs on
    one mesh; a job is (label, scene, kwargs)."""
    from nbody_tpu_torch import simulate

    mesh = _mesh(axes)
    out = {}
    for label, scene, kw in jobs:
        seen = []
        st = simulate(scene, mesh=mesh,
                      on_chunk=lambda s: seen.append(s.step), **kw)
        out[label] = (st.q, st.v, st.q_lo, seen)
    return out


def simulate_step_routes(axes: dict, scene, n_steps: int,
                         precision: str) -> dict:
    """Calls on this rank of the step kernels' wrappers, one-device and
    row-range, of the force kernels' wrappers that simulate calls itself
    (the mesh's leapfrog seed) and of the ordered ring, in a `precision`
    Euler simulate() of n_steps on one mesh; the wrappers that were never
    called are left out."""
    import sys

    from nbody_tpu_torch import simulate
    from nbody_tpu_torch.parallel import sharded

    sim_module = sys.modules["nbody_tpu_torch.simulate"]
    counts = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    for name in ("sim_chunk_f64", "sim_chunk_f32", "sim_chunk_dd",
                 "sim_rows_chunk_f64", "sim_rows_chunk_f32",
                 "sim_rows_chunk_dd", "accel_f64", "accel_f32_ordered",
                 "accel_dd"):
        setattr(sim_module, name, spy(name, getattr(sim_module, name)))
    sharded.ring_accel_ordered = spy("ring_accel_ordered",
                                     sharded.ring_accel_ordered)
    simulate(scene, mesh=_mesh(axes), n_steps=n_steps, precision=precision)
    return counts


def ring_jobs(axes: dict, q: np.ndarray, v: np.ndarray, m: np.ndarray,
              G: float, eps: float, dt: float, m_half: np.ndarray,
              fst: np.ndarray) -> dict:
    """The ring functions of parallel/sharded.py on this rank's shards,
    gathered: ring_pairwise_accel in float32 and float64, ring_accel_ordered
    at its default tile, one make_sharded_step with the batch rows over
    'scen' (q (S, n, 3)), and simulate_sharded with oscillating masses and
    on_chunk."""
    import torch
    import torch.distributed as dist

    from nbody_tpu_torch.parallel import (make_sharded_step,
                                          ring_accel_ordered,
                                          ring_pairwise_accel,
                                          simulate_sharded)
    from nbody_tpu_torch.parallel.mesh import axis
    from nbody_tpu_torch.parallel.sharded import all_gather

    mesh = _mesh(axes)
    group, bi, k = axis(mesh, "body")
    _, si, _ = axis(mesh, "scen")
    n = q.shape[-2]
    rows = slice(bi * (n // k), (bi + 1) * (n // k))
    out = {}
    for dtype in (np.float32, np.float64):
        ql = torch.from_numpy(q[0, rows].astype(dtype))
        gm = torch.from_numpy((m[0, rows] * G).astype(dtype))
        a = ring_pairwise_accel(ql, gm, group=group, eps=eps)
        out[np.dtype(dtype).name] = all_gather(a, group, k).flatten(
            0, 1).numpy()
    ql = torch.from_numpy(q[0, rows].astype(np.float32))
    gm = torch.from_numpy((m[0, rows] * G).astype(np.float32))
    a = ring_accel_ordered(ql, gm, group=group, eps=eps)      # tile 128
    out["ordered128"] = all_gather(a, group, k).flatten(0, 1).numpy()
    step = make_sharded_step(mesh, G=G, eps=eps, dt=dt)
    ql, vl, ml = (torch.from_numpy(x[si:si + 1, rows].astype(np.float32))
                  for x in (q, v, m))
    q1, v1 = step(ql, vl, ml)
    out["step_q"] = all_gather(q1[0], group, k).flatten(0, 1).numpy()
    out["step_v"] = all_gather(v1[0], group, k).flatten(0, 1).numpy()
    seen = []
    qs, vs = simulate_sharded(
        q[0].astype(np.float32), v[0].astype(np.float32),
        m[0].astype(np.float32), 6, mesh, G=G, eps=eps, dt=dt,
        m_half=m_half.astype(np.float32), fst=fst, chunk=4,
        on_chunk=lambda s, qh, vh: seen.append((s, qh.shape)))
    out.update(sim_q=qs.numpy(), sim_v=vs.numpy(), seen=seen,
               rank=dist.get_rank())
    return out


def cli_jobs(axes: dict, argv_list: list) -> list:
    """The CLI's return codes over a mesh of these ranks (each argv gets
    --mesh and --device cpu)."""
    from nbody_tpu_torch.cli import main

    spec = ",".join(f"{k}={v}" for k, v in axes.items())
    return [main(list(argv) + ["--mesh", spec, "--device", "cpu"])
            for argv in argv_list]


def scene_fields(scene) -> dict:
    """A scene as a dict (what a test hands the JAX package)."""
    return {f.name: getattr(scene, f.name)
            for f in dataclasses.fields(scene)}


class FakeSimLib:
    """A stand-in for the kernel library's simulate entry points on the
    CPU: `sim_rows_f64_step` and `sim_rows_f32_step` emulate the step
    kernels' row-range form (csrc/sim_step.cuh) in PyTorch ops on the
    buffers their pointers name (the CPU tensors' own memory), the step
    t = t0 + off with t0 read through the pointer of the chunk's base-step
    word, so that ops/sim_step's host loop around them (slots, ping-pong,
    pre-launch, gathers, the carry's read-back) runs on gloo ranks. Each
    op is the eager loop's; the force is the plain cross form on the rows
    (float32: the ordered sum at the tile). `calls` records each launch
    as (r0, t, next, pre-launch, in, out)."""

    def __init__(self, eps: float, dist3: str = "dsqrt"):
        self.eps, self.dist3 = eps, dist3
        self.calls = []

    @staticmethod
    def sim_step_slots() -> int:
        return 10

    def sim_rows_f64_step(self, i, o, m0, mh, fst, n, ni, k, r0, integ,
                          comp, dist3, G, dt, kick, eps2, word, off, nxt,
                          stream):
        import torch
        return self._step(torch.float64, i, o, m0, mh, fst, n, ni, k, r0,
                          integ, comp, None, G, dt, kick, word, off, nxt)

    def sim_rows_f32_step(self, i, o, m0, mh, fst, n, ni, k, r0, integ,
                          comp, tile, G, dt, kick, eps2, word, off, nxt,
                          stream):
        import torch
        return self._step(torch.float32, i, o, m0, mh, fst, n, ni, k, r0,
                          integ, comp, tile, G, dt, kick, word, off, nxt)

    def _step(self, dtype, i, o, m0p, mhp, fstp, n, ni, k, r0, integ, comp,
              tile, G, dt, kick, word, off, nxt):
        import ctypes

        import torch

        from nbody_tpu_torch.ops.accel_f32 import accel_f32_ordered, \
            accel_f32_ref
        from nbody_tpu_torch.ops.accel_f64 import accel_f64_ref

        t = ctypes.c_int32.from_address(word).value + off
        self.calls.append((r0, t, nxt, o is None, i, o))
        ct = ctypes.c_double if dtype == torch.float64 else ctypes.c_float

        def view(ptr, count):
            return torch.frombuffer((ct * count).from_address(ptr),
                                    dtype=dtype)

        Q, V, A, QC, VC, P, VH, PC, VHC, GM = range(10)
        rows = k * ni
        m0, mh = view(m0p, n), view(mhp, n)
        fst = view(fstp, t + 2 if nxt else t + 1)
        lf = integ == 1

        def comp_add(x, c, d):
            y = d - c
            s = x + y
            return s, (s - x) - y

        def add(x, c, d):
            return comp_add(x, c, d) if comp else (x + d, None)

        def gm_of(buf, step):
            buf[GM].view(-1)[:n] = (m0 + mh * float(fst[step])) * G

        def kick_drift(buf, a, b, q, v, acc, qc, vc):
            buf[VH, a:b], vhc = add(v, vc, acc * kick)
            buf[P, a:b], pc = add(q, qc, buf[VH, a:b] * dt)
            if comp:
                buf[VHC, a:b], buf[PC, a:b] = vhc, pc

        src = view(i, 10 * rows * 3).view(10, rows, 3)
        if o is None:                    # the chunk's pre-launch
            gm_of(src, t)
            if lf:
                kick_drift(src, 0, n, src[Q, :n], src[V, :n], src[A, :n],
                           src[QC, :n], src[VC, :n])
            return 0
        out = view(o, 10 * rows * 3).view(10, rows, 3)
        if nxt:
            gm_of(out, t + 1)
        a, b = r0, min(r0 + ni, n)
        if b <= a:
            return 0
        pos = src[P if lf else Q, :n]
        gm = src[GM].view(-1)[:n]
        qi = pos[a:b].contiguous()
        if dtype == torch.float64:
            acc = accel_f64_ref(qi[None], pos[None], gm[None], eps=self.eps,
                                dist3_mode=self.dist3)[0]
        else:
            acc = accel_f32_ordered(qi, pos.contiguous(), gm.contiguous(),
                                    eps=self.eps, tile=tile,
                                    force=accel_f32_ref)
        q = pos[a:b]
        v = src[VH if lf else V, a:b]
        qc, vc = (src[PC, a:b], src[VHC, a:b]) if lf else \
            (src[QC, a:b], src[VC, a:b])
        out[V, a:b], vc2 = add(v, vc, acc * (kick if lf else dt))
        if comp:
            out[VC, a:b] = vc2
        if not lf:
            out[Q, a:b], qc2 = add(q, qc, out[V, a:b] * dt)
            if comp:
                out[QC, a:b] = qc2
            return 0
        out[Q, a:b], out[A, a:b] = q, acc
        if comp:
            out[QC, a:b] = qc
        if nxt:
            kick_drift(out, a, b, q, out[V, a:b], acc, qc, vc2)
        return 0


def fake_kernels(monkeypatch_set, lib) -> None:
    """Route ops/sim_step's CUDA path to `lib` on CPU tensors:
    monkeypatch_set(obj, name, value) is pytest's monkeypatch.setattr or
    plain setattr in a rank."""
    import contextlib
    import types

    import torch

    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import sim_step as ss

    monkeypatch_set(_build, "load", lambda: lib)
    monkeypatch_set(ss, "_on_cpu", lambda c, name: False)
    monkeypatch_set(torch.cuda, "device",
                    lambda dev: contextlib.nullcontext())
    monkeypatch_set(torch.cuda, "current_stream",
                    lambda: types.SimpleNamespace(cuda_stream=0))


def sim_rows_emulated(axes: dict, precision: str, jobs: list,
                      graphs: bool = False) -> dict:
    """{label: (q, v, a, qc, vc) as numpy (None where absent)} of
    ops/sim_step's row-range chunks on this rank through FakeSimLib, the
    rank's block of the 'body' axis and the real in-place gather; a job is
    (label, q, v, a, m0, m_half, fst, chunks, kw) with host arrays, kw
    the chunk's keywords (G, eps, dt, integrator, compensated, tile).
    With `graphs`, every chunk goes through the graph path with a
    stand-in capture (the captured body, gathers and all, runs at each
    replay) and each label maps to (that tuple, the job's captures)."""
    import torch

    from nbody_tpu_torch.ops import sim_step as ss
    from nbody_tpu_torch.ops.chunking import ChunkGraphs
    from nbody_tpu_torch.parallel.sharded import body_blocks

    mesh = _mesh(axes)
    out = {}
    for label, q, v, a, m0, m_half, fst, chunks, kw in jobs:
        lib = FakeSimLib(kw["eps"])
        fake_kernels(setattr, lib)
        blocks, gather = body_blocks(mesh, q.shape[0])
        t = (lambda x: None if x is None else torch.from_numpy(x.copy()))
        c = ss.SimCarry(t(q), t(v), t(a))
        if kw.get("compensated"):
            c.qc, c.vc = torch.zeros_like(c.q), torch.zeros_like(c.v)
        fn = ss.sim_rows_chunk_f64 if precision == "f64" else \
            ss.sim_rows_chunk_f32
        g = ChunkGraphs(capture=lambda body: body) if graphs else None
        m0t, m_halft, fstt = t(m0), t(m_half), t(fst)
        for s0, s1 in chunks:
            fn(c, m0t, m_halft, fstt, s0, s1, blocks=blocks, gather=gather,
               graphs=g, **kw)
        out[label] = tuple(None if x is None else x.numpy()
                           for x in (c.q, c.v, c.a, c.qc, c.vc))
        if graphs:
            out[label] = (out[label], len(g.entries))
    return out


def sim_rows_gathers(axes: dict, precision: str, jobs: list,
                     graphs: bool) -> dict:
    """{label: ((gathers, gather_bytes) of the request's record, (calls,
    bytes) that the gather itself saw)} of ops/sim_step's row-range chunks
    through FakeSimLib on this rank, each job one request
    (utils/profiling.entry); jobs and `graphs` as `sim_rows_emulated`
    has them."""
    import torch

    from nbody_tpu_torch.ops import sim_step as ss
    from nbody_tpu_torch.ops.chunking import ChunkGraphs
    from nbody_tpu_torch.parallel.sharded import body_blocks
    from nbody_tpu_torch.utils import profiling

    mesh = _mesh(axes)
    out = {}
    for label, q, v, a, m0, m_half, fst, chunks, kw in jobs:
        fake_kernels(setattr, FakeSimLib(kw["eps"]))
        blocks, gather = body_blocks(mesh, q.shape[0])
        seen = [0, 0]

        def counted(x, gather=gather, seen=seen):
            seen[0] += 1
            seen[1] += x.numel() * x.element_size()
            gather(x)

        t = (lambda x: None if x is None else torch.from_numpy(x.copy()))
        c = ss.SimCarry(t(q), t(v), t(a))
        if kw.get("compensated"):
            c.qc, c.vc = torch.zeros_like(c.q), torch.zeros_like(c.v)
        fn = ss.sim_rows_chunk_f64 if precision == "f64" else \
            ss.sim_rows_chunk_f32
        g = ChunkGraphs(capture=lambda body: body) if graphs else None
        m0t, m_halft, fstt = t(m0), t(m_half), t(fst)
        with profiling.entry("test") as req:
            for s0, s1 in chunks:
                fn(c, m0t, m_halft, fstt, s0, s1, blocks=blocks,
                   gather=counted, graphs=g, **kw)
        out[label] = ((req.record["gathers"], req.record["gather_bytes"]),
                      tuple(seen))
    return out
