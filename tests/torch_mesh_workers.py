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
    flags}, binary64 ('f64') or double-double ('tf3')."""
    from nbody_tpu_torch import SimConfig
    from nbody_tpu_torch.models.direct_sum import DD
    from nbody_tpu_torch.parallel.solver_sharded import (
        run_problem_3_sharded, run_problems_12_sharded)
    from nbody_tpu_torch.physics import oscillation_table

    import torch

    mesh = _mesh(axes)
    cfg = SimConfig(n_steps=n_steps)
    fst = oscillation_table(cfg)
    out = {}
    for precision in precisions:
        dtype = {"f64": torch.float64, "tf3": DD}[precision]
        p12 = run_problems_12_sharded(scene, fst, cfg, mesh, dtype=dtype)
        saved = run_problem_3_sharded(scene, p12, fst, cfg, mesh,
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
