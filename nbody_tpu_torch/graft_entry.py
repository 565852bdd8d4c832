"""Entry points: one step on the card, and a dry run of the mesh.

    from nbody_tpu_torch.graft_entry import entry, dryrun_multichip
    step, args = entry()             # one float32 step, Plummer n=1024
    q, v = step(*args)
    dryrun_multichip(4)              # the mesh on 4 gloo ranks of the CPU

The port of the root `__graft_entry__.py` (which serves the JAX package and
stays as it is). `entry` is one fused step (kernel B2's force, then the
symplectic Euler update) on Plummer n=1024, on the card unless the caller
asks for the CPU. `dryrun_multichip(n)` starts n gloo ranks and runs, over
a ('scen', 'body') mesh of them: the graded P1/P2/P3 solve of a 32-body
scene in which a device saves the planet, on that mesh and on 1 x 1, in
binary64 (bitwise the one-device solve) and in float32 with the tile
pinned (bitwise the same on both shapes); then the ring step of
`make_sharded_step` against the unsharded step, within 1e-4 of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

G, EPS, DT = 6.674e-11, 1e-3, 60.0
# the dry run's horizon, and the f32 tile pinned on every mesh shape
DRYRUN_STEPS, DRYRUN_TILE = 300, 4


def entry(device: str = "cuda"):
    """(step, args): step(q, v, m_eff) -> (q, v) one float32 step of Plummer
    n=1024 through kernel B2 on `device` ('cuda', or 'cpu' for the plain
    version); args the float32 state on that device."""
    import torch

    from .device import resolve_device
    from .models.plummer import plummer_scene
    from .ops.integrate import symplectic_euler_step

    dev = resolve_device(device)
    q, v, m = plummer_scene(1024, seed=0)

    def step(q, v, m_eff):
        return symplectic_euler_step(q, v, m_eff, G=G, eps=EPS, dt=DT)

    args = tuple(torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                 for x in (q, v, m))
    return step, args


def saving_scene():
    """The 32-body scene of the JAX dry run (__graft_entry__.py:92-117):
    the asteroid's ballistic path misses the planet (Problem 1 records a
    miss), the massive device 2 deflects it into a hit (Problem 2), and the
    missile reaches device 2 within a few steps, so destroying it saves the
    planet (the Problem-3 winner); the light device 3 saves nothing."""
    from .io import Scene

    rng = np.random.RandomState(7)
    n = 32
    q = rng.randn(n, 3) * 1e10
    v = rng.randn(n, 3) * 1e2
    m = np.abs(rng.randn(n)) * 1e12
    q[0], v[0], m[0] = 0.0, 0.0, 5.97e24              # planet
    q[1] = (3.0e8, 2.5e7, 0.0)                         # asteroid
    v[1] = (-25_000.0, 0.0, 0.0)
    m[1] = 1.0e10
    q[2], m[2] = (1.5e8, -3.0e7, 0.0), 3.0e25          # massive deflector
    q[3], m[3] = (0.0, 2.0e9, 0.0), 1e12               # light, intercepted
    v[2] = 0.0
    v[3] = 0.0
    return Scene(n=n, planet=0, asteroid=1, q=q, v=v, m=m,
                 types=["planet", "asteroid", "device", "device"]
                 + ["body"] * (n - 4), device_idx=np.asarray([2, 3]))


def mesh_shape(n_devices: int) -> dict:
    """The dry run's mesh on n_devices ranks: two scenario rows where n is
    even and above 1, the rest bodies."""
    scen = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return {"scen": scen, "body": n_devices // scen}


def _dryrun_rank(axes: dict) -> dict:
    """One rank of dryrun_multichip on a mesh of shape `axes`: the graded
    answers in f64 and in f32 at tile 4, and the ring step checked against
    the unsharded step."""
    import torch

    from .config import SimConfig
    from .engine import solve_scene
    from .models.plummer import plummer_scene
    from .ops.integrate import symplectic_euler_step
    from .parallel import make_mesh, make_sharded_step
    from .parallel.mesh import axis

    mesh = make_mesh(axes, device="cpu")
    cfg = dataclasses.replace(SimConfig(), n_steps=DRYRUN_STEPS)
    out = {precision: solve_scene(saving_scene(), cfg, precision=precision,
                                  mesh=mesh, tile=tile).as_tuple()
           for precision, tile in (("f64", None), ("f32", DRYRUN_TILE))}

    # the ring step (B2's cross form around the 'body' ring) against the
    # unsharded step; >= 2 rotations where the body axis is >= 2
    _, bi, body = axis(mesh, "body")
    n = 16 * body
    qp, vp, mp = (np.asarray(x, np.float32) for x in plummer_scene(n, seed=0))
    rows = slice(bi * (n // body), (bi + 1) * (n // body))
    step = make_sharded_step(mesh, G=G, eps=EPS, dt=DT)
    q1, _ = step(*(torch.from_numpy(x[rows].copy()) for x in (qp, vp, mp)))
    q2, _ = symplectic_euler_step(*(torch.from_numpy(x) for x in
                                    (qp, vp, mp)), G=G, eps=EPS, dt=DT)
    assert bool(torch.isfinite(q1).all())
    np.testing.assert_allclose(q1.numpy(), q2[rows].numpy(), rtol=1e-4,
                               atol=1e-30)
    out["ring_n"] = n
    return out


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> dict:
    """Run the mesh on n_devices gloo ranks of the CPU and on one
    (module docstring); raises if a check fails. Returns rank 0's record
    of the n_devices run."""
    from .config import SimConfig
    from .engine import solve_scene
    from .parallel.spawn import run_ranks

    axes = mesh_shape(n_devices)
    recs = run_ranks(_dryrun_rank, n_devices, (axes,), timeout=timeout)
    one = run_ranks(_dryrun_rank, 1, ({"scen": 1, "body": 1},),
                    timeout=timeout)[0]
    cfg = dataclasses.replace(SimConfig(), n_steps=DRYRUN_STEPS)
    plain = solve_scene(saving_scene(), cfg, precision="f64", device="cpu")
    rec = recs[0]
    assert plain.hit_time_step != -2, "the dry-run scene must hit"
    assert plain.gravity_device_id != -1, \
        "the dry-run scene must have a saving device"
    assert all(r == rec for r in recs), recs          # every rank agrees
    for precision in ("f64", "f32"):                  # bitwise, any shape
        assert rec[precision] == one[precision], (rec, one)
    assert rec["f64"] == plain.as_tuple(), (rec, plain)
    assert rec["f32"][1:] == plain.as_tuple()[1:], (rec, plain)
    print(f"dryrun_multichip ok: mesh={axes}; graded P1/P2/P3 solve "
          f"mesh-invariant, f64 answers {rec['f64']} bitwise the one-device "
          f"ones, f32 {rec['f32']}; ring step n={rec['ring_n']} matches the "
          f"unsharded step", flush=True)
    return rec
