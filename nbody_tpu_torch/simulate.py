"""General simulation API: march a scene for N steps.

The graded solve only answers the three scenario questions; a user of the
engine also wants the capability underneath ("integrate this system"),
with device oscillation on or off, checkpointing and a choice of
precision:

    final = simulate(scene, n_steps=..., precision="f32",
                     integrator="leapfrog", device="cuda", on_chunk=callback)

The port of `nbody_tpu.simulate.simulate`, on one device or over a mesh of
ranks (`mesh`). Each step is a few eager PyTorch ops around one
force-kernel launch (on the mesh: the kernel's cross form on this rank's
rows and a gather, or the ordered ring). `chunk` sets how often the host
reads the state back for `on_chunk` and never changes the arithmetic, so
results are bitwise invariant to it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SimConfig
from .device import resolve_device
from .io import Scene
from .ops import ddfloat as ddf
from .ops.forces import check_dist3
from .ops.integrate import accel, accel_dd_state, kdk_leapfrog_step, \
    kdk_leapfrog_step_dd, scalar, symplectic_euler_step, \
    symplectic_euler_step_dd
from .physics import oscillation_table
from .utils.rescale import IDENTITY, compute_rescale

# beyond binary64: double-double through kernel B4 (simulate() has no
# graded decision quantities, so 'ddp' and 'dd+' run it too, as in the JAX
# package)
_DOUBLE_DOUBLE = ("tf3", "ddp", "dd+")
# native binary64 through kernel B1
_BINARY64 = ("f64", "e64", "dd")
# the representations that carry their own low-order bits
_EXTENDED = _DOUBLE_DOUBLE + ("dd", "e64")


@dataclasses.dataclass
class SimState:
    step: int
    q: np.ndarray
    v: np.ndarray
    # the double-double paths ('tf3', 'ddp', 'dd+'): what q and v, rounded
    # to binary64, leave out, so q + q_lo is the state exactly (None on the
    # other paths)
    q_lo: Optional[np.ndarray] = None
    v_lo: Optional[np.ndarray] = None


def _comp_add(x, c, d):
    """Kahan compensated x += d with running compensation c.

    y = d - c recovers the low-order bits lost on previous adds; the new
    compensation is the rounding error of t = x + y, extracted exactly by
    (t - x) - y (|y| <= |x| in the integration regime). Three eager ops:
    under torch.compile or a fused op the extraction could be simplified
    away."""
    y = d - c
    t = x + y
    return t, (t - x) - y


def simulate(scene: Scene, cfg: SimConfig = DEFAULT_CONFIG, *,
             n_steps: Optional[int] = None, precision: str = "f64",
             device: str = "cuda", devices_on: bool = True,
             chunk: int = 10000, integrator: str = "euler",
             mesh=None, tile: Optional[int] = None,
             compensated: Optional[bool] = None,
             on_chunk: Optional[Callable[[SimState], None]] = None
             ) -> SimState:
    """March the scene and return the final state (original units, host
    float64 arrays).

    precision:
      'f32'        — float32 state on the scene rescaled by powers of two
                     (utils/rescale: graded scenes overflow float32), force
                     kernel B2 (ops/accel_f32).
      'f64', 'e64' — native IEEE binary64, force kernel B1 with the serial
                     fold (ops/accel_f64), d2^1.5 in cfg.dist3_mode's form
                     ('dsqrt' or 'sqrt3'; 'pow' is refused: libm's pow is
                     reproduced by neither CUDA nor torch). On the TPU
                     'e64' is a softfloat emulation of the same semantics
                     and 'f64' runs only on the CPU; the card has binary64
                     in hardware, so both are this one path.
      'dd'         — the same binary64 path. The JAX package runs its
                     double-double 'dd' (float32's range) on the scene
                     rescaled by powers of two; in binary64 that rescale is
                     exact and changes no bit, so the port leaves it out.
      'tf3', 'ddp', 'dd+' — beyond binary64: double-double state and
                     update (ops/ddfloat, about 2^-104 an operation) around
                     force kernel B4 (ops/accel_dd), on the raw scene. The
                     JAX package runs triple-float32 there (about 2^-70),
                     for want of binary64 on a TPU.
    integrator: 'euler' (the graded spec's semi-implicit Euler) or
    'leapfrog' (KDK velocity Verlet, 2nd order, the same one force
    evaluation per step).
    device: 'cuda' (raises without a card) or 'cpu' (the plain PyTorch
    versions of the kernels).
    compensated: Kahan-compensated q/v accumulation (~6 elementwise ops a
    step): each fp32 += of a per-step increment ~1e-5 of the state loses
    ~17 bits of it, and the compensation, carried across chunks, recovers
    them. Default (None): on for 'f32'. 'e64' and the extended
    representations carry their own low-order bits; asking for it there
    is an error.
    mesh: a ('scen', 'body') DeviceMesh of ranks (parallel/mesh.make_mesh);
    every rank calls simulate and gets the whole final state, and
    `device` is the mesh's. 'f32' splits the bodies over 'body' (padded
    with zero-mass bodies) around the ordered ring: bitwise the same on
    every mesh shape for one `tile` (default 128, kernel B2's tile, where
    it is bitwise the one-device run). The binary64 precisions and the
    double-double ones keep the whole state on every rank and split the
    force's rows over 'body' through the cross form of kernel B1 or B4,
    then gather them: bitwise the one-device run on every mesh shape.
    tile: the float32 mesh's force tile; only with a mesh.
    `on_chunk` is called with a host SimState after every chunk of
    `chunk` steps (on the mesh on rank 0 alone; the checkpointing hook:
    pair it with utils.checkpoint.CheckpointPolicy); a double-double state
    is handed over rounded to binary64 (hi + lo), with the remainders in
    q_lo, v_lo.
    """
    if integrator not in ("euler", "leapfrog"):
        raise ValueError(f"unknown integrator: {integrator}")
    if compensated is None:
        compensated = precision == "f32"
    elif compensated and precision in _EXTENDED:
        raise ValueError(
            "compensated accumulation applies to the native-dtype paths "
            "('f32', 'f64'); the extended representations carry their own "
            "low-order bits")
    if mesh is None and tile is not None:
        raise ValueError("tile sets the mesh's float32 force tile; it "
                         "applies only with a mesh")
    if precision not in ("f32",) + _BINARY64 + _DOUBLE_DOUBLE:
        raise ValueError(f"unknown precision for simulate: {precision}")
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    if n_steps is None:
        n_steps = cfg.n_steps
    if mesh is not None:
        from .parallel.mesh import check_mesh, mesh_device
        check_mesh(mesh)
        dev = mesh_device(mesh)
    else:
        dev = resolve_device(device)

    rescale = IDENTITY
    run_scene, run_cfg = scene, cfg
    dist3 = "dsqrt"
    if precision == "f32":
        rescale = compute_rescale(scene, eps=cfg.eps)
        run_scene = rescale.apply_scene(scene)
        run_cfg = rescale.apply_cfg(cfg)
    if precision == "f32":
        dtype, np_dtype = torch.float32, np.float32
    else:
        if precision in _BINARY64:
            dist3 = check_dist3(cfg.dist3_mode, precision)
        dtype, np_dtype = torch.float64, np.float64
    layout = force = None
    if mesh is not None:
        from .parallel.solver_sharded import Layout
        layout = Layout(mesh, scene.n, ddf.NAME
                        if precision in _DOUBLE_DOUBLE else dtype, tile)
        force = layout.force(eps=run_cfg.eps, dist3=dist3)
        on_chunk = _on_rank0(on_chunk)
    if precision in _DOUBLE_DOUBLE:
        return _simulate_dd(run_scene, run_cfg, n_steps=n_steps, device=dev,
                            devices_on=devices_on, chunk=chunk,
                            integrator=integrator, on_chunk=on_chunk,
                            force=force)

    # the oscillation table as host scalars of the state's dtype: each step
    # scales the device half-masses by one of them
    fst = oscillation_table(run_cfg, n_steps).astype(np_dtype).tolist()
    mask = run_scene.device_mask()
    m0 = run_scene.m * (1.0 if devices_on else (1.0 - mask))
    m_half = 0.5 * m0 * mask

    def put(x):
        x = torch.from_numpy(np.asarray(x, dtype=np_dtype)).to(dev)
        return x if layout is None else layout.local(x, dim=0)

    def whole(x):
        return x if layout is None else layout.whole(x, dim=0)

    q, v = put(run_scene.q), put(run_scene.v)
    m0t, m_halft = put(m0), put(m_half)
    G, eps, dt = run_cfg.G, run_cfg.eps, run_cfg.dt
    inv = 1.0 / rescale.length_scale

    def host_state(step):
        return SimState(step=step,
                        q=whole(q).cpu().numpy().astype(np.float64) * inv,
                        v=whole(v).cpu().numpy().astype(np.float64) * inv)

    a = None
    if integrator == "leapfrog":
        # seeded at the initial positions with the first step's masses
        a = accel(q, m0t + m_halft * fst[min(1, n_steps)], G=G, eps=eps,
                  dist3_mode=dist3, force=force)
    if compensated:
        qc, vc = torch.zeros_like(q), torch.zeros_like(v)
        kick, drift = scalar(0.5 * dt, dtype), scalar(dt, dtype)

    step = 0
    while step < n_steps:
        n_sub = min(chunk, n_steps - step)
        for s in range(step + 1, step + n_sub + 1):
            m_eff = m0t + m_halft * fst[s]
            if integrator == "leapfrog" and compensated:
                v, vc = _comp_add(v, vc, a * kick)
                q, qc = _comp_add(q, qc, v * drift)
                a = accel(q, m_eff, G=G, eps=eps, dist3_mode=dist3,
                          force=force)
                v, vc = _comp_add(v, vc, a * kick)
            elif integrator == "leapfrog":
                q, v, a = kdk_leapfrog_step(q, v, a, m_eff, G=G, eps=eps,
                                            dt=dt, dist3_mode=dist3,
                                            force=force)
            elif compensated:
                a = accel(q, m_eff, G=G, eps=eps, dist3_mode=dist3,
                          force=force)
                v, vc = _comp_add(v, vc, a * drift)
                q, qc = _comp_add(q, qc, v * drift)
            else:
                q, v = symplectic_euler_step(q, v, m_eff, G=G, eps=eps,
                                             dt=dt, dist3_mode=dist3,
                                             force=force)
        step += n_sub
        if on_chunk is not None:
            on_chunk(host_state(step))
    return host_state(step)


def _on_rank0(on_chunk):
    """on_chunk called on rank 0 of the mesh alone."""
    import torch.distributed as dist

    if on_chunk is None or dist.get_rank() == 0:
        return on_chunk
    return lambda state: None


def _simulate_dd(scene: Scene, cfg: SimConfig, *, n_steps: int,
                 device: torch.device, devices_on: bool, chunk: int,
                 integrator: str,
                 on_chunk: Optional[Callable[[SimState], None]],
                 force=None) -> SimState:
    """simulate() in double-double: the state, masses and update in
    ops/ddfloat's arithmetic around one kernel B4 launch a step (or the
    mesh's `force`), on the raw scene; the host sees hi + lo rounded to
    binary64."""
    fst = oscillation_table(cfg, n_steps).tolist()
    mask = scene.device_mask()
    m0 = scene.m * (1.0 if devices_on else (1.0 - mask))

    def put(x):
        return ddf.from_f64(np.asarray(x, dtype=np.float64)).to(device)

    q, v = put(scene.q), put(scene.v)
    m0t, m_halft = ddf.split(put(m0)), ddf.split(put(0.5 * m0 * mask))
    G, eps, dt = cfg.G, cfg.eps, cfg.dt

    def m_eff(s: int) -> torch.Tensor:
        return ddf.join(ddf.add(m0t, ddf.mul(m_halft, ddf.const(fst[s]))))

    def host_state(step):
        qs, vs = (ddf.two_sum(x[..., 0], x[..., 1]) for x in (q, v))
        return SimState(step=step, q=qs.hi.cpu().numpy(),
                        v=vs.hi.cpu().numpy(), q_lo=qs.lo.cpu().numpy(),
                        v_lo=vs.lo.cpu().numpy())

    a = None
    if integrator == "leapfrog":
        a = accel_dd_state(q, m_eff(min(1, n_steps)), G=G, eps=eps,
                           force=force)
    step = 0
    while step < n_steps:
        n_sub = min(chunk, n_steps - step)
        for s in range(step + 1, step + n_sub + 1):
            if integrator == "leapfrog":
                q, v, a = kdk_leapfrog_step_dd(q, v, a, m_eff(s), G=G,
                                               eps=eps, dt=dt, force=force)
            else:
                q, v = symplectic_euler_step_dd(q, v, m_eff(s), G=G,
                                                eps=eps, dt=dt, force=force)
        step += n_sub
        if on_chunk is not None:
            on_chunk(host_state(step))
    return host_state(step)
