"""Integration steps: symplectic (semi-implicit) Euler and KDK leapfrog.

v += a*dt; q += v*dt is the reference's update (hw5.cu:231-239,
samples/nbody.cc:76-88, core.cc:118-127). Each line is one PyTorch op, so
nothing is fused and nothing contracts into an FMA.

The force dispatches on the state's dtype: float32 runs kernel B2
(ops/accel_f32, the rsqrt form), float64 runs kernel B1 (ops/accel_f64, the
serial-fold binary64 form, d2^1.5 as `dist3_mode` says). The `_dd` steps
take a double-double state (ops/ddfloat: float64 tensors with a trailing
axis of 2) and run kernel B4 (ops/accel_dd), with the update in
double-double.

`force`, where a step takes it, replaces the all-pairs kernel call: a
function force(q, gm) -> a of the state as the step has it and gm =
G * m_eff formed here. The mesh's plain versions and its leapfrog seed
pass their own (ops/sim_step.rows_force, ops/graded_step): a rank's rows
through the kernel's cross form (float32: in the mesh's ordered sum at a
tile) and a gather; every other op of the step stays the same.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ddfloat as ddf
from .accel_dd import accel_dd
from .accel_f32 import accel_f32_self
from .accel_f64 import accel_f64


def scalar(x: float, dtype: torch.dtype) -> float:
    """A host constant as the state's dtype holds it. A float32 op on a
    Python double would leave the rounding of the constant to the op; the
    JAX package rounds it to float32 first (weak typing), and so does this."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def accel(q: torch.Tensor, m_eff: torch.Tensor, *, G: float,
          eps: float, dist3_mode: str = "dsqrt",
          force=None) -> torch.Tensor:
    """Accelerations of q under effective masses m_eff.

    q (B, n, 3) and m_eff (B, n), a scenario batch, or one unbatched scene
    (n, 3), (n,). float32: kernel B2 with gm = fl32(m_eff * fl32(G)), one
    form whatever `dist3_mode` says; float64: kernel B1 with gm =
    fl(m_eff * G); `force(q, gm)` in the kernel's place if given."""
    gm = m_eff * scalar(G, q.dtype)
    if force is not None:
        return force(q, gm)
    if q.dtype == torch.float32:
        return accel_f32_self(q, gm, eps=eps)
    if q.dim() == 2:
        q = q[None]
        return accel_f64(q, q, gm[None], eps=eps, dist3_mode=dist3_mode)[0]
    return accel_f64(q, q, gm, eps=eps, dist3_mode=dist3_mode)


def symplectic_euler_step(q: torch.Tensor, v: torch.Tensor,
                          m_eff: torch.Tensor, *, G: float, eps: float,
                          dt: float, dist3_mode: str = "dsqrt",
                          force=None):
    """One step of q, v under effective masses m_eff (shapes as `accel`).
    Returns the new (q, v)."""
    a = accel(q, m_eff, G=G, eps=eps, dist3_mode=dist3_mode, force=force)
    dt = scalar(dt, q.dtype)
    v = v + a * dt
    q = q + v * dt
    return q, v


def kdk_leapfrog_step(q: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
                      m_eff: torch.Tensor, *, G: float, eps: float,
                      dt: float, dist3_mode: str = "dsqrt", force=None):
    """Kick-drift-kick leapfrog (velocity Verlet), 2nd order symplectic.

    State is (q, v, a) with `a` the acceleration at q; the end-of-step
    acceleration is carried to the next step, so a step costs one force
    evaluation, as Euler's does. Returns the updated (q, v, a)."""
    kick = scalar(0.5 * dt, q.dtype)
    vh = v + a * kick
    q = q + vh * scalar(dt, q.dtype)
    a = accel(q, m_eff, G=G, eps=eps, dist3_mode=dist3_mode, force=force)
    v = vh + a * kick
    return q, v, a


def accel_dd_state(q: torch.Tensor, m_eff: torch.Tensor, *, G: float,
                   eps: float, force=None) -> torch.Tensor:
    """Double-double accelerations of q (B, n, 3, 2) under effective masses
    m_eff (B, n, 2), or of one unbatched scene (n, 3, 2), (n, 2): kernel B4
    with gm = m_eff * G in double-double (G a binary64 value);
    `force(q, gm)` in the kernel's place if given."""
    gm = ddf.join(ddf.mul(ddf.split(m_eff), ddf.const(G)))
    if force is not None:
        return force(q, gm)
    if q.dim() == 3:
        q = q[None]
        return accel_dd(q, q, gm[None], eps=eps)[0]
    return accel_dd(q, q, gm, eps=eps)


def _axpy_dd(x: torch.Tensor, a: torch.Tensor, h: float) -> torch.Tensor:
    """x + a*h in double-double, h a binary64 value."""
    return ddf.join(ddf.add(ddf.split(x),
                            ddf.mul(ddf.split(a), ddf.const(h))))


def symplectic_euler_step_dd(q: torch.Tensor, v: torch.Tensor,
                             m_eff: torch.Tensor, *, G: float, eps: float,
                             dt: float, force=None):
    """`symplectic_euler_step` in double-double (shapes as
    `accel_dd_state`): v += a*dt, q += v*dt."""
    a = accel_dd_state(q, m_eff, G=G, eps=eps, force=force)
    v = _axpy_dd(v, a, dt)
    return _axpy_dd(q, v, dt), v


def kdk_leapfrog_step_dd(q: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
                         m_eff: torch.Tensor, *, G: float, eps: float,
                         dt: float, force=None):
    """`kdk_leapfrog_step` in double-double."""
    vh = _axpy_dd(v, a, 0.5 * dt)
    q = _axpy_dd(q, vh, dt)
    a = accel_dd_state(q, m_eff, G=G, eps=eps, force=force)
    return q, _axpy_dd(vh, a, 0.5 * dt), a
