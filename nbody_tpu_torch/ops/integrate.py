"""Integration steps: symplectic (semi-implicit) Euler and KDK leapfrog.

v += a*dt; q += v*dt is the reference's update (hw5.cu:231-239,
samples/nbody.cc:76-88, core.cc:118-127). Each line is one PyTorch op, so
nothing is fused and nothing contracts into an FMA.

The force dispatches on the state's dtype: float32 runs kernel B2
(ops/accel_f32, the rsqrt form), float64 runs kernel B1 (ops/accel_f64, the
serial-fold binary64 form).
"""

from __future__ import annotations

import numpy as np
import torch

from .accel_f32 import accel_f32_self
from .accel_f64 import accel_f64


def scalar(x: float, dtype: torch.dtype) -> float:
    """A host constant as the state's dtype holds it. A float32 op on a
    Python double would leave the rounding of the constant to the op; the
    JAX package rounds it to float32 first (weak typing), and so does this."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def accel(q: torch.Tensor, m_eff: torch.Tensor, *, G: float,
          eps: float) -> torch.Tensor:
    """Accelerations of q under effective masses m_eff.

    q (B, n, 3) and m_eff (B, n), a scenario batch, or one unbatched scene
    (n, 3), (n,). float32: kernel B2 with gm = fl32(m_eff * fl32(G));
    float64: kernel B1 with gm = fl(m_eff * G)."""
    if q.dtype == torch.float32:
        return accel_f32_self(q, m_eff * scalar(G, q.dtype), eps=eps)
    if q.dim() == 2:
        return accel_f64(q[None], (m_eff * G)[None], eps=eps)[0]
    return accel_f64(q, m_eff * G, eps=eps)


def symplectic_euler_step(q: torch.Tensor, v: torch.Tensor,
                          m_eff: torch.Tensor, *, G: float, eps: float,
                          dt: float):
    """One step of q, v under effective masses m_eff (shapes as `accel`).
    Returns the new (q, v)."""
    a = accel(q, m_eff, G=G, eps=eps)
    dt = scalar(dt, q.dtype)
    v = v + a * dt
    q = q + v * dt
    return q, v


def kdk_leapfrog_step(q: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
                      m_eff: torch.Tensor, *, G: float, eps: float,
                      dt: float):
    """Kick-drift-kick leapfrog (velocity Verlet), 2nd order symplectic.

    State is (q, v, a) with `a` the acceleration at q; the end-of-step
    acceleration is carried to the next step, so a step costs one force
    evaluation, as Euler's does. Returns the updated (q, v, a)."""
    kick = scalar(0.5 * dt, q.dtype)
    vh = v + a * kick
    q = q + vh * scalar(dt, q.dtype)
    a = accel(q, m_eff, G=G, eps=eps)
    v = vh + a * kick
    return q, v, a
