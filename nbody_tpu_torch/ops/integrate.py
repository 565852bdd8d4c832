"""Symplectic (semi-implicit) Euler integration, fp64 path.

v += a*dt; q += v*dt — the reference's update (hw5.cu:231-239,
samples/nbody.cc:76-88, core.cc:118-127). Each line is one PyTorch op, so
nothing is fused and nothing contracts into an FMA.
"""

from __future__ import annotations

import torch

from .accel_f64 import accel_f64


def symplectic_euler_step(q: torch.Tensor, v: torch.Tensor,
                          m_eff: torch.Tensor, *, G: float, eps: float,
                          dt: float):
    """One step of q, v (B, n, 3) under effective masses m_eff (B, n).
    Returns the new (q, v)."""
    gm = m_eff * G                      # fl(G * m_j), hoisted out of the pairs
    a = accel_f64(q, gm, eps=eps)
    v = v + a * dt
    q = q + v * dt
    return q, v
