"""Physics diagnostics: conserved-quantity monitors on tensors.

Total energy and linear and angular momentum of a system, for checking an
integrator's health on long runs (symplectic Euler conserves a shadow
Hamiltonian, so the energy of a stable system oscillates boundedly rather
than drifting). The same formulas as `nbody_tpu.utils.diagnostics`.
"""

from __future__ import annotations

import torch


def kinetic_energy(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Sum_i 1/2 m_i |v_i|^2. v: (..., n, 3), m: (..., n)."""
    return 0.5 * (m * (v * v).sum(-1)).sum(-1)


def potential_energy(q: torch.Tensor, m: torch.Tensor, *, G: float,
                     eps: float) -> torch.Tensor:
    """Softened pairwise potential: -G/2 * sum_{i != j} m_i m_j / sqrt(r^2+eps^2).

    (The 1/2 de-duplicates ordered pairs; the diagonal is masked because,
    unlike the force, the self-potential is not zero.) Builds the (n, n)
    pair tensor: meant for monitoring, not for large n."""
    dq = q[..., None, :, :] - q[..., :, None, :]
    d2 = (dq * dq).sum(-1) + eps * eps
    inv = 1.0 / torch.sqrt(d2)
    n = q.shape[-2]
    mask = 1.0 - torch.eye(n, dtype=q.dtype, device=q.device)
    mm = m[..., :, None] * m[..., None, :]
    return -0.5 * G * (mm * inv * mask).sum((-2, -1))


def total_energy(q: torch.Tensor, v: torch.Tensor, m: torch.Tensor, *,
                 G: float, eps: float) -> torch.Tensor:
    return kinetic_energy(v, m) + potential_energy(q, m, G=G, eps=eps)


def total_momentum(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return (m[..., None] * v).sum(-2)


def total_angular_momentum(q: torch.Tensor, v: torch.Tensor,
                           m: torch.Tensor) -> torch.Tensor:
    return (m[..., None] * torch.linalg.cross(q, v, dim=-1)).sum(-2)
