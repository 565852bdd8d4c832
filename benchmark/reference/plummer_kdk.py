"""Plain reference of `simulate()` in binary64: the kick-drift-kick
leapfrog (and Euler) around the spec program's direct-difference force.

The force is the NTHU IPC hw5 spec program's (samples/nbody.cc:61-72;
native/core.cc `advance`), the differences q_j - q_i taken directly:

    dx = x_j - x_i;  dy = y_j - y_i;  dz = z_j - z_i
    d2 = ((dx*dx + dy*dy) + dz*dz) + eps^2
    d3 = d2 * sqrt(d2)                       (the configuration's dsqrt)
    a_i = sum over j != i of (gm_j * dx) / d3,   gm = fl(m * G)

and a step is the one `sim_step.cuh` states, with kick = dt / 2:

    KDK:    v += a*kick;  q += v*dt;  a = F(q);  v += a*kick
    Euler:  a = F(q);  v += a*dt;  q += v*dt

`a` is seeded once at q0, so a leapfrog call of S steps is S + 1 force
evaluations, an Euler call S. Every operation is one plain PyTorch op,
rounded to nearest, nothing contracted into a fused multiply-add.

Two modes of the force, which depart from the spec program as follows:

- `serial`: a loop over the sources j in ascending order, each a few ops
  on all rows at once, so every row's sum is the spec program's fold, one
  pair after another, the self pair skipped. No departure. It costs n
  iterations a force: for small n, on the CPU in the tests, and on a card
  up to some thousands of bodies.
- `block`: rows in blocks of `block` (1024 by default) against all n
  sources, each block's terms formed as above in (rows, n) matrices, the
  self pair's term set to zero, and each row's terms summed by torch.sum.
  The one departure is the order of that sum. At n = 65536 a block's
  matrices take some 2.5 GB of a card's memory.

`dtype` sets the precision of the state and its update, as
`plummer.march`'s does: the force is formed in binary64 from that state
and rounded to it, so that `dtype=torch.float32` gives the control, the
reference marched in the precision below binary64. The matrix products'
TF32 mode is off while a march runs (none is used; it is set so that no
product can take it).

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1024            # rows a block in block mode
MODES = ("serial", "block")
INTEGRATORS = ("euler", "leapfrog")


def _accel_serial(q: torch.Tensor, gm: torch.Tensor,
                  eps2: float) -> torch.Tensor:
    """Accelerations (n, 3) of float64 positions q (n, 3) under gm,
    each row's terms folded over ascending j, the self pair skipped."""
    n = q.shape[0]
    acc = torch.zeros_like(q)
    for j in range(n):
        dq = q[j] - q                                    # q_j - q_i
        dx, dy, dz = dq.unbind(1)
        d2 = ((dx * dx + dy * dy) + dz * dz) + eps2
        d3 = d2 * torch.sqrt(d2)
        t = (gm[j] * dq) / d3[:, None]
        acc[:j] += t[:j]
        acc[j + 1:] += t[j + 1:]
    return acc


def _accel_block(q: torch.Tensor, gm: torch.Tensor, eps2: float,
                 block: int) -> torch.Tensor:
    """Accelerations (n, 3) of float64 positions q (n, 3) under gm: the
    same terms in blocks of rows, each row's terms summed by torch.sum."""
    n = q.shape[0]
    xs = [q[:, k].contiguous() for k in range(3)]
    out = torch.empty_like(q)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        d = [x[None, :] - x[r0:r1, None] for x in xs]    # x_j - x_i
        d2 = d[0] * d[0]
        t = d[1] * d[1]
        d2 += t
        torch.mul(d[2], d[2], out=t)
        d2 += t
        d2 += eps2
        torch.sqrt(d2, out=t)
        d3 = d2.mul_(t)                                  # d2 * sqrt(d2)
        del t
        for k in range(3):
            term = d[k].mul_(gm).div_(d3)                # (gm_j dx) / d3
            term.view(-1)[r0::n + 1][:r1 - r0] = 0.0     # the self pair
            out[r0:r1, k] = term.sum(1)
        del d, d2, d3, term
    return out


def accel(q: torch.Tensor, gm: torch.Tensor, eps: float, *,
          mode: str = "block", block: int = BLOCK) -> torch.Tensor:
    """Accelerations (n, 3) of float64 positions q (n, 3) under gm = G m
    (n,), in `mode` (module docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode is one of {MODES}, got {mode!r}")
    if q.dtype != torch.float64 or gm.dtype != torch.float64:
        raise TypeError("the force takes float64 positions and gm")
    eps2 = eps * eps
    if mode == "serial":
        return _accel_serial(q, gm, eps2)
    return _accel_block(q, gm, eps2, block)


def march(q0: np.ndarray, v0: np.ndarray, m: np.ndarray, *, n_steps: int,
          G: float, eps: float, dt: float, device,
          integrator: str = "leapfrog", mode: str = "block",
          block: int = BLOCK,
          dtype: torch.dtype = torch.float64) -> tuple:
    """(q, v) float64 host arrays after n_steps steps of `integrator` from
    (q0, v0), the force in `mode`, the state and update in `dtype`."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator is one of {INTEGRATORS}, got "
                         f"{integrator!r}")

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(device)

    def force(q):
        return accel(q.double(), gm, eps, mode=mode, block=block).to(dtype)

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        q, v = put(q0).to(dtype), put(v0).to(dtype)
        gm = put(m) * G
        if integrator == "leapfrog":
            kick = 0.5 * dt
            a = force(q)
            for _ in range(n_steps):
                v = v + a * kick
                q = q + v * dt
                a = force(q)
                v = v + a * kick
        else:
            for _ in range(n_steps):
                v = v + force(q) * dt
                q = q + v * dt
        return q.double().cpu().numpy(), v.double().cpu().numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
