"""simulate()'s step loop: the eager PyTorch loop, and its binary64 kernel.

`eager_chunk` advances a `SimCarry` by a chunk of steps, a few PyTorch ops
a step around one force call (ops/integrate), in every precision and on
the mesh. `sim_chunk_f64` is the wrapper of the binary64 step kernel
(csrc/sim_step_f64.cu), the port of what the JAX package compiles into one
scan a chunk (`nbody_tpu.simulate._chunk_scan`) around
`nbody_tpu.ops.pallas_forces_e64._e64_kernel`: on a CUDA carry one C call
a chunk, one launch a step, the masses, kernel B1's force and the update
(Euler or leapfrog, with or without Kahan compensation) in the eager
loop's ops and order, so its bits are the eager loop's around kernel B1.
Its plain version `sim_chunk_f64_ref` is that loop with B1's plain twin
`accel_f64_ref` as its force; a CPU carry goes to it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .accel_f64 import accel_f64_ref
from .forces import DIST3_CODES
from .integrate import accel, kdk_leapfrog_step, scalar, \
    symplectic_euler_step

INTEGRATORS = ("euler", "leapfrog")
# the state buffer's slots of n * 3 doubles (csrc/sim_step_f64.cu SLOT_*):
# q, v, a, qc and vc come first
SLOTS = 10


@dataclasses.dataclass
class SimCarry:
    """simulate's state between steps: positions, velocities, the
    leapfrog's acceleration at q (None for Euler) and the Kahan
    compensations (None without compensation)."""
    q: torch.Tensor
    v: torch.Tensor
    a: Optional[torch.Tensor] = None
    qc: Optional[torch.Tensor] = None
    vc: Optional[torch.Tensor] = None


def comp_add(x, c, d):
    """Kahan compensated x += d with running compensation c.

    y = d - c recovers the low-order bits lost on previous adds; the new
    compensation is the rounding error of t = x + y, extracted exactly by
    (t - x) - y (|y| <= |x| in the integration regime). Three eager ops:
    under torch.compile or a fused op the extraction could be simplified
    away (the step kernel writes each as a round-to-nearest intrinsic)."""
    y = d - c
    t = x + y
    return t, (t - x) - y


def eager_chunk(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                fst, s0: int, s1: int, *, G: float, eps: float, dt: float,
                integrator: str, compensated: bool,
                dist3_mode: str = "dsqrt", force=None) -> None:
    """Steps s0+1..s1 of simulate's eager loop on c, in place: step s runs
    under m_eff = m0 + m_half * fst[s] (fst host floats of the state's
    dtype) and the force of ops/integrate.accel, or `force(q, gm)`."""
    kick, drift = scalar(0.5 * dt, c.q.dtype), scalar(dt, c.q.dtype)
    kw = {"G": G, "eps": eps, "dist3_mode": dist3_mode, "force": force}
    q, v, a, qc, vc = c.q, c.v, c.a, c.qc, c.vc
    for s in range(s0 + 1, s1 + 1):
        m_eff = m0 + m_half * fst[s]
        if integrator == "leapfrog" and compensated:
            v, vc = comp_add(v, vc, a * kick)
            q, qc = comp_add(q, qc, v * drift)
            a = accel(q, m_eff, **kw)
            v, vc = comp_add(v, vc, a * kick)
        elif integrator == "leapfrog":
            q, v, a = kdk_leapfrog_step(q, v, a, m_eff, dt=dt, **kw)
        elif compensated:
            acc = accel(q, m_eff, **kw)
            v, vc = comp_add(v, vc, acc * drift)
            q, qc = comp_add(q, qc, v * drift)
        else:
            q, v = symplectic_euler_step(q, v, m_eff, dt=dt, **kw)
    c.q, c.v, c.a, c.qc, c.vc = q, v, a, qc, vc


def _check(c: SimCarry, m0, m_half, fst, s0: int, s1: int, integrator: str,
           compensated: bool, dist3_mode: str) -> None:
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator: {integrator}")
    if dist3_mode not in DIST3_CODES:
        raise ValueError(f"dist3_mode must be one of {sorted(DIST3_CODES)}, "
                         f"got {dist3_mode!r}")
    want = {"q": True, "v": True, "a": integrator == "leapfrog",
            "qc": compensated, "vc": compensated}
    state = {k: getattr(c, k) for k in want}
    for k, needed in want.items():
        if (state[k] is not None) != needed:
            raise ValueError(f"a {integrator} carry "
                             f"{'with' if compensated else 'without'} "
                             f"compensation {'needs' if needed else 'has no'}"
                             f" {k}")
    tensors = [x for x in state.values() if x is not None]
    tensors += [m0, m_half, fst]
    if any(x.dtype != torch.float64 for x in tensors):
        raise TypeError(f"sim_chunk_f64 takes float64 tensors, got "
                        f"{[x.dtype for x in tensors]}")
    n = c.q.shape[0]
    if (any(x.shape != (n, 3) for x in state.values() if x is not None)
            or n < 1 or m0.shape != (n,) or m_half.shape != (n,)
            or fst.dim() != 1):
        raise ValueError(f"sim_chunk_f64 takes a state of (n, 3), n >= 1, "
                         f"masses (n,) and a table fst, got q "
                         f"{tuple(c.q.shape)}, m0 {tuple(m0.shape)}, m_half "
                         f"{tuple(m_half.shape)}, fst {tuple(fst.shape)}")
    if not 0 <= s0 < s1 < fst.shape[0]:
        raise ValueError(f"steps {s0}+1..{s1} need 0 <= s0 < s1 < "
                         f"len(fst) = {fst.shape[0]}")
    if any(x.device != c.q.device for x in tensors):
        raise ValueError(f"sim_chunk_f64 takes tensors on one device, got "
                         f"{[str(x.device) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sim_chunk_f64 takes contiguous tensors")


def sim_chunk_f64_ref(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                      fst: torch.Tensor, s0: int, s1: int, *, G: float,
                      eps: float, dt: float, integrator: str,
                      compensated: bool, dist3_mode: str = "dsqrt") -> None:
    """Plain PyTorch version of the binary64 step kernel: the eager loop
    (`eager_chunk`) with kernel B1's plain twin as its force, on c in
    place, on any device."""
    _check(c, m0, m_half, fst, s0, s1, integrator, compensated, dist3_mode)

    def force(q, gm):
        return accel_f64_ref(q[None], q[None], gm[None], eps=eps,
                             dist3_mode=dist3_mode)[0]

    eager_chunk(c, m0, m_half, fst.tolist(), s0, s1, G=G, eps=eps, dt=dt,
                integrator=integrator, compensated=compensated,
                dist3_mode=dist3_mode, force=force)


def sim_chunk_f64(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                  fst: torch.Tensor, s0: int, s1: int, *, G: float,
                  eps: float, dt: float, integrator: str, compensated: bool,
                  dist3_mode: str = "dsqrt") -> None:
    """Steps s0+1..s1 of simulate's binary64 loop on the carry c (q, v (n,
    3) float64; a for the leapfrog, qc and vc with compensation), in place,
    under m_eff = m0 + m_half * fst[s] (fst the oscillation table (steps +
    1,) as a float64 tensor).

    A CUDA carry runs the step kernel: one C call, s1 - s0 step launches
    and one launch that forms the chunk's first inputs, all added to
    `sim_chunk_f64.launches`; a CPU carry runs `sim_chunk_f64_ref`."""
    _check(c, m0, m_half, fst, s0, s1, integrator, compensated, dist3_mode)
    dev = c.q.device
    if dev.type == "cpu":
        sim_chunk_f64_ref(c, m0, m_half, fst, s0, s1, G=G, eps=eps, dt=dt,
                          integrator=integrator, compensated=compensated,
                          dist3_mode=dist3_mode)
        return
    if dev.type != "cuda":
        raise ValueError(f"sim_chunk_f64 runs on cuda or cpu, not {dev}")
    from . import _build

    lib = _build.load()
    if lib.sim_step_f64_slots() != SLOTS:
        raise RuntimeError("the step kernel's state buffer has "
                           f"{lib.sim_step_f64_slots()} slots, not {SLOTS}")
    n = c.q.shape[0]
    st = torch.empty((2, SLOTS, n, 3), dtype=torch.float64, device=dev)
    for slot, x in enumerate((c.q, c.v, c.a, c.qc, c.vc)):
        if x is not None:
            st[0, slot] = x
    with torch.cuda.device(dev):
        rc = lib.sim_chunk_f64_launch(
            st[0].data_ptr(), st[1].data_ptr(), m0.data_ptr(),
            m_half.data_ptr(), fst.data_ptr(), n,
            INTEGRATORS.index(integrator), int(compensated),
            DIST3_CODES[dist3_mode], G, dt, 0.5 * dt, eps * eps, s0, s1,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sim_chunk_f64 kernel launch failed: CUDA error "
                           f"{rc}")
    sim_chunk_f64.launches += s1 - s0 + 1
    out = st[(s1 - s0) % 2]
    c.q, c.v = out[0], out[1]
    if c.a is not None:
        c.a = out[2]
    if compensated:
        c.qc, c.vc = out[3], out[4]


sim_chunk_f64.launches = 0
