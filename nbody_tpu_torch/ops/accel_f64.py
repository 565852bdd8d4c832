"""All-pairs fp64 accelerations with the serial ascending-j fold.

`accel_f64` is the wrapper of kernel B1 (csrc/accel_f64.cu), the port of
`nbody_tpu.ops.pallas_forces_e64.pallas_accel_e64` and of
`nbody_tpu.ops.integrate._pallas_accel_e64_batched`. On a CUDA tensor it
launches the kernel or raises; only a tensor that lies on the CPU goes to
the plain twin `accel_f64_ref`. Both compute, bit for bit, what
native/core.cc computes in dsqrt mode:

    dx = q_j - q_i;  d2 = ((dx*dx + dy*dy) + dz*dz) + eps^2
    d3 = d2 * sqrt(d2);  a_i = fold over ascending j of (gm_j * dx) / d3

with gm = fl(G * m_eff) hoisted by the caller. The j == i term is +-0 and is
folded unmasked, as on the TPU. `dist3_mode='sqrt3'` forms d3 as
sqrt((d2*d2)*d2) instead, a second instantiation of the kernel, bit-equal
to the native core's sqrt3 mode.
"""

from __future__ import annotations

import torch

from .forces import DIST3_CODES, dist3


def _check(q: torch.Tensor, gm: torch.Tensor) -> None:
    if q.dtype != torch.float64 or gm.dtype != torch.float64:
        raise TypeError(f"accel_f64 takes float64 tensors, got q {q.dtype} "
                        f"and gm {gm.dtype}")
    if q.dim() != 3 or q.shape[-1] != 3 or gm.shape != q.shape[:2]:
        raise ValueError(f"accel_f64 takes q (B, n, 3) and gm (B, n), got "
                         f"{tuple(q.shape)} and {tuple(gm.shape)}")
    if q.shape[0] == 0 or q.shape[1] == 0:
        raise ValueError(f"accel_f64 takes B, n >= 1, got {tuple(q.shape)}")
    if q.device != gm.device:
        raise ValueError(f"q on {q.device} but gm on {gm.device}")
    if not (q.is_contiguous() and gm.is_contiguous()):
        raise ValueError("accel_f64 takes contiguous tensors")


def accel_f64_ref(q: torch.Tensor, gm: torch.Tensor, *, eps: float,
                  dist3_mode: str = "dsqrt") -> torch.Tensor:
    """Plain PyTorch twin of kernel B1: a loop over j of batched tensor ops
    in the kernel's exact op order. q (B, n, 3), gm (B, n) float64."""
    eps2 = eps * eps
    acc = torch.zeros_like(q)
    for j in range(q.shape[1]):
        dq = q[:, j:j + 1, :] - q                        # q_j - q_i
        dx, dy, dz = dq[..., 0], dq[..., 1], dq[..., 2]
        d2 = ((dx * dx + dy * dy) + dz * dz) + eps2
        d3 = dist3(d2, dist3_mode)
        acc = acc + (gm[:, j, None, None] * dq) / d3[..., None]
    return acc


def accel_f64(q: torch.Tensor, gm: torch.Tensor, *, eps: float,
              dist3_mode: str = "dsqrt") -> torch.Tensor:
    """Accelerations (B, n, 3) of q (B, n, 3) under gm = G*m_eff (B, n),
    with d2^1.5 formed as `dist3_mode` says ('dsqrt' or 'sqrt3').

    Scenario rows b never mix. CUDA tensors run kernel B1 and add one to
    `accel_f64.launches`; CPU tensors run `accel_f64_ref`."""
    _check(q, gm)
    code = DIST3_CODES[dist3_mode]
    if q.device.type == "cpu":
        return accel_f64_ref(q, gm, eps=eps, dist3_mode=dist3_mode)
    if q.device.type != "cuda":
        raise ValueError(f"accel_f64 runs on cuda or cpu, not {q.device}")
    from . import _build

    lib = _build.load()
    a = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.accel_f64_launch(
            q.data_ptr(), gm.data_ptr(), a.data_ptr(), q.shape[0],
            q.shape[1], eps * eps, code,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"accel_f64 kernel launch failed: CUDA error {rc}")
    accel_f64.launches += 1
    return a


accel_f64.launches = 0
