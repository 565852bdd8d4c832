"""All-pairs fp64 accelerations with the serial ascending-j fold.

`accel_f64` is the wrapper of kernel B1 (csrc/accel_f64.cu), the port of
`nbody_tpu.ops.pallas_forces_e64.pallas_accel_e64` and of
`nbody_tpu.ops.integrate._pallas_accel_e64_batched`; its cross form, rows
qi against sources qj, is what the JAX package's mesh asks of
`forces.pairwise_accel_e64(rows=)`. On a CUDA tensor it launches the kernel
or raises; only a tensor that lies on the CPU goes to the plain twin
`accel_f64_ref`. Both compute, bit for bit, what native/core.cc computes in
dsqrt mode:

    dx = qj_j - qi_i;  d2 = ((dx*dx + dy*dy) + dz*dz) + eps^2
    d3 = d2 * sqrt(d2);  a_i = fold over ascending j of (gm_j * dx) / d3

with gm = fl(G * m_eff) hoisted by the caller. `accel_f64_self(q, gm)` is
`accel_f64(q, q, gm)`, the all-pairs force; its j == i term is +-0 and is
folded unmasked, as on the TPU. A row's fold depends on nothing but its own
position and the sources, so rows split into blocks, each through the cross
form, give the self form's bits: what makes the binary64 mesh exact
(parallel/solver_sharded.py). `dist3_mode='sqrt3'` forms d3 as
sqrt((d2*d2)*d2) instead, a second instantiation of the kernel, bit-equal
to the native core's sqrt3 mode.
"""

from __future__ import annotations

import torch

from .forces import DIST3_CODES, dist3


def _check(qi: torch.Tensor, qj: torch.Tensor, gm: torch.Tensor) -> None:
    if not qi.dtype == qj.dtype == gm.dtype == torch.float64:
        raise TypeError(f"accel_f64 takes float64 tensors, got qi "
                        f"{qi.dtype}, qj {qj.dtype} and gm {gm.dtype}")
    if (qi.dim() != 3 or qj.dim() != 3 or qi.shape[-1] != 3
            or qj.shape[-1] != 3 or qi.shape[0] != qj.shape[0]
            or gm.shape != qj.shape[:2]):
        raise ValueError(f"accel_f64 takes qi (B, ni, 3), qj (B, nj, 3) and "
                         f"gm (B, nj), got {tuple(qi.shape)}, "
                         f"{tuple(qj.shape)} and {tuple(gm.shape)}")
    if qi.shape[0] == 0 or qi.shape[1] == 0 or qj.shape[1] == 0:
        raise ValueError(f"accel_f64 takes B, ni, nj >= 1, got "
                         f"{tuple(qi.shape)} and {tuple(qj.shape)}")
    if not qi.device == qj.device == gm.device:
        raise ValueError(f"qi on {qi.device}, qj on {qj.device}, gm on "
                         f"{gm.device}")
    if not (qi.is_contiguous() and qj.is_contiguous()
            and gm.is_contiguous()):
        raise ValueError("accel_f64 takes contiguous tensors")


def accel_f64_ref(qi: torch.Tensor, qj: torch.Tensor, gm: torch.Tensor, *,
                  eps: float, dist3_mode: str = "dsqrt") -> torch.Tensor:
    """Plain PyTorch twin of kernel B1: a loop over the sources j of batched
    tensor ops in the kernel's exact op order. qi (B, ni, 3), qj (B, nj, 3),
    gm (B, nj) float64."""
    eps2 = eps * eps
    acc = torch.zeros_like(qi)
    for j in range(qj.shape[1]):
        dq = qj[:, j:j + 1, :] - qi                      # q_j - q_i
        dx, dy, dz = dq[..., 0], dq[..., 1], dq[..., 2]
        d2 = ((dx * dx + dy * dy) + dz * dz) + eps2
        d3 = dist3(d2, dist3_mode)
        acc = acc + (gm[:, j, None, None] * dq) / d3[..., None]
    return acc


def accel_f64(qi: torch.Tensor, qj: torch.Tensor, gm: torch.Tensor, *,
              eps: float, dist3_mode: str = "dsqrt") -> torch.Tensor:
    """Accelerations (B, ni, 3) of rows qi (B, ni, 3) from sources qj
    (B, nj, 3) under gm = G*m_eff (B, nj), with d2^1.5 formed as
    `dist3_mode` says ('dsqrt' or 'sqrt3').

    Scenario rows b never mix. CUDA tensors run kernel B1 and add one to
    `accel_f64.launches`; CPU tensors run `accel_f64_ref`."""
    _check(qi, qj, gm)
    code = DIST3_CODES[dist3_mode]
    if qi.device.type == "cpu":
        return accel_f64_ref(qi, qj, gm, eps=eps, dist3_mode=dist3_mode)
    if qi.device.type != "cuda":
        raise ValueError(f"accel_f64 runs on cuda or cpu, not {qi.device}")
    from . import _build

    lib = _build.load()
    a = torch.empty_like(qi)
    with torch.cuda.device(qi.device):
        rc = lib.accel_f64_launch(
            qi.data_ptr(), qj.data_ptr(), gm.data_ptr(), a.data_ptr(),
            qi.shape[0], qi.shape[1], qj.shape[1], eps * eps, code,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"accel_f64 kernel launch failed: CUDA error {rc}")
    accel_f64.launches += 1
    return a


accel_f64.launches = 0


def accel_f64_self(q: torch.Tensor, gm: torch.Tensor, *, eps: float,
                   dist3_mode: str = "dsqrt") -> torch.Tensor:
    """All-pairs accelerations of q (B, n, 3) under gm (B, n):
    accel_f64(q, q, gm)."""
    return accel_f64(q, q, gm, eps=eps, dist3_mode=dist3_mode)
