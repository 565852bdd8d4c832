"""All-pairs fp32 accelerations, the rsqrt form of the throughput path.

`accel_f32` is the wrapper of kernel B2 (csrc/accel_f32.cu), the port of
`nbody_tpu.ops.pallas_forces.pallas_accel_cross` and, through
`accel_f32_self`, of `pallas_accel`. On a CUDA tensor it launches the kernel
or raises; only a tensor that lies on the CPU goes to the plain version
`accel_f32_ref`. Both compute, for rows qi against sources qj in each row b
of a scenario batch,

    dx = qj_j - qi_i;  d2 = ((dx*dx + dy*dy) + dz*dz) + eps2
    w = gm_j * rsqrt(d2)^3;  a_i = sum over j-tiles of (sum over the tile of w*dx)

with gm = fl(G * m_eff) hoisted by the caller and eps2 = fl32(eps^2). Batch
rows never mix. The tile sums are added in ascending order, as the TPU
kernel adds them; inside a tile the kernel folds serially and the plain
version reduces with `torch.sum`, so the two agree to float32 rounding, not
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# source tile of the plain version: the TPU kernel's default tile_j
TILE_J = 2048
_INT_MAX = 2 ** 31 - 1
_MAX_B = 65535          # the grid's y limit, which the batch rides


def eps2_f32(eps: float) -> float:
    """eps^2 rounded to float32, as the TPU kernel's weakly typed constant
    is: a Python float that float32 holds exactly, so every tensor op and
    the kernel's float argument see the same value."""
    return float(np.float32(eps * eps))


def _check(qi: torch.Tensor, qj: torch.Tensor, gmj: torch.Tensor) -> None:
    if not qi.dtype == qj.dtype == gmj.dtype == torch.float32:
        raise TypeError(f"accel_f32 takes float32 tensors, got qi {qi.dtype}, "
                        f"qj {qj.dtype} and gmj {gmj.dtype}")
    if (qi.dim() not in (2, 3) or qj.dim() != qi.dim() or qi.shape[-1] != 3
            or qj.shape[-1] != 3 or qi.shape[:-2] != qj.shape[:-2]
            or gmj.shape != qj.shape[:-1]):
        raise ValueError(f"accel_f32 takes qi (B, ni, 3), qj (B, nj, 3) and "
                         f"gmj (B, nj), or the same without B, got "
                         f"{tuple(qi.shape)}, {tuple(qj.shape)} and "
                         f"{tuple(gmj.shape)}")
    B = qi.shape[0] if qi.dim() == 3 else 1
    ni, nj = qi.shape[-2], qj.shape[-2]
    if not (1 <= B <= _MAX_B and 1 <= ni <= _INT_MAX and 1 <= nj <= _INT_MAX):
        raise ValueError(f"accel_f32 takes 1 <= B <= {_MAX_B} and 1 <= ni, "
                         f"nj <= 2^31 - 1, got B={B}, ni={ni}, nj={nj}")
    if not qi.device == qj.device == gmj.device:
        raise ValueError(f"qi on {qi.device}, qj on {qj.device}, gmj on "
                         f"{gmj.device}")
    if not (qi.is_contiguous() and qj.is_contiguous()
            and gmj.is_contiguous()):
        raise ValueError("accel_f32 takes contiguous tensors")


def accel_f32_ref(qi: torch.Tensor, qj: torch.Tensor, gmj: torch.Tensor, *,
                  eps: float, tile_j: int = TILE_J) -> torch.Tensor:
    """Plain PyTorch version of kernel B2 in the dtype of its inputs (float32,
    or float64 for a reference of it), batched or not as `accel_f32`:
    broadcast ops over one j-tile at a time, so its memory is
    O(B * ni * tile_j), never O(B * ni * nj)."""
    eps2 = eps2_f32(eps)
    xi, yi, zi = (qi[..., c, None] for c in range(3))     # (..., ni, 1)
    acc = torch.zeros_like(qi)
    for j0 in range(0, qj.shape[-2], tile_j):
        src = qj[..., None, j0:j0 + tile_j, :]           # (..., 1, tile, 3)
        dx = src[..., 0] - xi                            # (..., ni, tile)
        dy = src[..., 1] - yi
        dz = src[..., 2] - zi
        d2 = ((dx * dx + dy * dy) + dz * dz) + eps2
        inv = torch.rsqrt(d2)
        w = gmj[..., None, j0:j0 + tile_j] * ((inv * inv) * inv)
        acc = acc + torch.stack([(w * dx).sum(dim=-1), (w * dy).sum(dim=-1),
                                 (w * dz).sum(dim=-1)], dim=-1)
    return acc


def accel_f32(qi: torch.Tensor, qj: torch.Tensor, gmj: torch.Tensor, *,
              eps: float) -> torch.Tensor:
    """Accelerations (B, ni, 3) of rows qi (B, ni, 3) from sources qj
    (B, nj, 3) under gmj = G*m_eff (B, nj), all float32; unbatched shapes
    (ni, 3), (nj, 3), (nj,) give (ni, 3), a batch of one. CUDA tensors run
    kernel B2 and add one to `accel_f32.launches`; CPU tensors run
    `accel_f32_ref`."""
    _check(qi, qj, gmj)
    if qi.device.type == "cpu":
        return accel_f32_ref(qi, qj, gmj, eps=eps)
    if qi.device.type != "cuda":
        raise ValueError(f"accel_f32 runs on cuda or cpu, not {qi.device}")
    from . import _build

    lib = _build.load()
    a = torch.empty_like(qi)
    with torch.cuda.device(qi.device):
        rc = lib.accel_f32_launch(
            qi.data_ptr(), qj.data_ptr(), gmj.data_ptr(), a.data_ptr(),
            qi.shape[0] if qi.dim() == 3 else 1, qi.shape[-2], qj.shape[-2],
            eps2_f32(eps), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"accel_f32 kernel launch failed: CUDA error {rc}")
    accel_f32.launches += 1
    return a


accel_f32.launches = 0


def accel_f32_self(q: torch.Tensor, gm: torch.Tensor, *,
                   eps: float) -> torch.Tensor:
    """All-pairs accelerations of q (B, n, 3) under gm (B, n), or of one
    unbatched scene: accel_f32(q, q, gm)."""
    return accel_f32(q, q, gm, eps=eps)
