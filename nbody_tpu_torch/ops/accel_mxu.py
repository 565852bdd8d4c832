"""All-pairs fp32 accelerations in the Gram form.

`accel_mxu` is the wrapper of kernel B3 (csrc/accel_mxu.cu), the port of
`nbody_tpu.ops.pallas_forces.pallas_accel_mxu`, and `step_mxu` the port of
`pallas_step_mxu`. On a CUDA tensor the wrapper launches the kernel or
raises; only a tensor that lies on the CPU goes to the plain version
`accel_mxu_ref`. Both compute, per pair,

    g = (xi*xj + yi*yj) + zi*zj
    d2 = max((|qi|^2 + (|qj|^2 + eps2)) - 2*g, eps2/2)
    w = gm_j * rsqrt(d2)^3, 0 where j == i;  acc_i += w * [xj, yj, zj, 1]

and a_i = acc_i[:3] - acc_i[3] * qi, with eps2 = fl32(eps^2). The Gram d2
cancels for near pairs (its relative error grows like (|q|/d)^2), so this is
a throughput experiment; the graded paths never route here.

`gram` and `accum` pick each product's precision, as `Precision.HIGHEST`
and `Precision.DEFAULT` did on the TPU's matrix unit: 'highest' is plain
float32 products, 'default' one bf16 pass, whose product inputs are rounded
to bfloat16 (to nearest, ties to even) and summed in float32. For the Gram
that rounds qi and qj, for the accumulation w and qj.

The kernel computes g, d2 and w op for op as the plain version does, and
its accumulation on the tensor cores: one bf16 mma for accum='default',
two tf32 mma on split operands (w and qj each a tf32 value and a
remainder) for highest:highest; default:highest accumulates with float32 FMAs, because
the tensor cores' truncated sums miss the tolerance there (csrc/
accel_mxu.cu). It adds each mma's sum to its 128-source tile's sum and the
tile sums in ascending order; the plain version sums the same tiles with
`torch.sum`, so the two agree to float32 rounding, not bit for bit
(tests/test_torch_accel_mxu.py emulates the kernel's accumulation).
"""

from __future__ import annotations

import torch

from .accel_f32 import eps2_f32
from .integrate import scalar

PRECISIONS = ("highest", "default")
# source tile of the plain version: the kernel's
TILE_J = 128
_INT_MAX = 2 ** 31 - 1


def _check(q: torch.Tensor, gm: torch.Tensor, gram: str, accum: str) -> None:
    if gram not in PRECISIONS or accum not in PRECISIONS:
        raise ValueError(f"gram and accum take one of {PRECISIONS}, got "
                         f"{gram!r} and {accum!r}")
    if q.dtype != torch.float32 or gm.dtype != torch.float32:
        raise TypeError(f"accel_mxu takes float32 tensors, got q {q.dtype} "
                        f"and gm {gm.dtype}")
    if q.dim() != 2 or q.shape[1] != 3 or gm.shape != q.shape[:1]:
        raise ValueError(f"accel_mxu takes q (n, 3) and gm (n,), got "
                         f"{tuple(q.shape)} and {tuple(gm.shape)}")
    if not 1 <= q.shape[0] <= _INT_MAX:
        raise ValueError(f"accel_mxu takes 1 <= n <= 2^31 - 1, got "
                         f"n={q.shape[0]}")
    if q.device != gm.device:
        raise ValueError(f"q on {q.device} but gm on {gm.device}")
    if not (q.is_contiguous() and gm.is_contiguous()):
        raise ValueError("accel_mxu takes contiguous tensors")


def bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even), in x's dtype: a
    product input of one bf16 pass."""
    return x.to(torch.bfloat16).to(x.dtype)


def _mask_self(w: torch.Tensor, j0: int) -> torch.Tensor:
    """w (n, tile) of sources j0.. with the self pairs j == i set to 0."""
    i = torch.arange(w.shape[0], device=w.device)[:, None]
    j = torch.arange(j0, j0 + w.shape[1], device=w.device)[None, :]
    return torch.where(i == j, torch.zeros((), dtype=w.dtype,
                                           device=w.device), w)


def accel_mxu_ref(q: torch.Tensor, gm: torch.Tensor, *, eps: float,
                  gram: str = "highest", accum: str = "highest",
                  tile_j: int = TILE_J) -> torch.Tensor:
    """Plain PyTorch version of kernel B3 in the dtype of its inputs: the
    kernel's ops over one j-tile at a time, O(n * tile_j) memory."""
    eps2 = eps2_f32(eps)
    n = q.shape[0]
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    nrm2 = (x * x + y * y) + z * z
    gq = bf16_rn(q) if gram == "default" else q
    aq = bf16_rn(q) if accum == "default" else q
    gxi, gyi, gzi = (gq[:, c, None] for c in range(3))   # (n, 1)
    ni2 = nrm2[:, None]
    acc = q.new_zeros((n, 4))
    for j0 in range(0, n, tile_j):
        src = slice(j0, j0 + tile_j)
        g = (gxi * gq[src, 0] + gyi * gq[src, 1]) + gzi * gq[src, 2]
        d2 = torch.clamp((ni2 + (nrm2[src] + eps2)) - 2.0 * g,
                         min=0.5 * eps2)
        inv = torch.rsqrt(d2)
        w = _mask_self(gm[src] * ((inv * inv) * inv), j0)
        if accum == "default":
            w = bf16_rn(w)
        s = aq[src]
        acc = acc + torch.stack([(w * s[:, 0]).sum(dim=1),
                                 (w * s[:, 1]).sum(dim=1),
                                 (w * s[:, 2]).sum(dim=1),
                                 w.sum(dim=1)], dim=1)
    return acc[:, :3] - acc[:, 3:] * q


def accel_mxu(q: torch.Tensor, gm: torch.Tensor, *, eps: float,
              gram: str = "highest", accum: str = "highest") -> torch.Tensor:
    """Accelerations (n, 3) of q (n, 3) under gm = G*m_eff (n,), float32,
    Gram form. CUDA tensors run kernel B3 and add one to
    `accel_mxu.launches`; CPU tensors run `accel_mxu_ref`."""
    _check(q, gm, gram, accum)
    if q.device.type == "cpu":
        return accel_mxu_ref(q, gm, eps=eps, gram=gram, accum=accum)
    if q.device.type != "cuda":
        raise ValueError(f"accel_mxu runs on cuda or cpu, not {q.device}")
    from . import _build

    lib = _build.load()
    a = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.accel_mxu_launch(
            q.data_ptr(), gm.data_ptr(), a.data_ptr(), q.shape[0],
            eps2_f32(eps), int(gram == "default"), int(accum == "default"),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"accel_mxu kernel launch failed: CUDA error {rc}")
    accel_mxu.launches += 1
    return a


accel_mxu.launches = 0


def step_mxu(q: torch.Tensor, v: torch.Tensor, gm: torch.Tensor, *,
             eps: float, dt: float, gram: str = "highest",
             accum: str = "highest"):
    """One symplectic Euler step on the Gram-form force (the bench path):
    v += a*dt; q += v*dt. Returns the new (q, v)."""
    a = accel_mxu(q, gm, eps=eps, gram=gram, accum=accum)
    dt = scalar(dt, q.dtype)
    v = v + a * dt
    q = q + v * dt
    return q, v
