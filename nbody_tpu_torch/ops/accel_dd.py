"""All-pairs accelerations in double-double binary64: precision 'tf3'.

`accel_dd` is the wrapper of kernel B4 (csrc/accel_dd.cu), the port of
`nbody_tpu.ops.forces.pairwise_accel_tf3`: the same physics beyond
binary64, with a pair of doubles (about 106 bits) where the TPU carries
three float32 words. On a CUDA tensor it launches the kernel or raises;
only a tensor that lies on the CPU goes to the plain version `accel_dd_ref`.
Both compute, bit for bit (ops/ddfloat and csrc/dd.cuh run the same
operations):

    dx = q_j - q_i;  d2 = ((dx*dx + dy*dy) + dz*dz) + eps^2
    a_i = fold over ascending j of (gm_j / (d2 * sqrt(d2))) * dx

with eps^2 = two_prod(eps, eps), gm = G * m_eff formed by the caller, and
the fold of `ddfloat.fold_add`. The j == i term is 0 and is folded
unmasked.
"""

from __future__ import annotations

import torch

from . import ddfloat as ddf


def _check(q: torch.Tensor, gm: torch.Tensor) -> None:
    if q.dtype != torch.float64 or gm.dtype != torch.float64:
        raise TypeError(f"accel_dd takes double-double as float64 tensors, "
                        f"got q {q.dtype} and gm {gm.dtype}")
    if q.dim() != 4 or q.shape[-2:] != (3, 2) or \
            gm.shape != (*q.shape[:2], 2):
        raise ValueError(f"accel_dd takes q (B, n, 3, 2) and gm (B, n, 2), "
                         f"got {tuple(q.shape)} and {tuple(gm.shape)}")
    if q.shape[0] == 0 or q.shape[1] == 0:
        raise ValueError(f"accel_dd takes B, n >= 1, got {tuple(q.shape)}")
    if q.device != gm.device:
        raise ValueError(f"q on {q.device} but gm on {gm.device}")
    if not (q.is_contiguous() and gm.is_contiguous()):
        raise ValueError("accel_dd takes contiguous tensors")


def eps2_dd(eps: float) -> tuple[float, float]:
    """eps^2 as the exact double-double two_prod(eps, eps), (hi, lo), in
    Python floats (binary64)."""
    p = ddf.two_prod(float(eps), float(eps))
    return p.hi, p.lo


def accel_dd_ref(q: torch.Tensor, gm: torch.Tensor, *,
                 eps: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: every pair term at once, then the
    fold over j in ascending order. q (B, n, 3, 2), gm (B, n, 2)."""
    Q, g = ddf.split(q), ddf.split(gm)
    eps2 = ddf.DD(*(torch.tensor(x, dtype=torch.float64, device=q.device)
                    for x in eps2_dd(eps)))
    # (B, i, j) differences q_j - q_i of each component
    dq = [ddf.sub(ddf.DD(Q.hi[:, None, :, c], Q.lo[:, None, :, c]),
                  ddf.DD(Q.hi[:, :, None, c], Q.lo[:, :, None, c]))
          for c in range(3)]
    dx, dy, dz = dq
    d2 = ddf.add(ddf.add(ddf.add(ddf.mul(dx, dx), ddf.mul(dy, dy)),
                         ddf.mul(dz, dz)), eps2)
    w = ddf.div(ddf.DD(g.hi[:, None, :], g.lo[:, None, :]),
                ddf.mul(d2, ddf.sqrt(d2)))
    terms = [ddf.mul(w, d) for d in dq]
    th = torch.stack([t.hi for t in terms], dim=2)    # (B, i, 3, j)
    tl = torch.stack([t.lo for t in terms], dim=2)
    acc = ddf.DD(torch.zeros_like(th[..., 0]), torch.zeros_like(th[..., 0]))
    for j in range(q.shape[1]):
        acc = ddf.fold_add(acc, ddf.DD(th[..., j], tl[..., j]))
    return ddf.join(ddf.fold_end(acc))


def accel_dd(q: torch.Tensor, gm: torch.Tensor, *,
             eps: float) -> torch.Tensor:
    """Accelerations (B, n, 3, 2) of q (B, n, 3, 2) under gm = G*m_eff
    (B, n, 2), all double-double.

    Scenario rows b never mix. CUDA tensors run kernel B4 and add one to
    `accel_dd.launches`; CPU tensors run `accel_dd_ref`."""
    _check(q, gm)
    if q.device.type == "cpu":
        return accel_dd_ref(q, gm, eps=eps)
    if q.device.type != "cuda":
        raise ValueError(f"accel_dd runs on cuda or cpu, not {q.device}")
    from . import _build

    lib = _build.load()
    a = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.accel_dd_launch(
            q.data_ptr(), gm.data_ptr(), a.data_ptr(), q.shape[0],
            q.shape[1], *eps2_dd(eps),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"accel_dd kernel launch failed: CUDA error {rc}")
    accel_dd.launches += 1
    return a


accel_dd.launches = 0
