"""All-pairs accelerations in double-double binary64: precision 'tf3'.

`accel_dd` is the wrapper of kernel B4 (csrc/accel_dd.cu), the port of
`nbody_tpu.ops.forces.pairwise_accel_tf3`: the same physics beyond
binary64, with a pair of doubles (about 106 bits) where the TPU carries
three float32 words. On a CUDA tensor it launches the kernel or raises;
only a tensor that lies on the CPU goes to the plain version `accel_dd_ref`.
Both compute, bit for bit (ops/ddfloat and csrc/dd.cuh run the same
operations), for rows qi against sources qj:

    dx = qj_j - qi_i;  d2 = ((dx*dx + dy*dy) + dz*dz) + eps^2
    a_i = fold over ascending j of (gm_j / (d2 * sqrt(d2))) * dx

with eps^2 = two_prod(eps, eps), gm = G * m_eff formed by the caller, and
the fold of `ddfloat.fold_add`. `accel_dd_self(q, gm)` is
`accel_dd(q, q, gm)`, the all-pairs force, whose j == i term is 0 and is
folded unmasked. A row's fold depends on nothing but its own position and
the sources, so row blocks through the cross form give the self form's
bits (the mesh's 'tf3', parallel/solver_sharded.py).
"""

from __future__ import annotations

import torch

from . import ddfloat as ddf


def _check(qi: torch.Tensor, qj: torch.Tensor, gm: torch.Tensor) -> None:
    if not qi.dtype == qj.dtype == gm.dtype == torch.float64:
        raise TypeError(f"accel_dd takes double-double as float64 tensors, "
                        f"got qi {qi.dtype}, qj {qj.dtype} and gm {gm.dtype}")
    if (qi.dim() != 4 or qj.dim() != 4 or qi.shape[-2:] != (3, 2)
            or qj.shape[-2:] != (3, 2) or qi.shape[0] != qj.shape[0]
            or gm.shape != (*qj.shape[:2], 2)):
        raise ValueError(f"accel_dd takes qi (B, ni, 3, 2), qj (B, nj, 3, 2) "
                         f"and gm (B, nj, 2), got {tuple(qi.shape)}, "
                         f"{tuple(qj.shape)} and {tuple(gm.shape)}")
    if qi.shape[0] == 0 or qi.shape[1] == 0 or qj.shape[1] == 0:
        raise ValueError(f"accel_dd takes B, ni, nj >= 1, got "
                         f"{tuple(qi.shape)} and {tuple(qj.shape)}")
    if not qi.device == qj.device == gm.device:
        raise ValueError(f"qi on {qi.device}, qj on {qj.device}, gm on "
                         f"{gm.device}")
    if not (qi.is_contiguous() and qj.is_contiguous()
            and gm.is_contiguous()):
        raise ValueError("accel_dd takes contiguous tensors")


def eps2_dd(eps: float) -> tuple[float, float]:
    """eps^2 as the exact double-double two_prod(eps, eps), (hi, lo), in
    Python floats (binary64)."""
    p = ddf.two_prod(float(eps), float(eps))
    return p.hi, p.lo


def accel_dd_ref(qi: torch.Tensor, qj: torch.Tensor, gm: torch.Tensor, *,
                 eps: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: every pair term at once, then the
    fold over j in ascending order. qi (B, ni, 3, 2), qj (B, nj, 3, 2),
    gm (B, nj, 2)."""
    Qi, Qj, g = ddf.split(qi), ddf.split(qj), ddf.split(gm)
    eps2 = ddf.DD(*(torch.tensor(x, dtype=torch.float64, device=qi.device)
                    for x in eps2_dd(eps)))
    # (B, i, j) differences qj_j - qi_i of each component
    dq = [ddf.sub(ddf.DD(Qj.hi[:, None, :, c], Qj.lo[:, None, :, c]),
                  ddf.DD(Qi.hi[:, :, None, c], Qi.lo[:, :, None, c]))
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
    for j in range(qj.shape[1]):
        acc = ddf.fold_add(acc, ddf.DD(th[..., j], tl[..., j]))
    return ddf.join(ddf.fold_end(acc))


def accel_dd(qi: torch.Tensor, qj: torch.Tensor, gm: torch.Tensor, *,
             eps: float) -> torch.Tensor:
    """Accelerations (B, ni, 3, 2) of rows qi (B, ni, 3, 2) from sources qj
    (B, nj, 3, 2) under gm = G*m_eff (B, nj, 2), all double-double.

    Scenario rows b never mix. CUDA tensors run kernel B4 and add one to
    `accel_dd.launches`; CPU tensors run `accel_dd_ref`."""
    _check(qi, qj, gm)
    if qi.device.type == "cpu":
        return accel_dd_ref(qi, qj, gm, eps=eps)
    if qi.device.type != "cuda":
        raise ValueError(f"accel_dd runs on cuda or cpu, not {qi.device}")
    from . import _build

    lib = _build.load()
    a = torch.empty_like(qi)
    with torch.cuda.device(qi.device):
        rc = lib.accel_dd_launch(
            qi.data_ptr(), qj.data_ptr(), gm.data_ptr(), a.data_ptr(),
            qi.shape[0], qi.shape[1], qj.shape[1], *eps2_dd(eps),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"accel_dd kernel launch failed: CUDA error {rc}")
    accel_dd.launches += 1
    return a


accel_dd.launches = 0


def accel_dd_self(q: torch.Tensor, gm: torch.Tensor, *,
                  eps: float) -> torch.Tensor:
    """All-pairs accelerations of q (B, n, 3, 2) under gm (B, n, 2):
    accel_dd(q, q, gm)."""
    return accel_dd(q, q, gm, eps=eps)
