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
rows never mix. Both sum in the kernel's order: each 128-wide tile of
sources folded from 0 in ascending j, the tile sums added from 0 in
ascending order, as the TPU kernel adds its tile sums. So the plain version
has the kernel's bits wherever its rsqrt has rsqrtf's (on the CPU,
torch.rsqrt rounds otherwise), and a source block that is a whole number of
tiles can be summed on its own and its sum added in order: the ordered ring
of the mesh (parallel/sharded.py) gives this force's bits at tile 128. A
source of zero mass adds a +-0 term, which no partial sum (never -0: it
starts at +0 and rounds to nearest) notices, so zero-mass padding changes
no bit.
"""

from __future__ import annotations

import numpy as np
import torch

# kernel B2's source tile (csrc/accel_f32.cu TJ), the plain version's too
TILE_J = 128
# pairs a plain call holds at once when it folds every tile side by side;
# above it, it walks the tiles one at a time (the same bits either way)
_PAIRS_AT_ONCE = 1 << 22
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
    or float64 for a reference of it), batched or not as `accel_f32`: each
    tile of `tile_j` sources folded from 0 in ascending j, the tile sums
    added from 0 in ascending order. The last tile is padded with sources
    of zero mass (their +-0 terms change no sum). Small shapes fold all
    tiles side by side; above _PAIRS_AT_ONCE pairs the tiles go one at a
    time, so memory stays O(B * ni * tile_j)."""
    eps2 = eps2_f32(eps)
    nj = qj.shape[-2]
    tiles = -(-nj // tile_j)
    if tiles == 1:
        tile_j = nj             # one tile: no padding to fold
    pad = tiles * tile_j - nj
    if pad:
        qj = torch.cat([qj, qj.new_zeros(qj.shape[:-2] + (pad, 3))], dim=-2)
        gmj = torch.cat([gmj, gmj.new_zeros(gmj.shape[:-1] + (pad,))],
                        dim=-1)
    qi3 = qi[..., :, None, :]                          # (.., ni, 1, 3)

    def tile_sums(j0: int, k: int) -> torch.Tensor:
        """The sums (.., ni, k, 3) of tiles j0 / tile_j .. + k - 1, each
        folded from 0 in ascending j."""
        qt = qj[..., j0:j0 + k * tile_j, :].unflatten(-2, (k, tile_j))
        gt = gmj[..., j0:j0 + k * tile_j].unflatten(-1, (k, tile_j))
        # column jj of every tile first: (T, .., 1, k, 3) and (T, .., 1, k)
        qt = qt.movedim(-2, 0).unsqueeze(-3)
        gt = gt.movedim(-1, 0).unsqueeze(-2)
        dq = qt - qi3                                 # (T, .., ni, k, 3)
        dx, dy, dz = dq[..., 0], dq[..., 1], dq[..., 2]
        d2 = ((dx * dx + dy * dy) + dz * dz) + eps2
        inv = torch.rsqrt(d2)
        w = gt * ((inv * inv) * inv)                  # (T, .., ni, k)
        t = w[..., None] * dq
        part = torch.zeros_like(t[0])
        for jj in range(tile_j):
            part = part + t[jj]
        return part

    B = qi[..., 0, 0].numel()
    at_once = tiles if B * qi.shape[-2] * tiles * tile_j <= _PAIRS_AT_ONCE \
        else 1
    acc = torch.zeros_like(qi)
    for k0 in range(0, tiles, at_once):
        part = tile_sums(k0 * tile_j, min(at_once, tiles - k0))
        for k in range(part.shape[-2]):
            acc = acc + part[..., k, :]
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


def accel_f32_ordered(qi: torch.Tensor, qj: torch.Tensor,
                      gmj: torch.Tensor, *, eps: float, tile: int,
                      force=accel_f32) -> torch.Tensor:
    """The mesh's ordered float32 sum at tile T (parallel/sharded.py
    ring_accel_ordered's, in one process): `force(qi, qj_g, gm_g)` (kernel
    B2's cross form, or its plain version) of each group of `tile`
    sources from 0 (the last one ragged), added from 0 in ascending group
    order. At tile 128, or a tile of all nj sources, that is B2's own sum:
    one call."""
    nj = qj.shape[-2]
    if tile == TILE_J or tile >= nj:
        return force(qi, qj, gmj, eps=eps)
    acc = torch.zeros_like(qi)
    for j in range(0, nj, tile):
        acc = acc + force(qi, qj[..., j:j + tile, :].contiguous(),
                          gmj[..., j:j + tile].contiguous(), eps=eps)
    return acc


def accel_f32_self(q: torch.Tensor, gm: torch.Tensor, *,
                   eps: float) -> torch.Tensor:
    """All-pairs accelerations of q (B, n, 3) under gm (B, n), or of one
    unbatched scene: accel_f32(q, q, gm)."""
    return accel_f32(q, q, gm, eps=eps)
