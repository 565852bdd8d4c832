"""Building blocks of the serial-fold fp64 contract
(`nbody_tpu.ops.forces.pairwise_accel_e64(fold='serial')`).

Two PyTorch habits break bit equality with the serial core and are avoided
on the whole fp64 path:

  * `torch.sqrt` on float64 CPU tensors is not correctly rounded: against
    `math.sqrt`, 156 of 20,000 random inputs came out 1 ulp off, under every
    ATEN_CPU_CAPABILITY (measured with torch 2.13.0+cpu). `np.sqrt` is
    correctly rounded, so `_sqrt_rn` routes CPU tensors through it. On CUDA,
    double `sqrt` is IEEE round-to-nearest.
  * `torch.sum` is not a left-to-right fold, so squared distances are
    written out as ((dx*dx + dy*dy) + dz*dz), the order of core.cc:80-85.
"""

from __future__ import annotations

import numpy as np
import torch


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a float64 tensor on its device."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def sq_dist(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """|qa - qb|^2 over the last axis (size 3) in the serial spec's order
    dx*dx + dy*dy + dz*dz (samples/nbody.cc:118-121, core.cc:80-85)."""
    d = qa - qb
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz
