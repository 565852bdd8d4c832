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
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


# the binary64 kernels' forms of d2^1.5, by native/core.cc's mode numbers
# (csrc/forces.cuh Dist3)
DIST3_CODES = {"dsqrt": 1, "sqrt3": 2}
POW_REFUSED = (
    "the binary64 paths on the card form d2^1.5 as 'dsqrt' (d2*sqrt(d2)) or "
    "'sqrt3' (sqrt((d2*d2)*d2)), each correctly rounded op by op and so "
    "bit-equal to the native core; 'pow' is refused: libm's pow, which the "
    "native core calls, is reproduced by neither CUDA's pow nor torch's, so "
    "its answers would differ from the native core's (use precision 'exact' "
    "for pow)")


def check_dist3(mode: str | None, precision: str) -> str:
    """The binary64 paths' form of d2^1.5 for a config's dist3_mode (None
    means dsqrt); raises ValueError for 'pow' or an unknown form."""
    mode = "dsqrt" if mode is None else mode
    if mode not in DIST3_CODES:
        raise ValueError(f"precision {precision!r} takes dist3_mode 'dsqrt' "
                         f"or 'sqrt3', not {mode!r}: {POW_REFUSED}")
    return mode


def dist3(d2: torch.Tensor, mode: str) -> torch.Tensor:
    """d2^1.5 of a float64 tensor in the binary64 kernels' form `mode`:
    d2 * sqrt(d2), or sqrt((d2 * d2) * d2), left to right."""
    if mode == "dsqrt":
        return d2 * _sqrt_rn(d2)
    if mode == "sqrt3":
        return _sqrt_rn((d2 * d2) * d2)
    raise ValueError(f"unknown dist3 form {mode!r}: {POW_REFUSED}")


def sq_dist(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """|qa - qb|^2 over the last axis (size 3) in the serial spec's order
    dx*dx + dy*dy + dz*dz (samples/nbody.cc:118-121, core.cc:80-85)."""
    d = qa - qb
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz
