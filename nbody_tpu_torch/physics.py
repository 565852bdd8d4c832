"""Physics on the host: oscillation table and missile cost.

Mirrors the reference's `namespace param` functions (hw5.cu:55-67,
samples/nbody.cc:14-19) with the same fp64 operation order, so results are
bit-comparable to the serial spec.
"""

from __future__ import annotations

import math

import numpy as np

from .config import SimConfig


def oscillation_table(cfg: SimConfig, n_steps: int | None = None) -> np.ndarray:
    """|sin(step*dt / period)| for step = 0..n_steps inclusive.

    Computed on the host with math.sin (libm, like the C++ spec) and
    uploaded: CUDA's device `sin` is not libm's and would move the device
    masses by an ulp.
    """
    if n_steps is None:
        n_steps = cfg.n_steps
    out = np.empty(n_steps + 1, dtype=np.float64)
    for s in range(n_steps + 1):
        # samples/nbody.cc:63: t = step * dt; :15: sin(t / 6000)
        out[s] = abs(math.sin((s * cfg.dt) / cfg.device_mass_period))
    return out


def missile_cost_for_arrival(cfg: SimConfig, arrival_step) -> float:
    """Cost when the missile arrives at `arrival_step`: the reference charges
    get_missile_cost((step+1)*dt) (hw5.cu:305), 1e5 + 1e3*(step+1)*dt."""
    t = (np.asarray(arrival_step, dtype=np.float64) + 1.0) * cfg.dt
    return cfg.missile_cost_base + cfg.missile_cost_per_t * t


def missile_travel_distance(cfg: SimConfig, step):
    """Distance the missile has covered by `step`: (speed*dt)*step
    (hw5.cu:273). speed*dt = 6e7 is exactly representable."""
    return (cfg.missile_speed * cfg.dt) * step
