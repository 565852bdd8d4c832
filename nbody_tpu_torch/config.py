"""Runtime configuration.

The reference hard-codes physics constants in `namespace param`
(hw5.cu:50-82, samples/nbody.cc:9-20). Here they are a runtime dataclass
whose defaults are bit-identical to the reference's `param` values and to
`nbody_tpu.config.SimConfig`'s physics fields.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics + engine configuration (defaults mirror hw5.cu:50-67)."""

    # --- physics (reference param namespace) ---
    n_steps: int = 200000          # hw5.cu:51
    dt: float = 60.0               # hw5.cu:52
    eps: float = 1e-3              # hw5.cu:53
    G: float = 6.674e-11           # hw5.cu:54
    planet_radius: float = 1e7     # hw5.cu:65
    missile_speed: float = 1e6     # hw5.cu:66
    # missile cost = cost_base + cost_per_t * t   (hw5.cu:67)
    missile_cost_base: float = 1e5
    missile_cost_per_t: float = 1e3
    # device mass m(t) = m0 + 0.5*m0*|sin(t / period)|   (hw5.cu:58)
    device_mass_period: float = 6000.0

    # --- numerics ---
    # How (d2)^1.5 is computed. None resolves per engine path: 'pow' for the
    # native exact mode (the golden generator's serial semantics) and
    # 'dsqrt' (d2*sqrt(d2)) for the binary64 device path, which also takes
    # 'sqrt3' (sqrt((d2*d2)*d2)): both are correctly rounded IEEE ops alone,
    # so the CUDA kernels and the native core agree bit for bit in either.
    # It refuses 'pow' (libm's pow, which neither CUDA nor torch
    # reproduces). 'f32' and 'tf3' have one force form each and ignore it.
    dist3_mode: str | None = None  # None | 'pow' | 'dsqrt' | 'sqrt3'

    def resolved_dist3(self, precision: str = "f64") -> str:
        if self.dist3_mode is not None:
            return self.dist3_mode
        return "pow" if precision == "exact" else "dsqrt"

    # --- engine knobs ---
    # Steps between host reads of the on-device decision tensors (hit step,
    # arrivals, Problem-3 flags); the reference syncs its break flag every
    # n_sync_steps=2000 steps (hw5.cu:69, 398).
    chunk_steps: int = 2000


DEFAULT_CONFIG = SimConfig()

# the graded solve's precisions (engine.solve_scene says what each means)
PRECISIONS = ("f64", "e64", "dd", "ddp", "dd+", "f32", "tf3", "exact")
