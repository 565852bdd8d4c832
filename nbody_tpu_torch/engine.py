"""Scenario orchestration: the reference's `main` (hw5.cu:532-615).

`solve_scene` answers the three problems of a scene: through the fused
one-pass solver for small scenes with devices, otherwise through Problems
1+2 and then Problem 3. Selecting the winning device is O(device count)
host work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import DEFAULT_CONFIG, PRECISIONS, SimConfig
from .device import resolve_device
from .io import Scene
from .models.direct_sum import DD, run_problem_3, run_problems_12, \
    run_problems_123
from .ops.forces import check_dist3
from .physics import missile_cost_for_arrival, oscillation_table
from .utils.profiling import PhaseTimers
from .utils.rescale import IDENTITY, compute_rescale

# at most this many bodies, the fused solver walks the horizon once for all
# problems; above it the phased solvers skip the rows that are decided
FUSED_MAX_N = 128


@dataclasses.dataclass
class Answers:
    min_dist: float
    hit_time_step: int
    gravity_device_id: int   # original body index of the winning device, or -1
    missile_cost: float

    def as_tuple(self):
        return (self.min_dist, self.hit_time_step, self.gravity_device_id,
                self.missile_cost)


def select_winner(scene: Scene, arrivals: np.ndarray, saved: np.ndarray,
                  cfg: SimConfig):
    """The cheapest saving device as (original body index, cost), or
    (-1, 0.0) (hw5.cu:598-601). Cost grows with the arrival step; ties go
    to the earlier body in file order (hw5.cu:574-585, 512-517)."""
    best = (-1, 0.0)
    best_key = None
    for k in range(scene.device_cnt):
        if not saved[k]:
            continue
        cost = float(missile_cost_for_arrival(cfg, arrivals[k]))
        key = (cost, int(scene.device_idx[k]))
        if best_key is None or key < best_key:
            best_key = key
            best = (int(scene.device_idx[k]), cost)
    return best


def solve_scene(scene: Scene, cfg: SimConfig = DEFAULT_CONFIG, *,
                precision: str = "f64", device: str = "cuda",
                timers: PhaseTimers | None = None,
                checkpoint_path: str | None = None) -> Answers:
    """Answer all three problems for a scene.

    precision:
      'f64' — native IEEE binary64 on `device` with the serial ascending-j
              force fold (the fp64 graded step kernel on CUDA, kernel B1's
              force), bit-identical to native/core.cc in the same dist3
              mode: `cfg.dist3_mode` 'dsqrt' (the default) or 'sqrt3';
              'pow' is refused (libm's pow, which the native core calls,
              is reproduced by neither CUDA nor torch).
      'e64', 'dd', 'ddp', 'dd+' — the same path as 'f64'. On the TPU, which
              has no binary64, they are emulations that approach it: 'e64'
              a bit-exact softfloat, 'dd' XLA's double-double, 'ddp' (alias
              'dd+') triple-float32 forces on a binary64-rounded state. The
              card computes in binary64 what all of them approximate.
      'f32' — the throughput mode: float32 state on the scene rescaled by
              powers of two (utils/rescale; the graded scenes overflow
              float32), force kernel B2 over the scenario batch; the min
              distance is scaled back. Not answer-grade: its trajectories
              drift from binary64's, so a knife-edge answer may differ.
              One force form, whatever dist3_mode says.
      'tf3' — precision beyond binary64, the referee of a knife-edge answer:
              whether a graded answer comes from binary64's rounding. The
              JAX package carries triple-float32 (about 2^-70 an op), which
              a TPU needs for want of binary64; the card runs double-double
              binary64 (about 2^-104 an op, binary64's range, no rescale)
              through the double-double graded step kernel (kernel B4's
              force). The answers are rounded to binary64 at the end. One
              force form, whatever dist3_mode says.
      'exact' — the native serial core (libm pow unless dist3_mode says
              otherwise), on the host.
    device: 'cuda' (raises without a card) or 'cpu' (the plain PyTorch path).
    checkpoint_path: every driver saves its carry after each chunk and
    resumes from it (models/direct_sum.py); a resumed run is bitwise equal
    to one that never stopped. Not used by 'exact'.
    """
    if precision == "exact":
        from .native import solve_exact
        return Answers(*solve_exact(scene, cfg,
                                    dist3_mode=cfg.resolved_dist3("exact")))
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {precision}")
    rescale, run_scene, dtype = IDENTITY, scene, torch.float64
    run_cfg = dataclasses.replace(cfg, dist3_mode=cfg.resolved_dist3())
    if precision == "f32":
        rescale = compute_rescale(scene, eps=cfg.eps, G=cfg.G)
        run_scene = rescale.apply_scene(scene)
        run_cfg = rescale.apply_cfg(run_cfg)
        dtype = torch.float32
    elif precision == "tf3":
        dtype = DD
    else:
        check_dist3(cfg.dist3_mode, precision)
    dev = resolve_device(device)
    if timers is None:
        timers = PhaseTimers(dev)

    with timers.phase("oscillation_table"):
        fst = oscillation_table(cfg)
    if scene.device_cnt > 0 and scene.n <= FUSED_MAX_N:
        with timers.phase("problems_fused"):
            p123 = run_problems_123(run_scene, fst, run_cfg, device=dev,
                                    dtype=dtype,
                                    checkpoint_path=checkpoint_path)
        winner = (-1, 0.0)
        if p123.hit_time_step != -2:
            winner = select_winner(scene, p123.arrivals, p123.saved, cfg)
        return Answers(rescale.unscale_length(p123.min_dist),
                       p123.hit_time_step, *winner)

    with timers.phase("problem_1_2"):
        p12 = run_problems_12(run_scene, fst, run_cfg, device=dev,
                              dtype=dtype, checkpoint_path=checkpoint_path)
    winner = (-1, 0.0)
    if p12.hit_time_step != -2 and scene.device_cnt > 0:
        with timers.phase("problem_3"):
            saved = run_problem_3(run_scene, p12, fst, run_cfg, device=dev,
                                  dtype=dtype,
                                  checkpoint_path=checkpoint_path)
        winner = select_winner(scene, p12.arrivals, saved, cfg)
    return Answers(rescale.unscale_length(p12.min_dist), p12.hit_time_step,
                   *winner)
