"""Direct-summation scenario solvers: the three problems of the graded solve.

  * `run_problems_12` — Problem 1 (devices off) and Problem 2 (devices on)
    as a 2-row scenario batch. On the device it tracks the running min
    planet-asteroid d², the first hit step, each device's missile arrival
    step and the (q, v) snapshot at that arrival (hw5.cu:322-436).
  * `run_problem_3` — one row per eligible destroyed device, resumed from
    its arrival snapshot with that device's mass zeroed (hw5.cu:438-530):
    all rows as one batch, or one at a time in cost order (n >= 256).
  * `run_problems_123` — the three problems in one pass for small scenes:
    each Problem-3 row mirrors the Problem-2 row until its missile arrives.

Semantics are the serial spec's (native/core.cc): strict `<` for min, hit
and arrival; step 0 checked; no arrival at step 0 (the missile has covered
no distance). Decisions stay on the device: the host reads the hit step and
the Problem-3 flags once per `cfg.chunk_steps`, never per step. Each chunk
is one call of `ops/graded_step.graded_chunk`: on a card, one C call that
launches the graded step kernel once per step (force, Euler update and the
checks); on the CPU, the same steps as a loop of PyTorch ops. The loops
run exactly the steps there are (no masking of steps past the horizon).

`dtype` is the state's: float64 (the graded answer, kernel B1's force)
or float32 (the throughput mode, kernel B2's force, on a scene and config
the caller rescaled by powers of two, `utils/rescale`). Masses, the
oscillation table and every decision quantity (min d², r², the missile
radius, the step-0 checks) are then of that dtype too, with host
constants rounded to it first, as the JAX package's float32 path computes
them (nbody_tpu/models/direct_sum.py:483-508). A float32 run checks its
state for overflow once per chunk and raises FloatingPointError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimConfig
from ..io import Scene
from ..ops.forces import sq_dist
from ..ops.graded_step import P3, P12, P123, Carry, graded_chunk

F64 = torch.float64
_NP = {torch.float64: np.float64, torch.float32: np.float32}


def _t(a, device, dtype=None) -> torch.Tensor:
    """A host array on `device`, cast to the state's dtype on the host."""
    a = np.ascontiguousarray(a if dtype is None else
                             np.asarray(a, dtype=_NP[dtype]))
    return torch.as_tensor(a, device=device)


def _r2(cfg: SimConfig, dtype: torch.dtype) -> float:
    """The planet radius squared as the state's dtype holds it."""
    return float(_NP[dtype](cfg.planet_radius * cfg.planet_radius))


def _fst_table(fst: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """The host's libm oscillation table (physics.oscillation_table) as a
    device table of the state's dtype, indexed by the step."""
    return _t(fst, device, dtype)


def _md2_table(cfg: SimConfig, device, dtype: torch.dtype) -> torch.Tensor:
    """md² per step s = 0..n_steps, md = fl(fl(speed*dt) * s) in the
    state's dtype: the radius of the missile sphere squared (hw5.cu:270)."""
    t = _NP[dtype]
    md = t(cfg.missile_speed * cfg.dt) * np.arange(cfg.n_steps + 1, dtype=t)
    return _t(md * md, device)


def _guard_finite(*tensors, context: str) -> None:
    """Raise if a float32 run overflowed: compute_rescale's growth margin is
    a heuristic, and past it the state goes inf, then NaN, and every answer
    is garbage. One host read per chunk."""
    if not all(bool(torch.isfinite(x).all()) for x in tensors):
        raise FloatingPointError(
            f"non-finite simulation state {context}: the rescaled float32 "
            "run overflowed (orbital growth exceeded the rescale window, "
            "utils/rescale.py growth_margin); rerun with precision='f64'")


def _step0(scene: Scene, cfg: SimConfig, device, dtype: torch.dtype):
    """Step-0 min d² and hit (the loops check before any update,
    hw5.cu:368/387), computed on the host in the serial order and the
    state's dtype."""
    q = np.asarray(scene.q, dtype=_NP[dtype])
    d = q[scene.planet] - q[scene.asteroid]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    hit = 0 if d2 < _r2(cfg, dtype) else -2
    return (torch.tensor(d2, dtype=dtype, device=device),
            torch.tensor(hit, dtype=torch.int64, device=device))


def _masses(rows: np.ndarray, scene: Scene, device, dtype: torch.dtype):
    """Per-row base masses and device half-masses in the state's dtype:
    m_eff = m0 + m_half*fst is the spec's mj + 0.5*mj*fst (0.5*m and the
    0/1 mask are exact)."""
    rows = np.asarray(rows, dtype=_NP[dtype])
    m_half = 0.5 * rows * scene.device_mask().astype(_NP[dtype])[None, :]
    return _t(rows, device), _t(m_half, device)


def _others(scene: Scene, device) -> torch.Tensor:
    """The bodies the planet's distance is checked to: the asteroid, then
    the devices."""
    return _t(np.asarray([scene.asteroid, *scene.device_idx], np.int64),
              device)


def _min_dist(min_d2: torch.Tensor) -> float:
    """sqrt of the min d² in its own dtype, as the JAX package takes it."""
    return float(np.sqrt(min_d2.cpu().numpy()))


@dataclasses.dataclass
class P12Result:
    min_dist: float            # Problem 1 answer
    hit_time_step: int         # Problem 2 answer (-2 if never)
    arrivals: np.ndarray       # (D,) missile-arrival step per device, -2 if
    #                            never (or, after the P2 early exit, later
    #                            than the hit: both mean "cannot save")
    q_snaps: torch.Tensor      # (D, n, 3) devices-on state at each arrival
    v_snaps: torch.Tensor      # (D, n, 3)


def run_problems_12(scene: Scene, fst: np.ndarray, cfg: SimConfig, *,
                    device: torch.device, dtype: torch.dtype = F64
                    ) -> P12Result:
    """Problems 1+2 and the Problem-3 arrival snapshots.

    P2 early exit (hw5.cu:398-402, core.cc:202): once the host sees the
    hit at a chunk boundary, the devices-on row is dropped and the
    devices-off row marches alone to the horizon. Arrivals after the hit
    are ineligible for Problem 3 anyway, so every answer is unchanged."""
    c = _p12_carry(scene, fst, cfg, device, dtype)
    for t0 in range(0, cfg.n_steps, cfg.chunk_steps):
        # one host read per chunk: the P2 early exit
        if c.q.shape[0] == 2 and int(c.hit) != -2:
            c.q, c.v, c.m0, c.m_half = (x[:1] for x in
                                        (c.q, c.v, c.m0, c.m_half))
        s1 = min(t0 + cfg.chunk_steps, cfg.n_steps)
        graded_chunk(P12, c, t0, s1)
        if dtype == torch.float32:
            _guard_finite(c.q, c.min_d2, context=f"in P1/P2 after step {s1}")
    return P12Result(min_dist=_min_dist(c.min_d2),
                     hit_time_step=int(c.hit), arrivals=c.arr.cpu().numpy(),
                     q_snaps=c.q_snap, v_snaps=c.v_snap)


def run_problem_3(scene: Scene, p12: P12Result, fst: np.ndarray,
                  cfg: SimConfig, *, device: torch.device,
                  strategy: str = "auto", dtype: torch.dtype = F64
                  ) -> np.ndarray:
    """(D,) bool: True where destroying device k saves the planet.

    Only a device whose missile arrives (arrival != -2) no later than the
    hit step can save it (core.cc:216).

    strategy:
      'batched'    — every eligible scenario in one batch.
      'sequential' — one scenario at a time in (arrival, body index) order,
                     stopping at the first savior: cost grows with the
                     arrival step, so later ones cannot win (the
                     reference's PROBLEM3_BREAK pruning, hw5.cu:574-585).
      'auto'       — sequential for n >= 256, batched below.
    """
    D = scene.device_cnt
    saved = np.zeros((D,), dtype=bool)
    if D == 0:
        return saved
    eligible = (p12.arrivals != -2) & (p12.arrivals <= p12.hit_time_step)
    if strategy == "auto":
        strategy = "sequential" if scene.n >= 256 else "batched"
    if strategy == "batched":
        idx = np.nonzero(eligible)[0]
        if idx.size:
            saved[idx] = _run_p3_scenarios(scene, p12, fst, cfg, idx,
                                           device=device, dtype=dtype)
        return saved
    if strategy != "sequential":
        raise ValueError(f"unknown Problem-3 strategy {strategy!r}")
    order = sorted(np.nonzero(eligible)[0],
                   key=lambda k: (int(p12.arrivals[k]),
                                  int(scene.device_idx[k])))
    for k in order:
        saved[k] = _run_p3_scenarios(scene, p12, fst, cfg, np.asarray([k]),
                                     device=device, dtype=dtype)[0]
        if saved[k]:
            break
    return saved


def _run_p3_scenarios(scene: Scene, p12: P12Result, fst: np.ndarray,
                      cfg: SimConfig, idx: np.ndarray, *,
                      device: torch.device, dtype: torch.dtype
                      ) -> np.ndarray:
    """Resumed simulations for the eligible device slots `idx`; returns
    (len(idx),) bool: never hit from the arrival step to the horizon."""
    c = _p3_carry(scene, p12, fst, cfg, idx, device, dtype)
    cs = cfg.chunk_steps
    # skip-ahead: chunks before the earliest arrival leave every row frozen
    t0 = int(p12.arrivals[idx].min()) // cs * cs
    while not bool(c.hit.all()) and t0 < cfg.n_steps:  # read once per chunk
        s1 = min(t0 + cs, cfg.n_steps)
        graded_chunk(P3, c, t0, s1)
        t0 += cs
        if dtype == torch.float32:
            _guard_finite(c.q, context=f"in P3 after step {s1}")
    return ~c.hit.cpu().numpy()


@dataclasses.dataclass
class P123Result:
    min_dist: float
    hit_time_step: int
    arrivals: np.ndarray       # (D,) missile-arrival step per device
    saved: np.ndarray          # (D,) bool: destroying device k saves it


def run_problems_123(scene: Scene, fst: np.ndarray, cfg: SimConfig, *,
                     device: torch.device, dtype: torch.dtype = F64
                     ) -> P123Result:
    """Problems 1, 2 and 3 in one pass over rows [P1, P2, P3_0..P3_{D-1}].

    Each P3 row is overwritten with the P2 row's post-step state every
    step up to and including its missile's arrival (that copy is
    problem3_preprocess_gpu's snapshot, hw5.cu:265-287) and evolves on its
    own afterwards with its device's mass zeroed: the same arithmetic as the
    resumed simulation, so the answers equal the phased solvers' bit for
    bit while the horizon is walked once."""
    c = _p123_carry(scene, fst, cfg, device, dtype)
    for t0 in range(0, cfg.n_steps, cfg.chunk_steps):
        s1 = min(t0 + cfg.chunk_steps, cfg.n_steps)
        graded_chunk(P123, c, t0, s1)
        if dtype == torch.float32:
            _guard_finite(c.q, c.min_d2, context=f"in fused P1/P2/P3 after "
                                                 f"step {s1}")

    arr_h = c.arr.cpu().numpy()
    hit_h = int(c.hit)
    eligible = ((arr_h != -2) & (arr_h <= hit_h) if hit_h != -2
                else np.zeros(arr_h.shape, dtype=bool))
    return P123Result(min_dist=_min_dist(c.min_d2), hit_time_step=hit_h,
                      arrivals=arr_h, saved=eligible & ~c.p3_hit.cpu().numpy())


def _p12_carry(scene: Scene, fst: np.ndarray, cfg: SimConfig, device,
               dtype: torch.dtype) -> Carry:
    """Rows [P1 devices off, P2 devices on] at step 0."""
    n, D = scene.n, scene.device_cnt
    m_off = scene.m * (1.0 - scene.device_mask())
    m0, m_half = _masses(np.stack([m_off, scene.m]), scene, device, dtype)
    min_d2, hit = _step0(scene, cfg, device, dtype)
    return Carry(q=_t(np.stack([scene.q, scene.q]), device, dtype),
                 v=_t(np.stack([scene.v, scene.v]), device, dtype),
                 m0=m0, m_half=m_half, fst=_fst_table(fst, device, dtype),
                 others=_others(scene, device),
                 arr=torch.full((D,), -2, dtype=torch.int64, device=device),
                 hit=hit, planet=scene.planet, G=cfg.G, eps=cfg.eps,
                 dt=cfg.dt, r2=_r2(cfg, dtype),
                 md2=_md2_table(cfg, device, dtype), min_d2=min_d2,
                 q_snap=torch.zeros((D, n, 3), dtype=dtype, device=device),
                 v_snap=torch.zeros((D, n, 3), dtype=dtype, device=device))


def _p3_carry(scene: Scene, p12: P12Result, fst: np.ndarray, cfg: SimConfig,
              idx: np.ndarray, device, dtype: torch.dtype) -> Carry:
    """One row per device slot in `idx`, that device destroyed, at its
    arrival snapshot."""
    arrivals = p12.arrivals[idx]
    rows = np.tile(scene.m, (len(idx), 1))
    rows[np.arange(len(idx)), scene.device_idx[idx]] = 0.0  # destroyed
    m0, m_half = _masses(rows, scene, device, dtype)
    sel_idx = _t(idx, device)
    q = p12.q_snaps[sel_idx]
    r2 = _r2(cfg, dtype)
    # the resume step is checked on the snapshot before any update
    # (missile_cost_gpu, hw5.cu:292-298)
    hit = sq_dist(q[:, scene.planet], q[:, scene.asteroid]) < r2
    return Carry(q=q, v=p12.v_snaps[sel_idx], m0=m0, m_half=m_half,
                 fst=_fst_table(fst, device, dtype),
                 others=_t(np.asarray([scene.asteroid]), device),
                 arr=_t(arrivals, device), hit=hit, planet=scene.planet,
                 G=cfg.G, eps=cfg.eps, dt=cfg.dt, r2=r2)


def _p123_carry(scene: Scene, fst: np.ndarray, cfg: SimConfig, device,
                dtype: torch.dtype) -> Carry:
    """Rows [P1, P2, P3_0, ..., P3_{D-1}] at step 0."""
    D = scene.device_cnt
    m_rows = [scene.m * (1.0 - scene.device_mask()), scene.m]
    for k in range(D):
        mk = scene.m.copy()
        mk[int(scene.device_idx[k])] = 0.0
        m_rows.append(mk)
    m0, m_half = _masses(np.stack(m_rows), scene, device, dtype)
    R = 2 + D
    min_d2, hit = _step0(scene, cfg, device, dtype)
    return Carry(q=_t(np.stack([scene.q] * R), device, dtype),
                 v=_t(np.stack([scene.v] * R), device, dtype),
                 m0=m0, m_half=m_half, fst=_fst_table(fst, device, dtype),
                 others=_others(scene, device),
                 arr=torch.full((D,), -2, dtype=torch.int64, device=device),
                 hit=hit, planet=scene.planet, G=cfg.G, eps=cfg.eps,
                 dt=cfg.dt, r2=_r2(cfg, dtype),
                 md2=_md2_table(cfg, device, dtype), min_d2=min_d2,
                 p3_hit=torch.zeros((D,), dtype=torch.bool, device=device))
