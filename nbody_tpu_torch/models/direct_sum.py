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

`dtype` is the state's representation: float64 (the graded answer, kernel
B1's force, d2^1.5 in `cfg.dist3_mode`'s form), float32 (the throughput
mode, kernel B2's force, on a scene and config the caller rescaled by
powers of two, `utils/rescale`) or `DD`, double-double (precision 'tf3',
kernel B4's force, on the raw scene). Masses, the oscillation table and
every decision quantity (min d², r², the missile radius, the step-0
checks) are then of that representation too, with host constants rounded
to it first, as the JAX package's float32 and tf3 paths compute them
(nbody_tpu/models/direct_sum.py:246-258, 483-508). A float32 run checks
its state for overflow once per chunk and raises FloatingPointError.

`checkpoint_path`: each driver saves its whole carry after every chunk and
resumes from the file if it exists (the JAX package's format and
semantics, nbody_tpu/models/direct_sum.py:538-623, 748-800, 912-986): a
resumed run is bitwise equal to one that never stopped. Problem 3 keeps
sidecars, `<path>.p3.npz` (the running scenarios) and
`<path>.p3progress.json` (the finished ones of the sequential strategy).
A checkpoint of another scene, config, representation or driver, or one
beyond the horizon, is refused with ValueError.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from ..config import SimConfig
from ..io import Scene
from ..ops import ddfloat as ddf
from ..ops.graded_step import P3, P12, P123, Carry, arith, graded_chunk, \
    is_dd
from ..utils.checkpoint import load_checkpoint, save_checkpoint

F64 = torch.float64
DD = ddf.NAME          # the double-double representation, as a dtype
_NP = {torch.float64: np.float64, torch.float32: np.float32, DD: np.float64}


def _t(a, device, dtype=None) -> torch.Tensor:
    """A host array on `device`, cast to the state's dtype on the host
    (double-double: the binary64 value, lo = 0)."""
    if dtype == DD:
        return ddf.from_f64(np.ascontiguousarray(a, np.float64)).to(device)
    a = np.ascontiguousarray(a if dtype is None else
                             np.asarray(a, dtype=_NP[dtype]))
    return torch.as_tensor(a, device=device)


def _r2(cfg: SimConfig, dtype):
    """The planet radius squared as the state's representation holds it:
    for double-double the exact product, (hi, lo)."""
    if dtype == DD:
        pr = torch.tensor(cfg.planet_radius, dtype=torch.float64)
        p = ddf.two_prod(pr, pr)
        return float(p.hi), float(p.lo)
    return float(_NP[dtype](cfg.planet_radius * cfg.planet_radius))


def _fst_table(fst: np.ndarray, device, dtype) -> torch.Tensor:
    """The host's libm oscillation table (physics.oscillation_table) as a
    device table of the state's dtype, indexed by the step."""
    return _t(fst, device, dtype)


def _md2_table(cfg: SimConfig, device, dtype) -> torch.Tensor:
    """md² per step s = 0..n_steps, md = fl(fl(speed*dt) * s) in the
    state's dtype: the radius of the missile sphere squared (hw5.cu:270).
    Double-double: md = fl64(speed*dt) * s and md² in double-double, as the
    JAX package's tf3 drivers form them."""
    t = _NP[dtype]
    if dtype == DD:
        s = torch.arange(cfg.n_steps + 1, dtype=torch.float64)
        md = ddf.two_prod(torch.full_like(s, cfg.missile_speed * cfg.dt), s)
        return ddf.join(ddf.mul(md, md)).to(device)
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


def _step0(scene: Scene, cfg: SimConfig, device, dtype):
    """Step-0 min d² and hit (the loops check before any update,
    hw5.cu:368/387), computed on the host in the serial order and the
    state's dtype."""
    if dtype == DD:
        q = ddf.split(_t(scene.q, "cpu", DD))
        d2 = ddf.sq_dist(ddf.DD(q.hi[scene.planet], q.lo[scene.planet]),
                         ddf.DD(q.hi[scene.asteroid], q.lo[scene.asteroid]))
        r2 = ddf.DD(*(torch.tensor(x, dtype=torch.float64)
                      for x in _r2(cfg, DD)))
        hit = 0 if bool(ddf.lt(d2, r2)) else -2
        return (ddf.join(d2).to(device),
                torch.tensor(hit, dtype=torch.int64, device=device))
    q = np.asarray(scene.q, dtype=_NP[dtype])
    d = q[scene.planet] - q[scene.asteroid]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    hit = 0 if d2 < _r2(cfg, dtype) else -2
    return (torch.tensor(d2, dtype=dtype, device=device),
            torch.tensor(hit, dtype=torch.int64, device=device))


def _masses(rows: np.ndarray, scene: Scene, device, dtype):
    """Per-row base masses and device half-masses in the state's dtype:
    m_eff = m0 + m_half*fst is the spec's mj + 0.5*mj*fst (0.5*m and the
    0/1 mask are exact)."""
    rows = np.asarray(rows, dtype=_NP[dtype])
    m_half = 0.5 * rows * scene.device_mask().astype(_NP[dtype])[None, :]
    return _t(rows, device, dtype), _t(m_half, device, dtype)


def _others(scene: Scene, device) -> torch.Tensor:
    """The bodies the planet's distance is checked to: the asteroid, then
    the devices."""
    return _t(np.asarray([scene.asteroid, *scene.device_idx], np.int64),
              device)


def _min_dist(min_d2: torch.Tensor) -> float:
    """sqrt of the min d² in its own dtype, as the JAX package takes it;
    double-double: the double-double root rounded to binary64."""
    if is_dd(min_d2):
        m = ddf.split(min_d2.cpu())
        if not float(m.hi) > 0.0:
            return float(np.sqrt(float(m.hi)))
        return float(ddf.to_f64(ddf.join(ddf.sqrt(m))))
    return float(np.sqrt(min_d2.cpu().numpy()))


def _fingerprint(scene: Scene, cfg: SimConfig, dtype) -> str:
    """The JAX package's digest of what gives a solver carry its meaning
    (nbody_tpu/models/direct_sum.py:86-101), over the scene and config the
    driver runs. n_steps is left out: a carry at step t is valid for any
    horizon >= t, so a truncated run resumes into the full horizon. Each
    representation has its own name ('float64', 'float32',
    'double-double'), so the JAX package's 'tf3' carries are refused. An
    unset dist3_mode is the dsqrt it resolves to."""
    h = hashlib.sha256()
    for arr in (scene.q, scene.v, scene.m, np.asarray(scene.device_idx)):
        h.update(np.ascontiguousarray(arr).tobytes())
    name = dtype if isinstance(dtype, str) else np.dtype(_NP[dtype]).name
    h.update(repr((scene.n, scene.planet, scene.asteroid, cfg.dt, cfg.eps,
                   cfg.G, cfg.planet_radius, cfg.missile_speed,
                   cfg.dist3_mode or "dsqrt", name,
                   dtype == torch.float32)).encode())
    return h.hexdigest()


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _restore(x: np.ndarray, like: torch.Tensor, name: str,
             path: str) -> torch.Tensor:
    """A checkpointed array as a tensor of `like`'s dtype on its device;
    refuses a shape other than the carry's."""
    if x.shape[1:] != tuple(like.shape[1:]):
        raise ValueError(f"checkpoint {path}: {name} has shape {x.shape}, "
                         f"the carry {tuple(like.shape)}; refusing to resume")
    return torch.as_tensor(np.ascontiguousarray(x)).to(like.device,
                                                       like.dtype)


def _load(path: str, fingerprint: str, n_steps: int):
    """(step, q, v, extra, meta) of an existing checkpoint written for
    `fingerprint`, no later than the horizon; None if there is none."""
    if not os.path.exists(path):
        return None
    step, q, v, extra, meta = load_checkpoint(path)
    if meta.get("fingerprint") != fingerprint:
        raise ValueError(f"checkpoint {path} was written for a different "
                         "scene/config/precision/solver phase path; refusing "
                         "to resume (delete it or pass a fresh path)")
    if int(step) > n_steps:
        raise ValueError(f"checkpoint {path} is at step {step}, beyond this "
                         f"run's horizon n_steps={n_steps}")
    return int(step), q, v, extra, meta


@dataclasses.dataclass
class P12Result:
    min_dist: float            # Problem 1 answer
    hit_time_step: int         # Problem 2 answer (-2 if never)
    arrivals: np.ndarray       # (D,) missile-arrival step per device, -2 if
    #                            never (or, after the P2 early exit, later
    #                            than the hit: both mean "cannot save")
    q_snaps: torch.Tensor      # (D, n, 3) devices-on state at each arrival
    v_snaps: torch.Tensor      # (D, n, 3)


def _chunks(t0: int, cfg: SimConfig):
    """(s0, s1) of the chunks from step t0 to the horizon, on the grid of
    cfg.chunk_steps (a resumed run keeps the uninterrupted run's chunks)."""
    cs = cfg.chunk_steps
    while t0 < cfg.n_steps:
        s1 = min((t0 // cs + 1) * cs, cfg.n_steps)
        yield t0, s1
        t0 = s1


def run_problems_12(scene: Scene, fst: np.ndarray, cfg: SimConfig, *,
                    device: torch.device, dtype=F64,
                    checkpoint_path: str | None = None) -> P12Result:
    """Problems 1+2 and the Problem-3 arrival snapshots.

    P2 early exit (hw5.cu:398-402, core.cc:202): once the host sees the
    hit at a chunk boundary, the devices-on row is dropped and the
    devices-off row marches alone to the horizon. Arrivals after the hit
    are ineligible for Problem 3 anyway, so every answer is unchanged.

    checkpoint_path: the carry is saved after every chunk (phase 'p12',
    or 'p1' once the devices-on row is dropped) and resumed from."""
    c = _p12_carry(scene, fst, cfg, device, dtype)
    t0, fingerprint = 0, None
    if checkpoint_path is not None:
        fingerprint = _fingerprint(scene, cfg, dtype)
        saved = _load(checkpoint_path, fingerprint, cfg.n_steps)
        if saved is not None:
            t0, q, v, extra, _ = saved
            if q.shape[0] == 1:     # after the P2 early exit: P1 alone
                c.m0, c.m_half = c.m0[:1], c.m_half[:1]
            c.q = _restore(q, c.q, "q", checkpoint_path)
            c.v = _restore(v, c.v, "v", checkpoint_path)
            for name in ("min_d2", "hit", "arr", "q_snap", "v_snap"):
                like = getattr(c, name)
                setattr(c, name, _restore(extra[name][None], like[None],
                                          name, checkpoint_path)[0])
    for s0, s1 in _chunks(t0, cfg):
        # one host read per chunk: the P2 early exit
        if c.q.shape[0] == 2 and int(c.hit) != -2:
            c.q, c.v, c.m0, c.m_half = (x[:1] for x in
                                        (c.q, c.v, c.m0, c.m_half))
        graded_chunk(P12, c, s0, s1)
        if dtype == torch.float32:
            _guard_finite(c.q, c.min_d2, context=f"in P1/P2 after step {s1}")
        if checkpoint_path is not None:
            save_checkpoint(
                checkpoint_path, step=s1, q=_host(c.q), v=_host(c.v),
                extra={"min_d2": _host(c.min_d2),
                       "hit": _host(c.hit).astype(np.int32),
                       "arr": _host(c.arr).astype(np.int32),
                       "q_snap": _host(c.q_snap),
                       "v_snap": _host(c.v_snap)},
                meta={"n_steps": cfg.n_steps, "fingerprint": fingerprint,
                      "phase": "p1" if c.q.shape[0] == 1 else "p12"})
    return P12Result(min_dist=_min_dist(c.min_d2),
                     hit_time_step=int(c.hit), arrivals=c.arr.cpu().numpy(),
                     q_snaps=c.q_snap, v_snaps=c.v_snap)


def run_problem_3(scene: Scene, p12: P12Result, fst: np.ndarray,
                  cfg: SimConfig, *, device: torch.device,
                  strategy: str = "auto", dtype=F64,
                  checkpoint_path: str | None = None) -> np.ndarray:
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

    checkpoint_path: the running scenarios' carry goes to
    `<path>.p3.npz` after every chunk, and the sequential strategy records
    each finished scenario in `<path>.p3progress.json`.
    """
    D = scene.device_cnt
    saved = np.zeros((D,), dtype=bool)
    if D == 0:
        return saved
    eligible = (p12.arrivals != -2) & (p12.arrivals <= p12.hit_time_step)
    if strategy == "auto":
        strategy = "sequential" if scene.n >= 256 else "batched"
    if strategy not in ("batched", "sequential"):
        raise ValueError(f"unknown Problem-3 strategy {strategy!r}")
    ck = None
    if checkpoint_path is not None:
        ck = (checkpoint_path + ".p3.npz", _fingerprint(scene, cfg, dtype))
    if strategy == "batched":
        idx = np.nonzero(eligible)[0]
        if idx.size:
            saved[idx] = _run_p3_scenarios(scene, p12, fst, cfg, idx,
                                           device=device, dtype=dtype, ck=ck)
        return saved
    # finished scenarios: {k: (saved, horizon)}. A hit is final at any
    # horizon; "never hit" only up to the horizon it was reached at, so a
    # truncated run's saviours are run again to a longer horizon
    done: dict = {}
    progress = None
    if ck is not None:
        progress = checkpoint_path + ".p3progress.json"
        if os.path.exists(progress):
            with open(progress) as f:
                rec = json.load(f)
            if rec.get("fingerprint") != ck[1]:
                raise ValueError(f"P3 progress file {progress} was written "
                                 "for a different scene/config/precision; "
                                 "refusing to resume")
            horizon = int(rec.get("n_steps", cfg.n_steps))
            done = {int(k): (bool(v), horizon)
                    for k, v in rec["results"].items()
                    if not v or horizon == cfg.n_steps}
    order = sorted(np.nonzero(eligible)[0],
                   key=lambda k: (int(p12.arrivals[k]),
                                  int(scene.device_idx[k])))
    for k in order:
        if int(k) in done:
            saved[k] = done[int(k)][0]
        else:
            saved[k] = _run_p3_scenarios(scene, p12, fst, cfg,
                                         np.asarray([k]), device=device,
                                         dtype=dtype, ck=ck)[0]
            if progress is not None:
                # the finished scenario's state file goes before it is
                # recorded: the other order could leave, after a crash in
                # between, a state file of a scenario the record skips
                if os.path.exists(ck[0]):
                    os.remove(ck[0])
                done[int(k)] = (bool(saved[k]), cfg.n_steps)
                with open(progress, "w") as f:
                    json.dump({"fingerprint": ck[1], "n_steps": cfg.n_steps,
                               "results": {str(i): v for i, (v, _)
                                           in done.items()}}, f)
        if saved[k]:
            break
    return saved


def _run_p3_scenarios(scene: Scene, p12: P12Result, fst: np.ndarray,
                      cfg: SimConfig, idx: np.ndarray, *,
                      device: torch.device, dtype,
                      ck: tuple[str, str] | None = None) -> np.ndarray:
    """Resumed simulations for the eligible device slots `idx`; returns
    (len(idx),) bool: never hit from the arrival step to the horizon.
    ck = (path, fingerprint): the carry is saved there after every chunk,
    under the count of chunks begun (the JAX package's layout) with the
    step it stands at in meta 't', and resumed from."""
    c = _p3_carry(scene, p12, fst, cfg, idx, device, dtype)
    cs = cfg.chunk_steps
    # skip-ahead: chunks before the earliest arrival leave every row frozen
    t0 = int(p12.arrivals[idx].min()) // cs * cs
    idx_key = [int(i) for i in idx]
    if ck is not None and os.path.exists(ck[0]):
        step, q, v, extra, meta = load_checkpoint(ck[0])
        if meta.get("fingerprint") != ck[1] or meta.get("idx") != idx_key:
            raise ValueError(f"P3 checkpoint {ck[0]} was written for a "
                             "different scene/config/precision/scenario set; "
                             "refusing to resume")
        t0 = int(meta.get("t", int(step) * cs))
        if t0 > cfg.n_steps:
            raise ValueError(f"P3 checkpoint {ck[0]} is at step {t0}, beyond "
                             f"this run's horizon n_steps={cfg.n_steps}")
        c.q = _restore(q, c.q, "q", ck[0])
        c.v = _restore(v, c.v, "v", ck[0])
        c.hit = _restore(extra["hit_flag"], c.hit, "hit_flag", ck[0])
    for s0, s1 in _chunks(t0, cfg):
        if bool(c.hit.all()):            # read once per chunk
            break
        graded_chunk(P3, c, s0, s1)
        if dtype == torch.float32:
            _guard_finite(c.q, context=f"in P3 after step {s1}")
        if ck is not None:
            save_checkpoint(ck[0], step=-(-s1 // cs), q=_host(c.q),
                            v=_host(c.v),
                            extra={"hit_flag": _host(c.hit)},
                            meta={"fingerprint": ck[1], "idx": idx_key,
                                  "t": s1})
    return ~c.hit.cpu().numpy()


@dataclasses.dataclass
class P123Result:
    min_dist: float
    hit_time_step: int
    arrivals: np.ndarray       # (D,) missile-arrival step per device
    saved: np.ndarray          # (D,) bool: destroying device k saves it


def run_problems_123(scene: Scene, fst: np.ndarray, cfg: SimConfig, *,
                     device: torch.device, dtype=F64,
                     checkpoint_path: str | None = None) -> P123Result:
    """Problems 1, 2 and 3 in one pass over rows [P1, P2, P3_0..P3_{D-1}].

    Each P3 row is overwritten with the P2 row's post-step state every
    step up to and including its missile's arrival (that copy is
    problem3_preprocess_gpu's snapshot, hw5.cu:265-287) and evolves on its
    own afterwards with its device's mass zeroed: the same arithmetic as the
    resumed simulation, so the answers equal the phased solvers' bit for
    bit while the horizon is walked once.

    checkpoint_path: the carry is saved after every chunk (phase 'p123')
    and resumed from; a phased driver's checkpoint is refused (its
    fingerprint lacks the fused driver's suffix)."""
    c = _p123_carry(scene, fst, cfg, device, dtype)
    t0, fingerprint = 0, None
    if checkpoint_path is not None:
        fingerprint = _fingerprint(scene, cfg, dtype) + ":p123"
        saved = _load(checkpoint_path, fingerprint, cfg.n_steps)
        if saved is not None:
            t0, q, v, extra, _ = saved
            c.q = _restore(q[None], c.q[None], "q", checkpoint_path)[0]
            c.v = _restore(v[None], c.v[None], "v", checkpoint_path)[0]
            for name in ("min_d2", "hit", "arr", "p3_hit"):
                like = getattr(c, name)
                setattr(c, name, _restore(extra[name][None], like[None],
                                          name, checkpoint_path)[0])
    for s0, s1 in _chunks(t0, cfg):
        graded_chunk(P123, c, s0, s1)
        if dtype == torch.float32:
            _guard_finite(c.q, c.min_d2, context=f"in fused P1/P2/P3 after "
                                                 f"step {s1}")
        if checkpoint_path is not None:
            save_checkpoint(
                checkpoint_path, step=s1, q=_host(c.q), v=_host(c.v),
                extra={"min_d2": _host(c.min_d2),
                       "hit": _host(c.hit).astype(np.int32),
                       "arr": _host(c.arr).astype(np.int32),
                       "p3_hit": _host(c.p3_hit)},
                meta={"n_steps": cfg.n_steps, "fingerprint": fingerprint,
                      "phase": "p123"})

    arr_h = c.arr.cpu().numpy()
    hit_h = int(c.hit)
    eligible = ((arr_h != -2) & (arr_h <= hit_h) if hit_h != -2
                else np.zeros(arr_h.shape, dtype=bool))
    return P123Result(min_dist=_min_dist(c.min_d2), hit_time_step=hit_h,
                      arrivals=arr_h, saved=eligible & ~c.p3_hit.cpu().numpy())


def _zeros(shape: tuple, device, dtype) -> torch.Tensor:
    if dtype == DD:
        return torch.zeros(shape + (2,), dtype=torch.float64, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def _p12_carry(scene: Scene, fst: np.ndarray, cfg: SimConfig, device,
               dtype) -> Carry:
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
                 q_snap=_zeros((D, n, 3), device, dtype),
                 v_snap=_zeros((D, n, 3), device, dtype),
                 dist3=cfg.dist3_mode or "dsqrt")


def _p3_carry(scene: Scene, p12: P12Result, fst: np.ndarray, cfg: SimConfig,
              idx: np.ndarray, device, dtype) -> Carry:
    """One row per device slot in `idx`, that device destroyed, at its
    arrival snapshot."""
    arrivals = p12.arrivals[idx]
    rows = np.tile(scene.m, (len(idx), 1))
    rows[np.arange(len(idx)), scene.device_idx[idx]] = 0.0  # destroyed
    m0, m_half = _masses(rows, scene, device, dtype)
    sel_idx = _t(idx, device)
    q = p12.q_snaps[sel_idx]
    c = Carry(q=q, v=p12.v_snaps[sel_idx], m0=m0, m_half=m_half,
              fst=_fst_table(fst, device, dtype),
              others=_t(np.asarray([scene.asteroid]), device),
              arr=_t(arrivals, device), hit=None, planet=scene.planet,
              G=cfg.G, eps=cfg.eps, dt=cfg.dt, r2=_r2(cfg, dtype),
              dist3=cfg.dist3_mode or "dsqrt")
    # the resume step is checked on the snapshot before any update
    # (missile_cost_gpu, hw5.cu:292-298)
    ar = arith(q)
    c.hit = ar.lt(ar.d2(q[:, scene.planet], q[:, scene.asteroid]), ar.r2(c))
    return c


def _p123_carry(scene: Scene, fst: np.ndarray, cfg: SimConfig, device,
                dtype) -> Carry:
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
                 p3_hit=torch.zeros((D,), dtype=torch.bool, device=device),
                 dist3=cfg.dist3_mode or "dsqrt")
