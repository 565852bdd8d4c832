"""The graded P1/P2/P3 solve over a ('scen', 'body') mesh of ranks.

The port of `nbody_tpu.parallel.solver_sharded`: the answer of
`models/direct_sum` through the mesh, the counterpart of the reference
spreading the graded scenario over its two GPUs (hw5.cu:564-588).

  * 'scen' — the P1/P2 rows go to the mesh rows in turn (row r to scen
    index r mod S), and so do the Problem-3 scenarios; they never talk to
    each other during a chunk. The P2 early exit (hw5.cu:398-402) applies
    only at scen = 1, where the rows share ranks, as in the JAX package.
  * 'body' — in binary64 ('f64', and 'e64', 'dd', 'ddp', 'dd+', which the
    port runs as binary64) and in double-double ('tf3') every rank holds
    the whole state and computes the force of its own rows [r0, r1)
    against all the sources, through the cross form of kernel B1 or B4;
    one all_gather over 'body' puts the accelerations together, and every
    rank then makes the same update and checks (the JAX e64 design,
    solver_sharded.py:381-470). A row's serial fold does not depend on
    which rows share its launch, so the answers are bitwise those of the
    one-device solve, on every mesh shape and for every n (uneven row
    blocks are gathered padded). `tile` does not apply.
    In 'f32' the bodies themselves are split over 'body' (padded with
    zero-mass bodies to a multiple of body * tile), the force is the
    ordered ring (parallel/sharded.py), and the planet's, asteroid's and
    devices' rows that the checks read are taken with one all_reduce in
    which only their owner adds a nonzero, exactly as `_extract_rows` does.
    Bitwise the same on every mesh shape for one tile, and bitwise the
    one-device 'f32' at tile 128.

The graded checks are the plain chunks' (ops/graded_step `_p12_chunk_ref`,
`_p3_chunk_ref`): the mesh hands them its step and its row taker, and they
stay eager PyTorch ops, on the card too (the one-launch graded step
kernels have no mesh form).

Checkpoints (`checkpoint_path`) are written by rank 0 and read by every
rank, in the one-device layout (the real bodies only), and a run resumes on
any mesh shape with the same bits. Their fingerprint is the one-device
one with ':mesh' (and ':tile=T' in 'f32') added, so a one-device run and a
mesh run do not take each other's files.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import SimConfig
from ..io import Scene
from ..models import direct_sum as ds
from ..ops.accel_dd import accel_dd
from ..ops.accel_f64 import accel_f64
from ..ops.graded_step import _p3_chunk_ref, _p12_chunk_ref, arith, \
    take_rows
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .mesh import axis, mesh_device
from .sharded import TILE, all_gather, ring_accel_ordered

F32 = torch.float32


class Layout:
    """How this rank holds a graded state of n bodies on the mesh.

    Replicated (binary64, double-double): all n bodies, and the force rows
    [r0, r1) of an equal split (ceil(n / k) a rank, fewer or none at the
    end). Sharded (float32): n padded to n_pad, a multiple of k * tile,
    and the rows [r0, r1) of n_pad / k bodies."""

    def __init__(self, mesh, n: int, dtype, tile: int | None = None):
        _, self.si, self.S = axis(mesh, "scen")
        self.group, self.bi, self.k = axis(mesh, "body")
        self.dev = mesh_device(mesh)
        self.n, self.dtype = n, dtype
        self.sharded = dtype == F32
        self.tile = tile or TILE
        if self.sharded:
            span = self.k * self.tile
            self.n_pad = -(-n // span) * span
            self.ni = self.n_pad // self.k
            self.r0 = self.bi * self.ni
            self.r1 = self.r0 + self.ni
        else:
            self.n_pad, self.ni = n, -(-n // self.k)
            self.r0 = min(self.bi * self.ni, n)
            self.r1 = min(self.r0 + self.ni, n)

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's part of a whole tensor of the real bodies along
        `dim`: all of it, or (sharded) its rows of the zero-padded bodies."""
        if not self.sharded:
            return x
        pad = list(x.shape)
        pad[dim] = self.n_pad - self.n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        return x.narrow(dim, self.r0, self.ni).contiguous()

    def whole(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The real bodies' whole tensor from this rank's part (a gather
        over 'body' when sharded)."""
        if not self.sharded:
            return x
        x = all_gather(x.movedim(dim, 0), self.group, self.k)
        return x.flatten(0, 1).movedim(0, dim).narrow(dim, 0, self.n)

    def force(self, *, eps: float, dist3: str = "dsqrt"):
        """force(q, gm) of this layout for integrate's steps."""
        if self.sharded:
            return functools.partial(ring_accel_ordered, group=self.group,
                                     eps=eps, tile=self.tile)
        if self.dtype == ds.DD:
            return self._rows_force(functools.partial(accel_dd, eps=eps), 4)
        return self._rows_force(functools.partial(accel_f64, eps=eps,
                                                  dist3_mode=dist3), 3)

    def _rows_force(self, kernel, dims: int):
        """This rank's rows through the kernel's cross form, then one
        all_gather over 'body' (the last block padded to ni rows)."""
        r0, r1, ni, k = self.r0, self.r1, self.ni, self.k

        def force(q: torch.Tensor, gm: torch.Tensor) -> torch.Tensor:
            one = q.dim() == dims - 1            # an unbatched scene
            if one:
                q, gm = q[None], gm[None]
            q, gm = q.contiguous(), gm.contiguous()
            if r1 - r0 == ni:
                block = kernel(q[:, r0:r1].contiguous(), q, gm)
            else:
                block = q.new_zeros((q.shape[0], ni) + tuple(q.shape[2:]))
                if r1 > r0:
                    block[:, :r1 - r0] = kernel(q[:, r0:r1].contiguous(), q,
                                                gm)
            a = all_gather(block, self.group, k).movedim(0, 1)
            a = a.flatten(1, 2)[:, :self.n]
            return a[0] if one else a

        return force

    def take(self):
        """The plain chunks' row taker: local indexing, or (sharded) the
        exact extraction of rows idx from the body-sharded q (B, ni, 3):
        each rank adds the rows it owns, the others zeros."""
        if not self.sharded:
            return take_rows
        r0, ni, group = self.r0, self.ni, self.group

        def take(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
            loc = idx - r0
            mine = (loc >= 0) & (loc < ni)
            rows = torch.where(mine[None, :, None], q[:, loc.clamp(0, ni - 1)],
                               0.0)
            dist.all_reduce(rows, group=group)
            return rows

        return take

    def finite(self, *tensors, context: str) -> None:
        """Raise FloatingPointError on every rank if any rank's float32
        state overflowed (one all_reduce of a flag, once a chunk)."""
        ok = torch.tensor([int(all(bool(torch.isfinite(x).all())
                                   for x in tensors))], device=self.dev)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        if not int(ok):
            raise FloatingPointError(
                f"non-finite simulation state {context} on a rank of the "
                "mesh: the rescaled float32 run overflowed (orbital growth "
                "exceeded the rescale window, utils/rescale.py "
                "growth_margin); rerun with precision='f64'")


def fingerprint(scene: Scene, cfg: SimConfig, dtype, tile: int) -> str:
    """The one-device fingerprint plus ':mesh', and the tile in 'f32' (it
    fixes the float32 sum; the mesh shape does not)."""
    fp = ds._fingerprint(scene, cfg, dtype) + ":mesh"
    return fp + f":tile={tile}" if dtype == F32 else fp


def _host(x):
    return None if x is None else x.detach().cpu().numpy()


def _gathered(piece: dict) -> list:
    """Every rank's `piece` (host arrays), in world-rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, piece)
    return out


def _assemble(pieces: list, si: int, key: str, dim: int,
              n: int | None = None) -> np.ndarray:
    """The whole array `key` of scen row si from the gathered pieces: body
    rank 0's, or, given the real body count n (sharded), the body ranks'
    parts joined along `dim` and cut to n."""
    parts = sorted(((p["bi"], p[key]) for p in pieces
                    if p["si"] == si and p.get(key) is not None
                    and (n is not None or p["bi"] == 0)),
                   key=lambda part: part[0])
    if n is None:
        return parts[0][1]
    return np.concatenate([x for _, x in parts], axis=dim).take(
        np.arange(n), axis=dim)


def run_problems_12_sharded(scene: Scene, fst: np.ndarray, cfg: SimConfig,
                            mesh, *, dtype=ds.F64, tile: int | None = None,
                            checkpoint_path: str | None = None
                            ) -> ds.P12Result:
    """Problems 1+2 and the Problem-3 arrival snapshots on the mesh: the
    contract of models/direct_sum.run_problems_12, for any n (float32
    pads inside). Every rank returns the same result."""
    L = Layout(mesh, scene.n, dtype, tile)
    n = scene.n if L.sharded else None      # cut gathered parts to n
    full = ds._p12_carry(scene, fst, cfg, L.dev, dtype)
    t0, fp = 0, None
    if checkpoint_path is not None:
        fp = fingerprint(scene, cfg, dtype, L.tile)
        t0 = ds._resume_p12(full, ds._load(checkpoint_path, fp, cfg.n_steps),
                            checkpoint_path)
    rows = list(range(full.q.shape[0]))      # 0: P1, 1: P2 (if running)
    mine = [r for r in rows if r % L.S == L.si]
    c = dataclasses.replace(full)
    for name in ("q", "v", "m0", "m_half"):
        setattr(c, name, L.local(getattr(full, name)[mine]))
    c.q_snap, c.v_snap = L.local(full.q_snap), L.local(full.v_snap)
    ar = arith(full.q)
    force = L.force(eps=cfg.eps, dist3=full.dist3)

    def step(c, q, v, s):
        return ar.step(c, q, v, s, force=force)

    def gather() -> tuple:
        """The whole carry from every rank's part: (q, v, the rest by
        name), in the one-device layout."""
        piece = {"si": L.si, "bi": L.bi, "q": _host(c.q), "v": _host(c.v)}
        if 0 in mine:
            piece["min_d2"] = _host(c.min_d2)
        if 1 in mine or (1 not in rows and L.si == 0):
            piece.update(hit=_host(c.hit), arr=_host(c.arr),
                         q_snap=_host(c.q_snap), v_snap=_host(c.v_snap))
        pieces = _gathered(piece)
        owner = 1 % L.S if 1 in rows else 0
        out = {key: _assemble(pieces, owner, key, 1, n)
               for key in ("q_snap", "v_snap")}
        for key in ("hit", "arr"):
            out[key] = _assemble(pieces, owner, key, 0).astype(np.int32)
        out["min_d2"] = _assemble(pieces, 0, "min_d2", 0)

        def row(key, r):      # row r of its scen row's part
            si = r % L.S
            return _assemble(pieces, si, key, 1, n)[
                [m for m in rows if m % L.S == si].index(r)]
        q, v = (np.stack([row(key, r) for r in rows]) for key in ("q", "v"))
        return q, v, out

    for s0, s1 in ds._chunks(t0, cfg):
        # the P2 early exit, where the rows share ranks (one host read)
        if L.S == 1 and len(rows) == 2 and int(c.hit) != -2:
            rows = mine = [0]
            c.q, c.v, c.m0, c.m_half = (x[:1] for x in
                                        (c.q, c.v, c.m0, c.m_half))
        if mine:
            _p12_chunk_ref(c, s0, s1, step=step, take=L.take(), roles=(
                mine.index(0) if 0 in mine else None,
                mine.index(1) if 1 in mine else None))
        if dtype == F32:
            L.finite(c.q, c.min_d2, context=f"in P1/P2 after step {s1}")
        if checkpoint_path is not None:
            q, v, out = gather()
            if dist.get_rank() == 0:
                save_checkpoint(
                    checkpoint_path, step=s1, q=q, v=v, extra=out,
                    meta={"n_steps": cfg.n_steps, "fingerprint": fp,
                          "phase": "p1" if len(rows) == 1 else "p12"})
    _, _, out = gather()
    put = functools.partial(ds._t, device=L.dev)
    return ds.P12Result(
        min_dist=ds._min_dist(torch.from_numpy(out["min_d2"])),
        hit_time_step=int(out["hit"]), arrivals=out["arr"].astype(np.int64),
        q_snaps=put(out["q_snap"]), v_snaps=put(out["v_snap"]))


def run_problem_3_sharded(scene: Scene, p12: ds.P12Result, fst: np.ndarray,
                          cfg: SimConfig, mesh, *, dtype=ds.F64,
                          tile: int | None = None,
                          checkpoint_path: str | None = None) -> np.ndarray:
    """(D,) bool: True where destroying device k saves the planet. The
    eligible scenarios (models/direct_sum.run_problem_3) all run at once,
    scenario e of them on scen row e mod S, and each row stops computing
    once all of its scenarios are hit; the chunks end when every row's
    are. `<checkpoint_path>.p3.npz` holds them all, in the one-device
    batched layout."""
    D = scene.device_cnt
    saved = np.zeros((D,), dtype=bool)
    eligible = (p12.arrivals != -2) & (p12.arrivals <= p12.hit_time_step)
    idx = np.nonzero(eligible)[0]
    if D == 0 or not idx.size:
        return saved
    L = Layout(mesh, scene.n, dtype, tile)
    n = scene.n if L.sharded else None      # cut gathered parts to n
    full = ds._p3_carry(scene, p12, fst, cfg, idx, L.dev, dtype)
    cs = cfg.chunk_steps
    t0 = int(p12.arrivals[idx].min()) // cs * cs
    ck = path = None
    if checkpoint_path is not None:
        path = checkpoint_path + ".p3.npz"
        ck = (fingerprint(scene, cfg, dtype, L.tile), [int(i) for i in idx])
        if os.path.exists(path):
            step, q, v, extra, meta = load_checkpoint(path)
            if (meta.get("fingerprint"), meta.get("idx")) != ck:
                raise ValueError(f"P3 checkpoint {path} was written for a "
                                 "different scene/config/precision/tile/"
                                 "scenario set; refusing to resume")
            t0 = int(meta.get("t", int(step) * cs))
            if t0 > cfg.n_steps:
                raise ValueError(f"P3 checkpoint {path} is at step {t0}, "
                                 f"beyond this run's horizon "
                                 f"n_steps={cfg.n_steps}")
            full.q = ds._restore(q, full.q, "q", path)
            full.v = ds._restore(v, full.v, "v", path)
            full.hit = ds._restore(extra["hit_flag"], full.hit, "hit_flag",
                                   path)
    mine = list(range(L.si, idx.size, L.S))
    c = dataclasses.replace(full, arr=full.arr[mine], hit=full.hit[mine])
    for name in ("q", "v", "m0", "m_half"):
        setattr(c, name, L.local(getattr(full, name)[mine]))
    ar = arith(full.q)
    force = L.force(eps=cfg.eps, dist3=full.dist3)

    def step(c, q, v, s):
        return ar.step(c, q, v, s, force=force)

    def gather() -> list:
        return _gathered({"si": L.si, "bi": L.bi, "q": _host(c.q),
                          "v": _host(c.v), "hit": _host(c.hit)})

    def whole(pieces: list, key: str, dim: int) -> np.ndarray:
        """Scenarios in idx order from the scen rows' parts."""
        parts = [_assemble(pieces, r, key, dim, None if key == "hit" else n)
                 for r in range(min(L.S, idx.size))]
        out = np.empty((idx.size,) + parts[0].shape[1:], parts[0].dtype)
        for r, part in enumerate(parts):
            out[r::L.S] = part
        return out

    for s0, s1 in ds._chunks(t0, cfg):
        live = bool(mine) and not bool(c.hit.all())     # one host read
        undecided = torch.tensor([int(live)], device=L.dev)
        dist.all_reduce(undecided, op=dist.ReduceOp.MAX)
        if not int(undecided):
            break
        if live:
            _p3_chunk_ref(c, s0, s1, step=step, take=L.take())
        if dtype == F32:
            L.finite(c.q, context=f"in P3 after step {s1}")
        if path is not None:
            pieces = gather()
            if dist.get_rank() == 0:
                save_checkpoint(path, step=-(-s1 // cs),
                                q=whole(pieces, "q", 1),
                                v=whole(pieces, "v", 1),
                                extra={"hit_flag": whole(pieces, "hit", 0)},
                                meta={"fingerprint": ck[0], "idx": ck[1],
                                      "t": s1})
    saved[idx] = ~whole(gather(), "hit", 0)
    return saved


def solve_scene_sharded(scene: Scene, cfg: SimConfig, mesh, *,
                        dtype=ds.F64, tile: int | None = None,
                        checkpoint_path: str | None = None, timers=None):
    """P1+P2+P3 on the mesh: (Answers, P12Result) in the units of the
    scene given (the caller rescales for 'f32', as engine.solve_scene
    does). The phased drivers always: the mesh has no fused driver."""
    from ..engine import Answers, select_winner
    from ..physics import oscillation_table
    from ..utils.profiling import PhaseTimers

    timers = timers or PhaseTimers(mesh_device(mesh))
    fst = oscillation_table(cfg)
    with timers.phase("problem_1_2"):
        p12 = run_problems_12_sharded(scene, fst, cfg, mesh, dtype=dtype,
                                      tile=tile,
                                      checkpoint_path=checkpoint_path)
    winner = (-1, 0.0)
    if p12.hit_time_step != -2 and scene.device_cnt > 0:
        with timers.phase("problem_3"):
            saved = run_problem_3_sharded(scene, p12, fst, cfg, mesh,
                                          dtype=dtype, tile=tile,
                                          checkpoint_path=checkpoint_path)
        winner = select_winner(scene, p12.arrivals, saved, cfg)
    return Answers(p12.min_dist, p12.hit_time_step, *winner), p12
