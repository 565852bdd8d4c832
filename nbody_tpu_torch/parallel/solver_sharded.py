"""The graded P1/P2/P3 solve over a ('scen', 'body') mesh of ranks.

The port of `nbody_tpu.parallel.solver_sharded`: the answer of
`models/direct_sum` through the mesh, the counterpart of the reference
spreading the graded scenario over its two GPUs (hw5.cu:564-588).

  * 'scen' — the P1/P2 rows go to the mesh rows in turn (row r to scen
    index r mod S), and so do the Problem-3 scenarios; they never talk to
    each other during a chunk. The P2 early exit (hw5.cu:398-402) applies
    only at scen = 1, where the rows share ranks, as in the JAX package.
  * 'body' — every rank holds the whole state, in the blocks that an
    all_gather over 'body' makes (ops/graded_step `Blocks`: block r holds
    q and v of the rows [r * ni, (r + 1) * ni), ni = ceil(n / body)). A
    step of a rank is ops/graded_step `graded_rows_chunk`: the force of
    its own rows against every body, the update of those rows, one
    in-place all_gather of the blocks, and the checks of the whole state,
    which every rank makes alike (the JAX e64 design,
    solver_sharded.py:381-470). On a card that is one launch of the graded
    step kernel and one NCCL call a step; a card whose kernel fails
    raises. In binary64 ('f64', and 'e64', 'dd', 'ddp', 'dd+', which the
    port runs as binary64) and double-double ('tf3') a row's serial fold
    does not depend on which rows share its launch, and its update reads
    only the row, so the answers are bitwise those of the one-device
    solve, on every mesh shape and for every n (the last block padded);
    `tile` does not apply. In 'f32' the force is the mesh's ordered sum at
    `tile` (default 128): one partial per group of `tile` sources, added
    in ascending order (parallel/sharded.py ring_accel_ordered, the JAX
    package's _tile_partial order), which no split of the rows changes:
    bitwise the same on every mesh shape for one tile, and bitwise the
    one-device 'f32' at tile 128.

Checkpoints (`checkpoint_path`) are written by rank 0 and read by every
rank, in the one-device layout (the real bodies only; the blocks are
converted at chunk boundaries), and a run resumes on any mesh shape with
the same bits. Their fingerprint is the one-device
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
from ..ops.graded_step import P3, P12, from_blocks, graded_rows_chunk, \
    to_blocks
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .mesh import axis, mesh_device
from .sharded import TILE, body_blocks

F32 = torch.float32


class Layout:
    """How this rank holds a graded state of n bodies on the mesh: all n
    bodies in the blocks of `blocks` (its own the rows [r * ni, (r + 1) *
    ni) of an equal split, ceil(n / k) a rank, fewer or none at the end),
    filled by `gather`, an in-place all_gather over 'body'."""

    def __init__(self, mesh, n: int, dtype, tile: int | None = None):
        _, self.si, self.S = axis(mesh, "scen")
        self.blocks, self.gather = body_blocks(mesh, n)
        self.bi = self.blocks.mine[0]
        self.dev = mesh_device(mesh)
        self.n, self.dtype = n, dtype
        self.tile = tile or TILE

    def advance(self, mode: int, c, s0: int, s1: int,
                roles=None) -> None:
        """Steps s0+1..s1 of this rank's graded carry: the row-range chunk
        with an in-place all_gather over 'body'."""
        graded_rows_chunk(mode, c, s0, s1, self.blocks, self.gather, roles,
                          self.tile)

    def carry(self, c) -> None:
        """Put this rank's carry c, its (q, v) in the one-device layout, in
        the layout `advance` takes (in place)."""
        c.q, c.v = to_blocks(c.q, c.v, self.blocks.k), None

    def state(self, c) -> tuple:
        """(q, v) of this rank's carry in the one-device layout."""
        return from_blocks(c.q, self.n)

    def first_row(self, c) -> None:
        """Keep only scenario row 0 of the carry's state (the P2 early
        exit)."""
        c.m0, c.m_half = c.m0[:1], c.m_half[:1]
        c.q = c.q[:, :, :1].contiguous()

    def finite(self, c, context: str) -> None:
        """Raise FloatingPointError on every rank if any rank's float32
        positions (or P1's min d2) overflowed (one all_reduce of a flag,
        once a chunk: the 'scen' rows hold other states)."""
        tensors = [c.q[:, 0]] + ([] if c.min_d2 is None else [c.min_d2])
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


def _assemble(pieces: list, si: int, key: str) -> np.ndarray:
    """The whole array `key` of scen row si from the gathered pieces: body
    rank 0's (every body rank holds the whole state)."""
    return next(p[key] for p in pieces
                if p["si"] == si and p["bi"] == 0 and p.get(key) is not None)


def run_problems_12_sharded(scene: Scene, fst: np.ndarray, cfg: SimConfig,
                            mesh, *, dtype=ds.F64, tile: int | None = None,
                            checkpoint_path: str | None = None
                            ) -> ds.P12Result:
    """Problems 1+2 and the Problem-3 arrival snapshots on the mesh: the
    contract of models/direct_sum.run_problems_12, for any n (float32
    pads inside). Every rank returns the same result."""
    L = Layout(mesh, scene.n, dtype, tile)
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
        setattr(c, name, getattr(full, name)[mine])
    L.carry(c)

    def gather() -> tuple:
        """The whole carry from every rank's part: (q, v, the rest by
        name), in the one-device layout."""
        q, v = L.state(c)
        piece = {"si": L.si, "bi": L.bi, "q": _host(q), "v": _host(v)}
        if 0 in mine:
            piece["min_d2"] = _host(c.min_d2)
        if 1 in mine or (1 not in rows and L.si == 0):
            piece.update(hit=_host(c.hit), arr=_host(c.arr),
                         q_snap=_host(c.q_snap), v_snap=_host(c.v_snap))
        pieces = _gathered(piece)
        owner = 1 % L.S if 1 in rows else 0
        out = {key: _assemble(pieces, owner, key)
               for key in ("q_snap", "v_snap")}
        for key in ("hit", "arr"):
            out[key] = _assemble(pieces, owner, key).astype(np.int32)
        out["min_d2"] = _assemble(pieces, 0, "min_d2")

        def row(key, r):      # row r of its scen row's part
            si = r % L.S
            return _assemble(pieces, si, key)[
                [m for m in rows if m % L.S == si].index(r)]
        q, v = (np.stack([row(key, r) for r in rows]) for key in ("q", "v"))
        return q, v, out

    for s0, s1 in ds._chunks(t0, cfg):
        # the P2 early exit, where the rows share ranks (one host read)
        if L.S == 1 and len(rows) == 2 and int(c.hit) != -2:
            rows = mine = [0]
            L.first_row(c)
        if mine:
            L.advance(P12, c, s0, s1, roles=(
                mine.index(0) if 0 in mine else None,
                mine.index(1) if 1 in mine else None))
        if dtype == F32:
            L.finite(c, context=f"in P1/P2 after step {s1}")
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
        setattr(c, name, getattr(full, name)[mine])
    L.carry(c)

    def gather() -> list:
        q, v = L.state(c)
        return _gathered({"si": L.si, "bi": L.bi, "q": _host(q),
                          "v": _host(v), "hit": _host(c.hit)})

    def whole(pieces: list, key: str) -> np.ndarray:
        """Scenarios in idx order from the scen rows' parts."""
        parts = [_assemble(pieces, r, key)
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
            L.advance(P3, c, s0, s1)
        if dtype == F32:
            L.finite(c, context=f"in P3 after step {s1}")
        if path is not None:
            pieces = gather()
            if dist.get_rank() == 0:
                save_checkpoint(path, step=-(-s1 // cs),
                                q=whole(pieces, "q"),
                                v=whole(pieces, "v"),
                                extra={"hit_flag": whole(pieces, "hit")},
                                meta={"fingerprint": ck[0], "idx": ck[1],
                                      "t": s1})
    saved[idx] = ~whole(gather(), "hit")
    return saved


def solve_scene_sharded(scene: Scene, cfg: SimConfig, mesh, *,
                        dtype=ds.F64, tile: int | None = None,
                        checkpoint_path: str | None = None):
    """P1+P2+P3 on the mesh: (Answers, P12Result) in the units of the
    scene given (the caller rescales for 'f32', as engine.solve_scene
    does). The phased drivers always: the mesh has no fused driver. The
    phases are spans of the open request (utils/profiling)."""
    from ..engine import Answers, select_winner
    from ..physics import oscillation_table
    from ..utils import profiling

    with profiling.span("oscillation_table"):
        fst = oscillation_table(cfg)
    with profiling.span("problem_1_2"):
        p12 = run_problems_12_sharded(scene, fst, cfg, mesh, dtype=dtype,
                                      tile=tile,
                                      checkpoint_path=checkpoint_path)
    winner = (-1, 0.0)
    if p12.hit_time_step != -2 and scene.device_cnt > 0:
        with profiling.span("problem_3"):
            saved = run_problem_3_sharded(scene, p12, fst, cfg, mesh,
                                          dtype=dtype, tile=tile,
                                          checkpoint_path=checkpoint_path)
        winner = select_winner(scene, p12.arrivals, saved, cfg)
    return Answers(p12.min_dist, p12.hit_time_step, *winner), p12
