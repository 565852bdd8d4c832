"""The layout of the graded P1/P2/P3 solve over a ('scen', 'body') mesh.

The port of `nbody_tpu.parallel.solver_sharded`: the answer of
`models/direct_sum` through the mesh, the counterpart of the reference
spreading the graded scenario over its two GPUs (hw5.cu:564-588). The
drivers are models/direct_sum's `run_problems_12` and `run_problem_3`;
`Layout` is what they take in the place of the one-device layout.

  * 'scen' — the P1/P2 rows go to the mesh rows in turn (row r to scen
    index r mod S), and so do the Problem-3 scenarios, all at once; they
    never talk to each other during a chunk. The P2 early exit
    (hw5.cu:398-402) applies only at scen = 1, where the rows share ranks,
    as in the JAX package.
  * 'body' — every rank holds the whole state, in the blocks that an
    all_gather over 'body' makes (ops/chunking `Blocks`: block r holds q and
    v of the rows [r * ni, (r + 1) * ni), ni = ceil(n / body)). A step of
    a rank is ops/graded_step `graded_rows_chunk`: the force of its own
    rows against every body, the update of those rows, one in-place
    all_gather of the blocks, and the checks of the whole state, which
    every rank makes alike (the JAX e64 design, solver_sharded.py:381-470).
    On a card that is one launch of the graded step kernel and one NCCL
    call a step; a card whose kernel fails raises. In binary64 ('f64', and
    'e64', 'dd', 'ddp', 'dd+', which the port runs as binary64) and
    double-double ('tf3') a row's serial fold does not depend on which
    rows share its launch, and its update reads only the row, so the
    answers are bitwise those of the one-device solve, on every mesh shape
    and for every n (the last block padded); `tile` does not apply. In
    'f32' the force is the mesh's ordered sum at `tile` (default 128): one
    partial per group of `tile` sources, added in ascending order
    (parallel/sharded.py ring_accel_ordered, the JAX package's
    _tile_partial order), which no split of the rows changes: bitwise the
    same on every mesh shape for one tile, and bitwise the one-device
    'f32' at tile 128.

Checkpoints are written by rank 0 and read by every rank, in the
one-device layout (the real bodies only; `whole` assembles them at chunk
boundaries), and a run resumes on any mesh shape with the same bits. Their
fingerprint is the one-device one with ':mesh' (and ':tile=T' in 'f32')
added, so a one-device run and a mesh run do not take each other's files.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch
import torch.distributed as dist

from ..ops.chunking import from_blocks, to_blocks
from ..ops.graded_step import P12, P3, graded_rows_chunk
from .mesh import axis, mesh_device
from .sharded import TILE, body_blocks


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


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


class Layout:
    """How this rank holds a graded carry of n bodies on the mesh: the
    carry rows r with r mod S = its scen index (`mine` of `rows`, the rows
    of the whole carry), every body of them in the blocks of `blocks` (its
    own the rows [r * ni, (r + 1) * ni) of an equal split, ceil(n / k) a
    rank, fewer or none at the end), filled by `gather`, an in-place
    all_gather over 'body'. One layout serves a solve's drivers in turn:
    `split` starts each."""

    def __init__(self, mesh, n: int, dtype, tile: int | None = None):
        _, self.si, self.S = axis(mesh, "scen")
        self.blocks, self.gather = body_blocks(mesh, n)
        self.bi = self.blocks.mine[0]
        self.dev = mesh_device(mesh)
        self.n = n
        self.tile = tile or TILE
        self.suffix = ":mesh" + (f":tile={self.tile}"
                                 if dtype == torch.float32 else "")
        self.writes = dist.get_rank() == 0

    @staticmethod
    def p3_strategy(n: int) -> str:
        """Problem 3's strategy 'auto': every scenario at once."""
        return "batched"

    def split(self, mode: int, c):
        """This rank's part of the whole carry c: its rows, the state in
        blocks (and v None)."""
        self.rows = list(range(c.q.shape[0]))
        self.mine = [r for r in self.rows if r % self.S == self.si]
        self.live_here = bool(self.mine)
        names = ("q", "v", "m0", "m_half") + (("arr", "hit") if mode == P3
                                              else ())
        part = dataclasses.replace(c, **{name: getattr(c, name)[self.mine]
                                         for name in names})
        part.q, part.v = to_blocks(part.q, part.v, self.blocks.k), None
        return part

    def early_exit(self, c) -> None:
        """The P2 early exit, where the rows share ranks (one host read
        while the devices-on row runs)."""
        if self.S == 1 and len(self.rows) == 2 and int(c.hit) != -2:
            self.rows = self.mine = [0]
            c.m0, c.m_half = c.m0[:1], c.m_half[:1]
            c.q = c.q[:, :, :1].contiguous()

    def advance(self, mode: int, c, s0: int, s1: int) -> None:
        """Steps s0+1..s1 of this rank's rows, if it has any undecided:
        the row-range chunk with an in-place all_gather over 'body'."""
        if not self.live_here:
            return
        roles = None
        if mode == P12:
            roles = tuple(self.mine.index(r) if r in self.mine else None
                          for r in (0, 1))
        graded_rows_chunk(mode, c, s0, s1, self.blocks, self.gather, roles,
                          self.tile)

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

    def live(self, c) -> bool:
        """Whether any rank's Problem-3 scenario is undecided (one host
        read and one all_reduce of a flag)."""
        self.live_here = bool(self.mine) and not bool(c.hit.all())
        undecided = torch.tensor([int(self.live_here)], device=self.dev)
        dist.all_reduce(undecided, op=dist.ReduceOp.MAX)
        return bool(int(undecided))

    def whole(self, mode: int, c) -> types.SimpleNamespace:
        """The whole carry's state and decisions in the one-device layout,
        as host tensors, from every rank's part (every rank calls it)."""
        q, v = from_blocks(c.q, self.n)
        piece = {"si": self.si, "bi": self.bi, "q": _host(q), "v": _host(v)}
        if mode == P3:
            piece["hit"] = _host(c.hit)
        else:
            if 0 in self.mine:
                piece["min_d2"] = _host(c.min_d2)
            if 1 in self.mine or (1 not in self.rows and self.si == 0):
                piece.update(hit=_host(c.hit), arr=_host(c.arr),
                             q_snap=_host(c.q_snap), v_snap=_host(c.v_snap))
        pieces = _gathered(piece)

        def rows(key):       # every row of the whole carry, in its order
            parts = [_assemble(pieces, si, key)
                     for si in range(min(self.S, len(self.rows)))]
            out = np.empty((len(self.rows),) + parts[0].shape[1:],
                           parts[0].dtype)
            for si, part in enumerate(parts):
                out[si::self.S] = part
            return out

        keys = ("q", "v", "hit") if mode == P3 else ("q", "v")
        out = {key: rows(key) for key in keys}
        if mode == P12:
            owner = 1 % self.S if 1 in self.rows else 0
            out.update({key: _assemble(pieces, owner, key)
                        for key in ("hit", "arr", "q_snap", "v_snap")})
            out["min_d2"] = _assemble(pieces, 0, "min_d2")
        return types.SimpleNamespace(**{key: torch.from_numpy(x)
                                        for key, x in out.items()})
