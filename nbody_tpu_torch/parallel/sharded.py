"""Body-sharded force and steps: source blocks rotate around a ring of ranks.

The port of `nbody_tpu.parallel.sharded`, the N-body analog of sequence
parallelism: the bodies are split over the mesh's 'body' axis, each rank
owns a row block of the N x N interaction matrix, and the source blocks
(positions and gm) travel around the ring with `batch_isend_irecv`, one
hop a rotation (JAX's `lax.ppermute`). The block kernel is kernel B2's
cross form, `accel_f32(qi, qj, gmj)`, the counterpart of the JAX ring's
`pallas_accel_cross`; a float64 ring takes kernel B1's cross form. At a
ring of one rank there is no point-to-point call (JAX's ppermute of one
device is the identity).

Every function here runs inside each rank on that rank's own shard (the
SPMD of torch.distributed: what `shard_map` is to the JAX package).

The graded solve and `simulate(mesh=)` do not run the ring: every rank
holds the whole state in row blocks (`body_blocks`), a step kernel
computes the rank's rows and `gather_blocks` fills the other blocks in
place (ops/graded_step.graded_rows_chunk, ops/sim_step.sim_rows_chunk_*).
The ring functions stay as the JAX package's API and as the references
those paths are held against.

`ring_accel_ordered` (JAX: parallel/solver_sharded.py:69-112) makes the
sum independent of the mesh shape: one partial per global tile of `tile`
sources, the partials added from 0 in ascending global tile order. Kernel
B2 itself folds each 128-wide source tile from 0 and adds the tile sums
from 0 in ascending order, so at tile = 128 the ordered ring has the bits
of B2's self form on one device (and of the float32 graded step kernel
B2'): TILE = 128 is the port's default. The JAX package's default,
n // body, fits the TPU's tiles; any tile the caller pins still gives the
same bits on every mesh shape.

Padding (the JAX package's utils/padding.py rule, kept here for the
ring): a rank's rows must be a whole number of tiles, so the float32 bodies are padded at the
end with bodies of zero mass at the origin, at rest. Their terms are
w*dx with w = 0 * rsqrt(d2)^3, +-0, and a sum that starts at +0 and rounds
to nearest is never -0, so adding them changes no bit of any real body;
they move, but nothing feels them.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.accel_f32 import TILE_J, accel_f32
from ..ops.accel_f64 import accel_f64
from ..ops.chunking import Blocks
from ..ops.integrate import scalar
from .mesh import axis, mesh_device

# the ordered ring's default tile: kernel B2's own source tile, at which
# the ring has B2's bits (module docstring)
TILE = TILE_J

# all_gather_into_tensor was renamed all_gather_single (torch 2.13)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, group, k: int) -> torch.Tensor:
    """The group's k blocks x (at least 1-D), stacked in rank order:
    (k, *x.shape)."""
    out = x.new_empty((k,) + tuple(x.shape))
    _all_gather(out.view((k * x.shape[0],) + tuple(x.shape[1:])),
                x.contiguous(), group=group)
    return out


def gather_blocks(x: torch.Tensor, group, me: int) -> None:
    """Fill the blocks x[r] (x (k, ...), contiguous) of every rank r of
    the group from their owners, in place: one all_gather whose send buffer
    is this rank's block x[me] (the output as the blocks' concatenation,
    the one form every backend takes)."""
    _all_gather(x.view(-1), x[me].view(-1), group=group)


def body_blocks(mesh, n: int, *, body_axis: str = "body") -> tuple:
    """(this rank's `Blocks` of n bodies over the body axis, and
    gather(x), which fills the blocks x (k, ...) of the other ranks of the
    axis in place: `gather_blocks` over its group)."""
    group, me, k = axis(mesh, body_axis)
    return Blocks(n, k, (me,)), functools.partial(gather_blocks, group=group,
                                                  me=me)


def ring_shift(tensors: list, group, me: int, k: int) -> list:
    """One hop of the ring: this rank's tensors go to rank me + 1 of the
    group and those of rank me - 1 come back (JAX ppermute
    (i -> i + 1 mod k)). k must be at least 2."""
    nxt = dist.get_global_rank(group, (me + 1) % k)
    prv = dist.get_global_rank(group, (me - 1) % k)
    got = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, g, prv, group) for g in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def _block(qi: torch.Tensor, qj: torch.Tensor, gmj: torch.Tensor,
           eps: float) -> torch.Tensor:
    """Forces on rows qi from the sources qj, gmj: kernel B2's cross form in
    float32, B1's in float64 (batched or not)."""
    if qi.dtype == torch.float32:
        return accel_f32(qi, qj, gmj, eps=eps)
    if qi.dim() == 2:
        return accel_f64(qi[None], qj[None], gmj[None], eps=eps)[0]
    return accel_f64(qi, qj, gmj, eps=eps)


def ring_pairwise_accel(q_local: torch.Tensor, gm_local: torch.Tensor, *,
                        group, eps: float) -> torch.Tensor:
    """All-pairs accelerations of this rank's bodies q_local (ni, 3) or
    (B, ni, 3) under gm_local = G * m, from every rank's block as it comes
    around the ring; each block's partial is added as it arrives (its
    order depends on the rank, as the JAX ring's does)."""
    me, k = dist.get_rank(group), dist.get_world_size(group)
    q_local, gm_local = q_local.contiguous(), gm_local.contiguous()
    a = torch.zeros_like(q_local)
    qj, gmj = q_local, gm_local
    for r in range(k):
        a = a + _block(q_local, qj, gmj, eps)
        if r + 1 < k:
            qj, gmj = ring_shift([qj, gmj], group, me, k)
    return a


def ring_accel_ordered(q_local: torch.Tensor, gm_local: torch.Tensor, *,
                       group, eps: float, tile: int = TILE) -> torch.Tensor:
    """Float32 accelerations of this rank's bodies (ni, 3) or (B, ni, 3)
    with a mesh-shape-independent sum: one partial per global tile of
    `tile` sources through kernel B2's cross form, added from 0 in
    ascending global tile order. ni must be a multiple of `tile`. A block
    whose tiles come next in that order is added as its partials are made;
    one that comes early waits, its partials held, for those before it."""
    me, k = dist.get_rank(group), dist.get_world_size(group)
    ni = q_local.shape[-2]
    if ni % tile:
        raise ValueError(f"local rows {ni} not a multiple of tile {tile}")
    q_local, gm_local = q_local.contiguous(), gm_local.contiguous()
    tps = ni // tile
    acc = torch.zeros_like(q_local)
    held: dict = {}
    after = 0                        # the next block (by origin) to add
    qj, gmj = q_local, gm_local
    for r in range(k):
        origin = (me - r) % k        # the rank this block started from
        parts = []
        for s in range(tps):
            part = accel_f32(q_local,
                             qj[..., s * tile:(s + 1) * tile, :].contiguous(),
                             gmj[..., s * tile:(s + 1) * tile].contiguous(),
                             eps=eps)
            if origin == after:
                acc = acc + part
            else:
                parts.append(part)
        if origin == after:
            after += 1
            while after in held:
                for part in held.pop(after):
                    acc = acc + part
                after += 1
        else:
            held[origin] = parts
        if r + 1 < k:
            qj, gmj = ring_shift([qj, gmj], group, me, k)
    return acc


def make_sharded_step(mesh, *, body_axis: str = "body", G: float,
                      eps: float, dt: float) -> Callable:
    """A sharded step (q, v, m_eff) -> (q, v) of this rank's shards: q, v
    (*batch, ni, 3) and m_eff (*batch, ni), the bodies split over
    `body_axis`. Batch rows split over another axis ('scen') need no
    routing: the rows a rank holds are its own and never meet another
    rank's. One force over the ring, then v += a*dt, q += v*dt."""
    group, _, _ = axis(mesh, body_axis)

    def step(q: torch.Tensor, v: torch.Tensor, m_eff: torch.Tensor):
        a = ring_pairwise_accel(q, m_eff * scalar(G, q.dtype), group=group,
                                eps=eps)
        h = scalar(dt, q.dtype)
        v = v + a * h
        return q + v * h, v

    return step


def body_split(mesh, n: int, *, body_axis: str = "body") -> tuple:
    """(first row, end row) of this rank's equal block of n bodies."""
    _, me, k = axis(mesh, body_axis)
    if n % k:
        raise ValueError(f"n={n} not a multiple of the body axis {k}")
    return me * (n // k), (me + 1) * (n // k)


def simulate_sharded(q, v, m, n_steps: int, mesh, *,
                     body_axis: str = "body", G: float = 6.674e-11,
                     eps: float = 1e-3, dt: float = 60.0, m_half=None,
                     fst=None, chunk: Optional[int] = None,
                     on_chunk: Optional[Callable] = None):
    """March a body-sharded system: every rank passes the whole initial
    state (host arrays or tensors (n, 3), (n,), n a multiple of the body
    axis), keeps its own block on its device and steps it through the
    ring. Returns the whole final (q, v) on every rank.

    m_half/fst: device-mass oscillation, m + m_half * fst[t] at step t
    (fst the oscillation table, 1-indexed by step); both or neither.
    chunk/on_chunk: after every `chunk` steps, on_chunk(step, q, v) on
    rank 0 with the whole host state (numpy)."""
    if fst is not None and m_half is None:
        raise ValueError("fst given without m_half: pass the device-mass "
                         "half-amplitudes (0.5 * m * device_mask)")
    dev = mesh_device(mesh)
    group, _, k = axis(mesh, body_axis)
    q, v, m = (torch.as_tensor(x) for x in (q, v, m))
    r0, r1 = body_split(mesh, q.shape[0], body_axis=body_axis)
    ql, vl = (x[r0:r1].to(dev).contiguous() for x in (q, v))
    gm0 = m[r0:r1].to(dev) * scalar(G, q.dtype)
    gmh = None
    if fst is not None:
        gmh = torch.as_tensor(m_half)[r0:r1].to(dev) * scalar(G, q.dtype)
        # the table as host scalars of the state's dtype
        fst = torch.as_tensor(np.asarray(fst)).to(q.dtype).tolist()
    h = scalar(dt, q.dtype)

    def whole(x):
        return all_gather(x, group, k).flatten(0, 1)

    step = 0
    chunk = chunk or n_steps
    while step < n_steps:
        n_sub = min(chunk, n_steps - step)
        for t in range(step + 1, step + n_sub + 1):
            gm = gm0 if gmh is None else gm0 + gmh * fst[t]
            a = ring_pairwise_accel(ql, gm, group=group, eps=eps)
            vl = vl + a * h
            ql = ql + vl * h
        step += n_sub
        if on_chunk is not None:
            qa, va = whole(ql), whole(vl)
            if dist.get_rank() == 0:
                on_chunk(step, qa.cpu().numpy(), va.cpu().numpy())
    return whole(ql), whole(vl)
