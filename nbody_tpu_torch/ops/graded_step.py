"""One chunk of the graded drivers' steps: force, Euler update and checks.

The three drivers of `models/direct_sum.py` advance a scenario batch step
by step and test every new state: the running min of the devices-off row's
planet-asteroid d², each missile's arrival and the devices-on snapshot
there, the first hit, and the Problem-3 rows' hits. `graded_chunk(mode, c,
s0, s1)` takes a `Carry` of that state from step s0 to s1.

The state is float64 (the graded answer), float32 (the throughput mode) or
double-double (precision 'tf3': float64 tensors with a trailing axis of 2,
(hi, lo), ops/ddfloat). On a CUDA tensor `graded_chunk` runs the graded
step kernel of that representation (csrc/graded_step_f64.cu, whose force is
kernel B1's in the carry's dist3 form; csrc/graded_step_f32.cu, kernel
B2's; csrc/graded_step_dd.cu, kernel B4's): one launch per step and one
closing check launch, no host synchronisation, as one replay of a CUDA
graph; the binary64 fused driver's chunk at small n is one launch of its
resident kernel, which the C call chooses by shape. The graph is captured
from one C call of the chunk's launches at the first chunk of its shape
and replayed for every chunk of that shape (ops/chunking `ChunkGraphs`): the
kernels read the chunk's base step from a device word that the host writes
before each replay. The wrappers `graded_step_f64`, `graded_step_f32` and
`graded_step_dd` count the launches a replay makes, as the C call reports
them, ops/chunking `GRAPHS` (also reachable here) the replays and captures,
and a request's record the chunks the resident kernel ran and the
binary64 step launches made as programmatic dependents of the step before
(utils/profiling). Only a tensor that lies on the CPU goes to the plain
version, the per-step PyTorch loop `_p12_chunk_ref`, `_p3_chunk_ref` or
`_p123_chunk_ref`, whose force is `ops/integrate`'s (kernels B1, B2 and B4
on a card, their plain versions on the CPU). Both compute the same bits:
every op of the kernels is the plain loop's op in the same order
(csrc/graded.cuh).

The mesh (parallel/solver_sharded.py) runs its steps in every
representation through `graded_rows_chunk(mode, c, s0, s1, blocks,
gather)`: a rank computes the force of its own rows [r0, r0 + ni) against
every body, updates those rows, and one `gather` (an in-place all_gather
over 'body') puts the ranks' rows together; every rank then checks the
whole state. The state lies in the layout that the all_gather makes
(ops/chunking `Blocks`), (k, 2, B, ni, 3): block r holds q and then v of the
rows [r * ni, (r + 1) * ni) of every scenario row (`to_blocks`,
`from_blocks`). On a CUDA tensor each step is one C call that launches the
graded step kernel on the rank's rows (the one-device kernel, of which one
device is the case k = 1) and one call of `gather`; a chunk ends with one
check launch. That loop, the in-place NCCL all_gathers with it, is
captured into a CUDA graph once and replayed for every chunk of its shape,
as on one device. On the CPU the plain version makes the same step in the
same order: the rows' force through the cross form of kernel B1 or B4
(float32: B2's cross form in the mesh's ordered sum at `tile`,
ops/accel_f32.accel_f32_ordered, bitwise the ordered ring's and at tile
128 B2's own), their update, the gather, and the checks of
`_p12_chunk_ref` or `_p3_chunk_ref`. Where the scenarios are split across
ranks, the P1+P2 `roles` name the rows a rank holds. There is one copy of
the graded checks.

The JAX package runs the same chunks as compiled scans
(nbody_tpu/models/direct_sum.py `_p12_chunk`, `_p123_chunk`, `_p3_chunks`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import torch

from ..utils import profiling
from . import ddfloat as ddf
from .accel_dd import accel_dd, eps2_dd
from .accel_f32 import TILE_J, accel_f32, accel_f32_ordered, eps2_f32
from .accel_f64 import accel_f64
# GRAPHS is also read here, as ops.graded_step.GRAPHS (benchmark/traffic)
from .chunking import GRAPHS, Blocks, ChunkGraphs, _stream, from_blocks, \
    to_blocks
from .forces import DIST3_CODES, sq_dist
from .integrate import scalar, symplectic_euler_step, \
    symplectic_euler_step_dd

P12, P3, P123 = 0, 1, 2
DRIVERS = {P12: "p12", P3: "p3", P123: "p123"}     # the chunk spans' names
_MAX_B = 65535          # the grid's y limit, which the batch rides


@dataclasses.dataclass
class Carry:
    """A graded driver's state and decision carries on one device; the
    chunk functions advance it in place. Rows are scenarios: P12 [P1, P2]
    (P1 alone after the P2 early exit), P3 one row per destroyed device,
    P123 [P1, P2, P3_0, ...]. Constants are the config's (G, eps, dt) and
    r2, the planet radius squared in the state's representation (a pair
    (hi, lo) for double-double), and the binary64 force's dist3 form.
    A double-double carry's real tensors have a trailing axis of 2.
    For `graded_rows_chunk`, q holds the state in blocks (`to_blocks`) and
    v is None. `graphs`: the carry's captured chunks on a card, made at its
    first chunk there (`ChunkGraphs`); the chunks keep q, v, arr and every
    other tensor where they are."""
    q: torch.Tensor             # (B, n, 3) float64 or float32
    v: torch.Tensor | None      # (B, n, 3)
    m0: torch.Tensor            # (B, n) base masses
    m_half: torch.Tensor        # (B, n) device half-masses
    fst: torch.Tensor           # (n_steps + 1,) oscillation table
    others: torch.Tensor        # int64 (1 + D,): asteroid, then devices
    arr: torch.Tensor           # int64 arrival steps: (D,), P3 (B,)
    hit: torch.Tensor           # int64 () first hit step; P3 bool (B,)
    planet: int
    G: float
    eps: float
    dt: float
    r2: float | tuple[float, float]
    md2: torch.Tensor | None = None     # (n_steps + 1,) missile radius²
    min_d2: torch.Tensor | None = None  # () running min of P1's d²
    p3_hit: torch.Tensor | None = None  # bool (D,), P123
    q_snap: torch.Tensor | None = None  # (D, n, 3) P2 at each arrival, P12
    v_snap: torch.Tensor | None = None
    dist3: str = "dsqrt"                # float64: 'dsqrt' or 'sqrt3'
    graphs: ChunkGraphs | None = dataclasses.field(default=None, repr=False,
                                                   compare=False)


def is_dd(x: torch.Tensor) -> bool:
    """Whether a carry tensor is double-double: float64 with a trailing
    axis of 2 after the shape it stands for (the state's (B, n, 3) or a
    scalar such as the min d²). The one test of the representation."""
    return x.dtype == torch.float64 and x.dim() > 0 and x.shape[-1] == 2


class _Native:
    """The plain chunks' arithmetic on float64 and float32 tensors."""

    @staticmethod
    def step(c: Carry, q, v, s: int, force=None):
        return symplectic_euler_step(q, v, c.m0 + c.m_half * c.fst[s],
                                     G=c.G, eps=c.eps, dt=c.dt,
                                     dist3_mode=c.dist3, force=force)

    @staticmethod
    def d2(qa, qb):
        return sq_dist(qa, qb)

    @staticmethod
    def lt(a, b):
        return a < b

    @staticmethod
    def minimum(a, b):
        return torch.minimum(a, b)

    @staticmethod
    def r2(c: Carry):
        return c.r2


class _DD:
    """The same in double-double (ops/ddfloat), the ops of
    csrc/graded_step_dd.cu in its order."""

    @staticmethod
    def step(c: Carry, q, v, s: int, force=None):
        m_eff = ddf.add(ddf.split(c.m0),
                        ddf.mul(ddf.split(c.m_half), ddf.split(c.fst[s])))
        return symplectic_euler_step_dd(q, v, ddf.join(m_eff), G=c.G,
                                        eps=c.eps, dt=c.dt, force=force)

    @staticmethod
    def d2(qa, qb):
        return ddf.join(ddf.sq_dist(ddf.split(qa), ddf.split(qb)))

    @staticmethod
    def lt(a, b):
        return ddf.lt(ddf.split(a), ddf.split(b))

    @staticmethod
    def minimum(a, b):
        return ddf.join(ddf.minimum(ddf.split(a), ddf.split(b)))

    @staticmethod
    def r2(c: Carry):
        return torch.tensor(c.r2, dtype=torch.float64, device=c.q.device)


def arith(q: torch.Tensor):
    """The plain chunks' arithmetic for a state tensor."""
    return _DD if is_dd(q) else _Native


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row mask shaped to broadcast over x's trailing axes."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def take_rows(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bodies idx (K,) of every scenario row of q (B, n, 3): (B, K, 3)."""
    return q[:, idx]


def _planet_d2(ar, q: torch.Tensor, idx: torch.Tensor,
               take=take_rows) -> torch.Tensor:
    """(B, K) squared distances from the planet, body idx[0], to bodies
    idx[1:] in every scenario row of q (B, n, 3)."""
    rows = take(q, idx)
    return ar.d2(rows[:, :1], rows[:, 1:])


def _p12_chunk_ref(c: Carry, s0: int, s1: int, step=None, take=take_rows,
                   roles: tuple | None = None) -> None:
    """Plain P1+P2 steps s0+1..s1 (the arrivals before the hit check, as
    hw5.cu:396-397 orders them); P2's checks only while its row runs.

    step(c, q, v, s) -> (q, v) advances the state (the arithmetic's own
    step by default); take gives the rows the checks read (`take_rows`);
    roles = (P1's row, P2's row), either None where this carry lacks it
    (default: P1 is row 0, P2 row 1 if there are two rows)."""
    q, v, arr, hit, min_d2 = c.q, c.v, c.arr, c.hit, c.min_d2
    q_snap, v_snap = c.q_snap, c.v_snap
    p1, p2 = roles if roles is not None else \
        (0, 1 if q.shape[0] == 2 else None)
    ar = arith(q)
    step = step or ar.step
    r2 = ar.r2(c)
    idx = torch.cat([c.others.new_tensor([c.planet]), c.others])
    for s in range(s0 + 1, s1 + 1):
        q, v = step(c, q, v, s)
        d2 = _planet_d2(ar, q, idx, take)            # (rows, 1 + D)
        if p1 is not None:
            min_d2 = ar.minimum(min_d2, d2[p1, 0])
        if p2 is None:
            continue
        arrived = (arr == -2) & ar.lt(d2[p2, 1:], c.md2[s])
        arr = torch.where(arrived, s, arr)
        sel = _rows(arrived, q_snap)
        q_snap = torch.where(sel, q[p2], q_snap)
        v_snap = torch.where(sel, v[p2], v_snap)
        hit = torch.where((hit == -2) & ar.lt(d2[p2, 0], r2), s, hit)
    c.q, c.v, c.arr, c.hit, c.min_d2 = q, v, arr, hit, min_d2
    c.q_snap, c.v_snap = q_snap, v_snap


def _p3_chunk_ref(c: Carry, s0: int, s1: int, step=None,
                  take=take_rows) -> None:
    """Plain Problem-3 steps s0+1..s1: a row moves from the step after its
    arrival on (destruction acts after the arrival) and flags its hits.
    step and take as `_p12_chunk_ref` has them."""
    q, v, hit = c.q, c.v, c.hit
    ar = arith(q)
    step = step or ar.step
    r2 = ar.r2(c)
    idx = torch.cat([c.others.new_tensor([c.planet]), c.others[:1]])
    for s in range(s0 + 1, s1 + 1):
        active = c.arr < s
        q2, v2 = step(c, q, v, s)
        q = torch.where(_rows(active, q), q2, q)
        v = torch.where(_rows(active, v), v2, v)
        pa = _planet_d2(ar, q, idx, take)[:, 0]
        hit = hit | (active & ar.lt(pa, r2))
    c.q, c.v, c.hit = q, v, hit


def _p123_chunk_ref(c: Carry, s0: int, s1: int) -> None:
    """Plain fused steps s0+1..s1: each P3 row is overwritten with the P2
    row's post-step state every step up to and including its missile's
    arrival (problem3_preprocess_gpu's snapshot, hw5.cu:265-287) and evolves
    on its own afterwards."""
    q, v, arr, hit, min_d2, p3_hit = (c.q, c.v, c.arr, c.hit, c.min_d2,
                                      c.p3_hit)
    p1p2_rows = torch.zeros((2,), dtype=torch.bool, device=q.device)
    ar = arith(q)
    r2 = ar.r2(c)
    idx = torch.cat([c.others.new_tensor([c.planet]), c.others])
    for s in range(s0 + 1, s1 + 1):
        pending = arr == -2                  # before this step's arrivals
        q, v = ar.step(c, q, v, s)
        d2 = _planet_d2(ar, q, idx)                  # before the mirror
        min_d2 = ar.minimum(min_d2, d2[0, 0])
        arr = torch.where(pending & ar.lt(d2[1, 1:], c.md2[s]), s, arr)
        # mirror the P2 row into pending and just-arrived P3 rows
        copy = _rows(torch.cat([p1p2_rows, pending]), q)
        q = torch.where(copy, q[1:2], q)
        v = torch.where(copy, v[1:2], v)
        # a mirrored row's planet-asteroid d² is the P2 row's; P3 rows are
        # checked from their arrival step on (hw5.cu:292-298)
        d2_p3 = torch.where(_rows(pending, d2[2:, 0]), d2[1, 0], d2[2:, 0])
        p3_hit = p3_hit | ((arr != -2) & ar.lt(d2_p3, r2))
        hit = torch.where((hit == -2) & ar.lt(d2[1, 0], r2), s, hit)
    c.q, c.v, c.arr, c.hit, c.min_d2, c.p3_hit = (q, v, arr, hit, min_d2,
                                                  p3_hit)


_REF = {P12: _p12_chunk_ref, P3: _p3_chunk_ref, P123: _p123_chunk_ref}


def _check(mode: int, c: Carry, s0: int, s1: int,
           blocks: Blocks | None = None) -> None:
    """Refuse a carry the chunk does not take: c.q (B, n, 3), or in
    `blocks` (k, 2, B, ni, 3) with c.v None."""
    if mode not in _REF:
        raise ValueError(f"unknown graded mode {mode!r}")
    dtype = c.q.dtype
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"graded_chunk takes a float64, float32 or "
                        f"double-double state, got {dtype}")
    tail = (2,) if is_dd(c.q) else ()
    real = {}
    if blocks is None:
        if c.q.dim() != 3 + len(tail) or c.q.shape[2:] != (3, *tail) \
                or c.q.shape[0] < 1 or c.q.shape[1] < 1:
            raise ValueError(f"graded_chunk takes q (B, n, 3), or "
                             f"(B, n, 3, 2) double-double, B, n >= 1, got "
                             f"{tuple(c.q.shape)}")
        B, n = c.q.shape[:2]
        real["v"] = (c.v, (B, n, 3))
    else:
        B, n = c.q.shape[2] if c.q.dim() > 2 else 0, blocks.n
        want = (blocks.k, 2, B, blocks.ni, 3, *tail)
        if tuple(c.q.shape) != want or B < 1 or c.v is not None:
            raise ValueError(f"graded_rows_chunk takes q in {blocks.k} "
                             f"blocks, (k, 2, B, ni, 3) = {want}, and v "
                             f"None, got q {tuple(c.q.shape)}")
    D = c.others.shape[0] - 1
    real.update(m0=(c.m0, (B, n)), m_half=(c.m_half, (B, n)),
                fst=(c.fst, None))
    ints = {"others": (c.others, (D + 1,))}
    if mode == P3:
        ints["arr"] = (c.arr, (B,))
        flags = {"hit": (c.hit, (B,))}
    else:
        real.update(md2=(c.md2, None), min_d2=(c.min_d2, ()))
        ints.update(arr=(c.arr, (D,)), hit=(c.hit, ()))
        flags = {}
        if mode == P12:
            if B > 2:
                raise ValueError(f"P12 takes 1 or 2 rows, got {B}")
            real.update(q_snap=(c.q_snap, (D, n, 3)),
                        v_snap=(c.v_snap, (D, n, 3)))
        else:
            if B != 2 + D:
                raise ValueError(f"P123 takes 2 + D = {2 + D} rows, got {B}")
            flags["p3_hit"] = (c.p3_hit, (D,))
    if not 1 <= B <= _MAX_B:
        raise ValueError(f"graded_chunk takes 1 <= B <= {_MAX_B}, got {B}")
    tensors = [("q", c.q, dtype)]
    for kinds, want, extra in ((real, dtype, tail), (ints, torch.int64, ()),
                               (flags, torch.bool, ())):
        for name, (x, shape) in kinds.items():
            if x is None:
                raise ValueError(f"graded mode {mode} needs {name}")
            if shape is not None and tuple(x.shape) != shape + extra:
                raise ValueError(f"{name} has shape {tuple(x.shape)}, not "
                                 f"{shape + extra}")
            tensors.append((name, x, want))
    for name, x, want in tensors:
        if x.dtype != want:
            raise TypeError(f"{name} is {x.dtype}, not {want}")
        if x.device != c.q.device:
            raise ValueError(f"{name} on {x.device} but q on {c.q.device}")
        if not x.is_contiguous():
            raise ValueError(f"graded_chunk takes contiguous tensors ({name})")
    for table in ("fst", "md2"):
        x = getattr(c, table)
        if x is not None and (x.dim() != 1 + len(tail) or x.shape[0] <= s1
                              or tuple(x.shape[1:]) != tail):
            raise ValueError(f"{table} must be 1-D (of pairs, double-double) "
                             f"with more than s1 = {s1} entries, got "
                             f"{tuple(x.shape)}")
    if not 0 <= s0 < s1:
        raise ValueError(f"graded_chunk takes 0 <= s0 < s1, got {s0}, {s1}")
    if not 0 <= c.planet < n:
        raise ValueError(f"planet {c.planet} outside 0..{n - 1}")
    if tail and len(c.r2) != 2:
        raise ValueError(f"a double-double carry takes r2 as (hi, lo), got "
                         f"{c.r2!r}")
    if dtype == torch.float64 and not tail and c.dist3 not in DIST3_CODES:
        raise ValueError(f"the binary64 step takes dist3 'dsqrt' or 'sqrt3', "
                         f"got {c.dist3!r}")


def _graphs(c: Carry) -> ChunkGraphs:
    if c.graphs is None:
        c.graphs = ChunkGraphs()
    return c.graphs


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _constants(c: Carry) -> tuple:
    """The C call's constants after its ints: G, dt, eps2, r2 in the
    state's representation (double-double as (hi, lo) pairs)."""
    if is_dd(c.q):
        return (c.G, 0.0, c.dt, 0.0, *eps2_dd(c.eps), *c.r2)
    if c.q.dtype == torch.float32:
        return (scalar(c.G, c.q.dtype), scalar(c.dt, c.q.dtype),
                eps2_f32(c.eps), c.r2)
    return (c.G, c.dt, c.eps * c.eps, c.r2)


def _key(kind: str, mode: int, c: Carry, K: int, extra: tuple,
         tensors: tuple) -> tuple:
    """A graph's key: what decides its captured work."""
    return (kind, mode, c.q.dtype, is_dd(c.q), tuple(c.q.shape), K,
            c.others.shape[0] - 1, c.planet, extra, _constants(c),
            c.q.device, tuple(_ptr(x) for x in tensors))


def _launch(fn, mode: int, c: Carry, s0: int, s1: int) -> None:
    """Steps s0+1..s1 on the card as one replay of the carry's graph of
    K = s1 - s0 steps."""
    if c.q.device.type != "cuda":
        raise ValueError(f"{fn.__name__} runs on cuda, not {c.q.device}")
    from . import _build

    with torch.cuda.device(c.q.device):
        _replay_chunk(fn, mode, c, s0, s1, _build.load())


def b1_geometry(lib, B: int, n: int, ni: int) -> str:
    """The name of the geometry of B1''s launch-a-step kernel that the
    library `lib` takes at B scenario rows of n bodies, ni of them a launch
    (csrc/graded_step_f64.cu graded_step_f64_geometry),
    `producer_<R>x<RT>_tile<TJ>_ring<NBUF>`: R rows a block, RT of them a
    compute thread, TJ columns a tile, NBUF term tiles in the ring."""
    out = (ctypes.c_int * 5)()
    rc = lib.graded_step_f64_geometry(B, n, ni, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"graded_step_f64_geometry({B}, {n}, {ni}) "
                           f"failed: CUDA error {rc}")
    _, R, RT, TJ, NBUF = out
    return f"producer_{R}x{RT}_tile{TJ}_ring{NBUF}"


def _replay_chunk(fn, mode: int, c: Carry, s0: int, s1: int, lib) -> None:
    """The replay for steps s0+1..s1 of the graph captured from one C call
    of `graded_chunk_*_launch` (K step launches and one check launch, or
    one launch of the resident chunk) and, for an odd K, the copy of the
    result from the second buffer into (c.q, c.v); the arrivals stay in
    c.arr (csrc/graded.cuh). The launches the C call reported at the
    capture are added to `fn.launches`, and those of its step launches
    made as programmatic dependents of the step before (the binary64 step
    kernel's, steps 2 .. K of a launch-a-step chunk) to
    `fn.pdl_launches` and the request's record; a chunk of one launch is
    the resident kernel's, counted in the record, and a binary64 chunk of
    more its rows x steps under B1''s geometry (`b1_geometry`). `lib`: the
    kernel library, or a stand-in in the CPU tests."""
    K = s1 - s0
    if is_dd(c.q):
        launch, ints = lib.graded_chunk_dd_launch, ()
    elif c.q.dtype == torch.float32:
        launch, ints = lib.graded_chunk_f32_launch, ()
    else:
        launch, ints = lib.graded_chunk_f64_launch, (DIST3_CODES[c.dist3],)
    q, v, arr = c.q, c.v, c.arr
    B, n = q.shape[0], q.shape[1]
    flag = c.hit if mode == P3 else c.p3_hit
    hit = None if mode == P3 else c.hit
    tensors = (c.m0, c.m_half, c.fst, c.md2, c.others, arr, hit, flag,
               c.min_d2, c.q_snap, c.v_snap)
    reals = _constants(c)

    def build(word: torch.Tensor) -> Callable[[], None]:
        q2, v2 = torch.empty_like(q), torch.empty_like(v)
        arr2 = arr if mode == P3 else arr.clone()   # P3's arr: read only
        head = (_ptr(q), _ptr(v), _ptr(q2), _ptr(v2),
                *(_ptr(x) for x in tensors[:6]), _ptr(arr2),
                *(_ptr(x) for x in tensors[6:]), mode, B, n,
                c.others.shape[0] - 1, c.planet, *ints, *reals,
                word.data_ptr(), K)
        # the launches made, then the programmatic ones among them (only
        # graded_chunk_f64_launch writes the second)
        counts = (ctypes.c_int * 2)()

        def body() -> None:
            if arr2 is not arr:
                arr2.copy_(arr)       # the second arrival buffer, on entry
            rc = launch(*head, ctypes.addressof(counts), _stream(q))
            if rc != 0:
                raise RuntimeError(f"{fn.__name__} kernel launch failed: "
                                   f"CUDA error {rc}")
            if K % 2:
                q.copy_(q2)
                v.copy_(v2)
        body.launched = ctypes.c_int.from_buffer(counts)
        body.dependents = ctypes.c_int.from_buffer(counts, 4)
        body.geometry = b1_geometry(lib, B, n, n) \
            if fn is graded_step_f64 else None
        return body

    body = _graphs(c).run(_key("chunk", mode, c, K, ints, (q, v) + tensors),
                          build, q.device, s0)
    fn.launches += body.launched.value
    if body.dependents.value:
        fn.pdl_launches += body.dependents.value
        profiling.pdl_launched(body.dependents.value)
    if body.launched.value == 1:
        profiling.resident_chunk()
    elif body.geometry is not None:
        profiling.b1_launch_rows(body.geometry, B * K)


def graded_step_f64(mode: int, c: Carry, s0: int, s1: int) -> None:
    """Steps s0+1..s1 of a float64 carry on its card through the fp64 graded
    step kernel; adds its launches to `graded_step_f64.launches`, those
    made as programmatic dependents also to
    `graded_step_f64.pdl_launches`."""
    _check(mode, c, s0, s1)
    if c.q.dtype != torch.float64 or is_dd(c.q):
        raise TypeError(f"graded_step_f64 takes float64 (B, n, 3), got "
                        f"{c.q.dtype} {tuple(c.q.shape)}")
    _launch(graded_step_f64, mode, c, s0, s1)


def graded_step_f32(mode: int, c: Carry, s0: int, s1: int) -> None:
    """Steps s0+1..s1 of a float32 carry on its card through the fp32 graded
    step kernel; adds its launches to `graded_step_f32.launches`."""
    _check(mode, c, s0, s1)
    if c.q.dtype != torch.float32:
        raise TypeError(f"graded_step_f32 takes float32, got {c.q.dtype}")
    _launch(graded_step_f32, mode, c, s0, s1)


def graded_step_dd(mode: int, c: Carry, s0: int, s1: int) -> None:
    """Steps s0+1..s1 of a double-double carry on its card through the
    double-double graded step kernel (B4'); adds its launches to
    `graded_step_dd.launches`."""
    _check(mode, c, s0, s1)
    if not is_dd(c.q):
        raise TypeError(f"graded_step_dd takes double-double (B, n, 3, 2) "
                        f"float64, got {c.q.dtype} {tuple(c.q.shape)}")
    _launch(graded_step_dd, mode, c, s0, s1)


graded_step_f64.launches = 0
graded_step_f64.pdl_launches = 0
graded_step_f32.launches = 0
graded_step_dd.launches = 0


def _rows_ref(mode: int, c: Carry, s0: int, s1: int, blocks: Blocks,
              gather, roles, tile: int) -> None:
    """The plain row-range chunk: each step, the force of the rows of
    `blocks.mine` through the cross form of kernel B1, B4 or (in the
    ordered sum at `tile`) B2, their update, `gather` of the blocks, then
    the plain chunk's checks on the whole state."""
    n, shape = blocks.n, c.q.shape
    q, v = from_blocks(c.q, n)
    ar = arith(q)
    if is_dd(q):
        cross = functools.partial(accel_dd, eps=c.eps)
    elif q.dtype == torch.float32:
        cross = functools.partial(accel_f32_ordered, eps=c.eps, tile=tile,
                                  force=accel_f32)
    else:
        cross = functools.partial(accel_f64, eps=c.eps, dist3_mode=c.dist3)

    def step(cc, q, v, s):
        out = q.new_zeros(shape)
        for r in blocks.mine:
            r0, r1 = blocks.rows(r)
            if r1 > r0:
                qr = q[:, r0:r1].contiguous()
                qn, vn = ar.step(cc, qr, v[:, r0:r1], s,
                                 force=lambda _, gm: cross(qr, q, gm))
                out[r, 0, :, :r1 - r0] = qn
                out[r, 1, :, :r1 - r0] = vn
        if gather is not None:
            gather(out)
            profiling.gathered(1, out.numel() * out.element_size())
        return from_blocks(out, n)

    whole = dataclasses.replace(c, q=q, v=v)
    if mode == P12:
        _p12_chunk_ref(whole, s0, s1, step=step, roles=roles)
    else:
        _p3_chunk_ref(whole, s0, s1, step=step)
    for name in ("arr", "hit", "min_d2", "q_snap", "v_snap"):
        setattr(c, name, getattr(whole, name))
    c.q = to_blocks(whole.q, whole.v, blocks.k)


def _launch_rows(fn, mode: int, c: Carry, s0: int, s1: int, blocks: Blocks,
                 gather, roles, tile: int) -> None:
    """Steps s0+1..s1 of a mesh rank on the card as one replay of the
    carry's graph of K = s1 - s0 steps."""
    if c.q.device.type != "cuda":
        raise ValueError(f"{fn.__name__} runs on cuda, not {c.q.device}")
    from . import _build

    with torch.cuda.device(c.q.device):
        _replay_rows(fn, mode, c, s0, s1, blocks, gather, roles, tile,
                     _build.load())


def _replay_rows(fn, mode: int, c: Carry, s0: int, s1: int, blocks: Blocks,
                 gather, roles, tile: int, lib) -> None:
    """The replay for steps s0+1..s1 of the graph captured from a C call a
    step on each block of `blocks.mine` (one launch of the graded step
    kernel on its rows), `gather` after each step (an in-place NCCL
    all_gather on a card, captured with the launches), one check launch
    and, for an odd K, the copy of the result from the second buffer into
    c.q; the gathers and their bytes counted in the open request as the
    graph captured them. `lib`: the kernel library, or a stand-in in the
    CPU tests."""
    K = s1 - s0
    if is_dd(c.q):
        launch, ints = lib.graded_rows_dd_step, ()
    elif c.q.dtype == torch.float32:
        launch, ints = lib.graded_rows_f32_step, (tile,)
    else:
        launch, ints = lib.graded_rows_f64_step, (DIST3_CODES[c.dist3],)
    q, arr = c.q, c.arr
    p1, p2 = (-1 if r is None else r for r in roles)
    ni, mine = blocks.ni, blocks.mine
    tensors = (c.m0, c.m_half, c.fst, c.md2, c.others, arr,
               None if mode == P3 else c.hit,
               c.hit if mode == P3 else None, c.min_d2, c.q_snap, c.v_snap)

    def build(word: torch.Tensor) -> Callable[[], None]:
        q2 = torch.zeros_like(q)    # rows past n stay zero, as to_blocks's
        arr2 = arr if mode == P3 else arr.clone()
        head = (*(_ptr(x) for x in tensors[:6]), _ptr(arr2),
                *(_ptr(x) for x in tensors[6:]), mode, q.shape[2], blocks.n,
                c.others.shape[0] - 1, c.planet, p1, p2, ni, blocks.k,
                *ints, *_constants(c))
        bufs = (q, q2)
        ptrs = [x.data_ptr() for x in bufs]
        base = word.data_ptr()

        def body() -> None:
            if arr2 is not arr:
                arr2.copy_(arr)
            stream = _stream(q)

            def call(src, dst, r, off, check):
                rc = launch(*head, src, dst, r * ni, base, off, check, stream)
                if rc != 0:
                    raise RuntimeError(f"{fn.__name__} kernel launch "
                                       f"failed: CUDA error {rc}")

            for off in range(1, K + 1):
                i = (off - 1) & 1
                for r in mine:
                    call(ptrs[i], ptrs[i ^ 1], r, off, int(off > 1))
                if gather is not None:
                    gather(bufs[i ^ 1])
            last = K & 1
            call(ptrs[last], None, mine[0], K, 0)
            if last:
                q.copy_(q2)
        body.gathers = 0 if gather is None else K
        body.gather_bytes = body.gathers * q.numel() * q.element_size()
        body.geometry = None if fn is not graded_step_f64 else \
            b1_geometry(lib, q.shape[2], blocks.n, ni)
        return body

    extra = (*ints, blocks, roles, gather)
    body = _graphs(c).run(_key("rows", mode, c, K, extra, (q,) + tensors),
                          build, q.device, s0)
    fn.launches += K * len(mine) + 1
    profiling.gathered(body.gathers, body.gather_bytes)
    if body.geometry is not None:
        profiling.b1_launch_rows(body.geometry, q.shape[2] * K)


def graded_rows_chunk(mode: int, c: Carry, s0: int, s1: int, blocks: Blocks,
                      gather=None, roles: tuple | None = None,
                      tile: int = TILE_J) -> None:
    """Advance a mesh rank's carry c from step s0 to s1 in driver `mode`
    (P12 or P3; the mesh has no fused driver). c.q is the state in
    `blocks` (`to_blocks`), float64, float32 or double-double, and c.v
    None; every other field is as `graded_chunk` has it. A float32 force
    is the mesh's ordered sum at `tile` (bitwise `graded_chunk`'s at tile
    128).

    Each step computes the rows of the blocks `blocks.mine` and then calls
    gather(qv), which must fill the other blocks of qv in place (an
    all_gather of the ranks' blocks); without a gather, mine must be every
    block. roles = (P1's row, P2's row) in P12, either None where the
    carry lacks it (default: P1 is row 0, P2 row 1 if there are two rows).
    CUDA tensors run the graded step kernel of their representation on the
    rows, the chunk as one replay of a CUDA graph that holds the gathers
    too (`ChunkGraphs`), and add its launches to
    `graded_step_f64.launches`, `graded_step_f32.launches` or
    `graded_step_dd.launches`; CPU tensors run the plain version. Inside a
    request the chunk is a span (utils/profiling.chunk) of the carry's B
    rows."""
    B = c.q.shape[2] if c.q.dim() > 2 else 0
    if mode == P12 and roles is None:
        roles = (0, 1 if B == 2 else None)
    if mode not in (P12, P3):
        raise ValueError(f"graded_rows_chunk takes P12 or P3, got {mode!r}")
    if c.q.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"graded_rows_chunk takes a float64, float32 or "
                        f"double-double state, got {c.q.dtype}")
    if not isinstance(tile, int) or tile < 1:
        raise ValueError(f"the float32 mesh's tile is a positive source "
                         f"count, got {tile!r}")
    mine = blocks.mine
    if blocks.k < 1 or not mine or len(set(mine)) != len(mine) \
            or not all(0 <= r < blocks.k for r in mine) \
            or len(mine) != (blocks.k if gather is None else 1):
        raise ValueError(f"graded_rows_chunk takes its rank's block and a "
                         f"gather, or all k blocks without one, got {blocks}"
                         f" and gather {gather!r}")
    if mode == P3:
        if roles is not None:
            raise ValueError(f"P3 rows have no roles, got {roles}")
        roles = (None, None)
    elif len(roles) != 2 or roles[0] == roles[1] \
            or sum(r is not None for r in roles) != B \
            or not all(r is None or 0 <= r < B for r in roles):
        raise ValueError(f"P12 roles name the carry's {B} rows, got {roles}")
    _check(mode, c, s0, s1, blocks)
    with profiling.chunk(DRIVERS[mode], B, s1 - s0, c.q.device):
        if c.q.device.type == "cpu":
            _rows_ref(mode, c, s0, s1, blocks, gather, roles, tile)
            return
        fn = graded_step_dd if is_dd(c.q) else \
            graded_step_f32 if c.q.dtype == torch.float32 else \
            graded_step_f64
        _launch_rows(fn, mode, c, s0, s1, blocks, gather, roles, tile)


def graded_chunk(mode: int, c: Carry, s0: int, s1: int) -> None:
    """Advance c from step s0 to s1 (0 <= s0 < s1) in driver `mode` (P12,
    P3 or P123). CUDA tensors run the graded step kernel of their
    representation, the chunk as one replay of a CUDA graph
    (`ChunkGraphs`; c.q, c.v and c.arr hold the result where they lie);
    CPU tensors run the plain chunk. Inside a request the chunk is a span
    (utils/profiling.chunk) of c.q's rows."""
    _check(mode, c, s0, s1)
    with profiling.chunk(DRIVERS[mode], c.q.shape[0], s1 - s0, c.q.device):
        if c.q.device.type == "cpu":
            _REF[mode](c, s0, s1)
        elif is_dd(c.q):
            graded_step_dd(mode, c, s0, s1)
        elif c.q.dtype == torch.float64:
            graded_step_f64(mode, c, s0, s1)
        else:
            graded_step_f32(mode, c, s0, s1)
