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
B2's; csrc/graded_step_dd.cu, kernel B4's): one C call, one launch per step
and one closing check launch, no host synchronisation. The wrappers
`graded_step_f64`, `graded_step_f32` and `graded_step_dd` count those
launches. Only a tensor that lies on the CPU goes to the plain version,
the per-step PyTorch loop `_p12_chunk_ref`, `_p3_chunk_ref` or
`_p123_chunk_ref`, whose force is `ops/integrate`'s (kernels B1, B2 and B4
on a card, their plain versions on the CPU). Both compute the same bits:
every op of the kernels is the plain loop's op in the same order
(csrc/graded.cuh).

The plain P1+P2 and Problem-3 chunks also serve the mesh
(parallel/solver_sharded.py), which hands them its own `step` (the force
of its rows through the kernel's cross form, then a gather; or the ordered
ring over a body-sharded state), its own `take` (the planet's, asteroid's
and devices' rows of a sharded state) and, for P1+P2, the `roles` of its
rows when the scenarios are split across ranks. There is one copy of the
graded checks.

The JAX package runs the same chunks as compiled scans
(nbody_tpu/models/direct_sum.py `_p12_chunk`, `_p123_chunk`, `_p3_chunks`).
"""

from __future__ import annotations

import dataclasses

import torch

from . import ddfloat as ddf
from .accel_dd import eps2_dd
from .accel_f32 import eps2_f32
from .forces import DIST3_CODES, sq_dist
from .integrate import scalar, symplectic_euler_step, \
    symplectic_euler_step_dd

P12, P3, P123 = 0, 1, 2
_MAX_B = 65535          # the grid's y limit, which the batch rides


@dataclasses.dataclass
class Carry:
    """A graded driver's state and decision carries on one device; the
    chunk functions advance it in place. Rows are scenarios: P12 [P1, P2]
    (P1 alone after the P2 early exit), P3 one row per destroyed device,
    P123 [P1, P2, P3_0, ...]. Constants are the config's (G, eps, dt) and
    r2, the planet radius squared in the state's representation (a pair
    (hi, lo) for double-double), and the binary64 force's dist3 form.
    A double-double carry's real tensors have a trailing axis of 2."""
    q: torch.Tensor             # (B, n, 3) float64 or float32
    v: torch.Tensor             # (B, n, 3)
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


def _check(mode: int, c: Carry, s0: int, s1: int) -> None:
    if mode not in _REF:
        raise ValueError(f"unknown graded mode {mode!r}")
    dtype = c.q.dtype
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"graded_chunk takes a float64, float32 or "
                        f"double-double state, got {dtype}")
    tail = (2,) if is_dd(c.q) else ()
    if c.q.dim() != 3 + len(tail) or c.q.shape[2:] != (3, *tail) \
            or c.q.shape[0] < 1 or c.q.shape[1] < 1:
        raise ValueError(f"graded_chunk takes q (B, n, 3), or (B, n, 3, 2) "
                         f"double-double, B, n >= 1, got {tuple(c.q.shape)}")
    B, n = c.q.shape[:2]
    D = c.others.shape[0] - 1
    real = {"v": (c.v, (B, n, 3)), "m0": (c.m0, (B, n)),
            "m_half": (c.m_half, (B, n)), "fst": (c.fst, None)}
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


def _launch(fn, mode: int, c: Carry, s0: int, s1: int) -> None:
    """One C call: s1 - s0 step launches and one check launch."""
    if c.q.device.type != "cuda":
        raise ValueError(f"{fn.__name__} runs on cuda, not {c.q.device}")
    from . import _build

    lib = _build.load()
    q2, v2 = torch.empty_like(c.q), torch.empty_like(c.v)
    arr2 = c.arr if mode == P3 else c.arr.clone()
    flag = c.hit if mode == P3 else c.p3_hit
    if is_dd(c.q):
        launch = lib.graded_chunk_dd_launch
        ints = ()
        reals = (c.G, 0.0, c.dt, 0.0, *eps2_dd(c.eps), *c.r2)
    elif c.q.dtype == torch.float32:
        launch = lib.graded_chunk_f32_launch
        ints = ()
        reals = (scalar(c.G, c.q.dtype), scalar(c.dt, c.q.dtype),
                 eps2_f32(c.eps), c.r2)
    else:
        launch = lib.graded_chunk_f64_launch
        ints = (DIST3_CODES[c.dist3],)
        reals = (c.G, c.dt, c.eps * c.eps, c.r2)
    ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
    with torch.cuda.device(c.q.device):
        rc = launch(
            ptr(c.q), ptr(c.v), ptr(q2), ptr(v2), ptr(c.m0), ptr(c.m_half),
            ptr(c.fst), ptr(c.md2), ptr(c.others), ptr(c.arr), ptr(arr2),
            None if mode == P3 else ptr(c.hit), ptr(flag), ptr(c.min_d2),
            ptr(c.q_snap), ptr(c.v_snap), mode, c.q.shape[0], c.q.shape[1],
            c.others.shape[0] - 1, c.planet, *ints, *reals, s0, s1,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{rc}")
    fn.launches += s1 - s0 + 1
    if (s1 - s0) % 2:
        c.q, c.v = q2, v2
    if mode != P3 and s1 % 2:    # the checks of step p write arr[p & 1]
        c.arr = arr2


def graded_step_f64(mode: int, c: Carry, s0: int, s1: int) -> None:
    """Steps s0+1..s1 of a float64 carry on its card through the fp64 graded
    step kernel; adds its launches to `graded_step_f64.launches`."""
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
graded_step_f32.launches = 0
graded_step_dd.launches = 0


def graded_chunk(mode: int, c: Carry, s0: int, s1: int) -> None:
    """Advance c from step s0 to s1 (0 <= s0 < s1) in driver `mode` (P12,
    P3 or P123). CUDA tensors run the graded step kernel of their
    representation; CPU tensors run the plain chunk."""
    _check(mode, c, s0, s1)
    if c.q.device.type == "cpu":
        _REF[mode](c, s0, s1)
    elif is_dd(c.q):
        graded_step_dd(mode, c, s0, s1)
    elif c.q.dtype == torch.float64:
        graded_step_f64(mode, c, s0, s1)
    else:
        graded_step_f32(mode, c, s0, s1)
