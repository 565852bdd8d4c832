"""simulate()'s step loops: the eager PyTorch loops, and their kernels.

`eager_chunk` advances a `SimCarry` by a chunk of steps, a few PyTorch ops
a step around one force call (ops/integrate), in float32 and binary64 and
on the mesh; `eager_chunk_dd` does the same in double-double (precisions
'tf3', 'ddp', 'dd+'). The JAX package compiles a chunk into one scan
(`nbody_tpu.simulate._chunk_scan`); on one card the port runs it in a
step kernel, one C call a chunk, the masses, the force and the update
(Euler or leapfrog, with or without Kahan compensation) in the eager
loop's ops and order, so its bits are the eager loop's around the force
kernel:

  * `sim_chunk_f64`, csrc/sim_step_f64.cu, kernel B1's force (the port of
    `nbody_tpu.ops.pallas_forces_e64._e64_kernel` in the scan), and
    `sim_chunk_f32`, csrc/sim_step_f32.cu, kernel B2's force (of
    `nbody_tpu.ops.pallas_forces._accel_kernel`): up to a size set in
    each source (512 bodies in binary64, 8192 in float32) one persistent
    cooperative launch a chunk, its blocks resident for the chunk's K
    steps with a grid barrier between two steps (csrc/sim_step.cuh), on
    min(row blocks, the blocks the card holds at once) blocks, or fewer
    (`grid_cap`, which the card tests use to make each block walk many
    row blocks); above it a pre-launch and one launch a step of the
    kernel's row-range form on all n rows, which measured faster there;
  * `sim_chunk_dd`, csrc/sim_step_dd.cu, kernel B4's force (of the scan
    around `nbody_tpu.ops.forces.pairwise_accel_tf3`), without
    compensation: a pre-launch and one launch a step.

On a CUDA carry each launches its kernel or raises; a CPU carry goes to
its plain version (`sim_chunk_f64_ref`, `sim_chunk_f32_ref`,
`sim_chunk_dd_ref`): the eager loop with the force kernel's plain twin as
its force.

Given `graphs` (ops/chunking `ChunkGraphs`, which `simulate` passes
for a chunk shape that repeats), a CUDA chunk is one replay of a CUDA
graph, captured from the chunk's C call at the first chunk of its shape:
the kernels read the chunk's base step from a device word written before
each replay (csrc/sim_step.cuh), and the state stays in the carry's own
pair of state buffers (`SimCarry.slots`), the graph copying an odd
chunk's result back into the first. Without it, one direct C call on a
fresh pair.

The mesh (`simulate(mesh=)`) runs the row-range form of the same kernels
(`sim_rows_chunk_f64`, `sim_rows_chunk_f32`, `sim_rows_chunk_dd`): every
rank holds the whole carry, and a step is one launch on the rank's rows
(those of its block of ops/chunking `Blocks`) and one in-place
all_gather (`gather`) of the positions the next step's force reads
(csrc/sim_step.cuh has the layout); a chunk starts with one launch that
forms the first step's inputs and ends with one all_gather of the carry
(into a buffer of the graph's own, with `graphs`: the graph holds the
launches and every all_gather of the chunk).
In float32 the force is the mesh's ordered sum at tile T
(ops/accel_f32.accel_f32_ordered, bitwise the ordered ring's, B2's at
T = 128). Their plain versions (`sim_rows_chunk_*_ref`) are the eager
loops whose force is the cross form's plain twin on the rank's rows and
an all_gather of those rows' forces. The bits are the one-device eager
loop's on every mesh shape (in float32 at one tile). Each all_gather is
counted in the open request's record (utils/profiling `gathered`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..utils import profiling
from . import ddfloat as ddf
from .accel_dd import accel_dd_ref, eps2_dd
from .accel_f32 import TILE_J, accel_f32_ordered, accel_f32_ref, eps2_f32
from .accel_f64 import accel_f64_ref
from .forces import DIST3_CODES
from .chunking import Blocks, ChunkGraphs, _stream
from .integrate import accel, kdk_leapfrog_step, kdk_leapfrog_step_dd, \
    scalar, symplectic_euler_step, symplectic_euler_step_dd

INTEGRATORS = ("euler", "leapfrog")
# the state buffer's slots of n * 3 values (csrc/sim_step.cuh SimSlot):
# q, v, a, qc and vc come first
SLOTS = 10


@dataclasses.dataclass
class SimCarry:
    """simulate's state between steps: positions, velocities, the
    leapfrog's acceleration at q (None for Euler) and the Kahan
    compensations (None without compensation). Double-double tensors carry
    a trailing axis of 2 (ops/ddfloat). `graphs`: the run's captured
    chunks (simulate makes them where a chunk shape repeats); `slots`: the
    pair of state buffers (2, SLOTS, rows, 3[, 2]) that the graph path
    keeps the state in, its q, v, a, qc and vc views of the first."""
    q: torch.Tensor
    v: torch.Tensor
    a: Optional[torch.Tensor] = None
    qc: Optional[torch.Tensor] = None
    vc: Optional[torch.Tensor] = None
    graphs: Optional[ChunkGraphs] = dataclasses.field(
        default=None, repr=False, compare=False)
    slots: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)


def comp_add(x, c, d):
    """Kahan compensated x += d with running compensation c.

    y = d - c recovers the low-order bits lost on previous adds; the new
    compensation is the rounding error of t = x + y, extracted exactly by
    (t - x) - y (|y| <= |x| in the integration regime). Three eager ops:
    under torch.compile or a fused op the extraction could be simplified
    away (the step kernels write each as a round-to-nearest intrinsic)."""
    y = d - c
    t = x + y
    return t, (t - x) - y


def eager_chunk(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                fst, s0: int, s1: int, *, G: float, eps: float, dt: float,
                integrator: str, compensated: bool,
                dist3_mode: str = "dsqrt", force=None) -> None:
    """Steps s0+1..s1 of simulate's eager loop on c, in place: step s runs
    under m_eff = m0 + m_half * fst[s] (fst host floats of the state's
    dtype) and the force of ops/integrate.accel, or `force(q, gm)`."""
    kick, drift = scalar(0.5 * dt, c.q.dtype), scalar(dt, c.q.dtype)
    kw = {"G": G, "eps": eps, "dist3_mode": dist3_mode, "force": force}
    q, v, a, qc, vc = c.q, c.v, c.a, c.qc, c.vc
    for s in range(s0 + 1, s1 + 1):
        m_eff = m0 + m_half * fst[s]
        if integrator == "leapfrog" and compensated:
            v, vc = comp_add(v, vc, a * kick)
            q, qc = comp_add(q, qc, v * drift)
            a = accel(q, m_eff, **kw)
            v, vc = comp_add(v, vc, a * kick)
        elif integrator == "leapfrog":
            q, v, a = kdk_leapfrog_step(q, v, a, m_eff, dt=dt, **kw)
        elif compensated:
            acc = accel(q, m_eff, **kw)
            v, vc = comp_add(v, vc, acc * drift)
            q, qc = comp_add(q, qc, v * drift)
        else:
            q, v = symplectic_euler_step(q, v, m_eff, dt=dt, **kw)
    c.q, c.v, c.a, c.qc, c.vc = q, v, a, qc, vc


def m_eff_dd(m0: torch.Tensor, m_half: torch.Tensor,
             f: float) -> torch.Tensor:
    """m0 + m_half * f in double-double, f a binary64 value."""
    return ddf.join(ddf.add(ddf.split(m0),
                            ddf.mul(ddf.split(m_half), ddf.const(f))))


def eager_chunk_dd(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                   fst, s0: int, s1: int, *, G: float, eps: float, dt: float,
                   integrator: str, force=None) -> None:
    """Steps s0+1..s1 of simulate's double-double loop on c (q, v, a (n, 3,
    2)), in place: step s runs under m_eff = m0 + m_half * fst[s] (m0,
    m_half (n, 2), fst host binary64 floats) and the force of
    ops/integrate.accel_dd_state, or `force(q, gm)`."""
    kw = {"G": G, "eps": eps, "dt": dt, "force": force}
    q, v, a = c.q, c.v, c.a
    for s in range(s0 + 1, s1 + 1):
        m_eff = m_eff_dd(m0, m_half, fst[s])
        if integrator == "leapfrog":
            q, v, a = kdk_leapfrog_step_dd(q, v, a, m_eff, **kw)
        else:
            q, v = symplectic_euler_step_dd(q, v, m_eff, **kw)
    c.q, c.v, c.a = q, v, a


@dataclasses.dataclass(frozen=True)
class _Kind:
    """A step kernel's representation: the dtype of its tensors and the
    trailing axes of a value (a double-double one is (2,))."""
    name: str
    dtype: torch.dtype
    tail: tuple = ()


_F64 = _Kind("sim_chunk_f64", torch.float64)
_F32 = _Kind("sim_chunk_f32", torch.float32)
_DD = _Kind("sim_chunk_dd", torch.float64, (2,))


def _check(kind: _Kind, c: SimCarry, m0, m_half, fst, s0: int, s1: int,
           integrator: str, compensated: bool) -> None:
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator: {integrator}")
    want = {"q": True, "v": True, "a": integrator == "leapfrog",
            "qc": compensated, "vc": compensated}
    state = {k: getattr(c, k) for k in want}
    for k, needed in want.items():
        if (state[k] is not None) != needed:
            raise ValueError(f"a {integrator} carry "
                             f"{'with' if compensated else 'without'} "
                             f"compensation {'needs' if needed else 'has no'}"
                             f" {k}")
    tensors = [x for x in state.values() if x is not None]
    if any(x.dtype != kind.dtype for x in tensors + [m0, m_half]):
        raise TypeError(f"{kind.name} takes {kind.dtype} tensors, got "
                        f"{[x.dtype for x in tensors + [m0, m_half]]}")
    if fst.dtype != (torch.float32 if kind is _F32 else torch.float64):
        raise TypeError(f"{kind.name} takes a table fst of the state's "
                        f"(binary64 for double-double), got {fst.dtype}")
    tensors.append(fst)
    n = c.q.shape[0]
    if (any(x.shape != (n, 3) + kind.tail for x in state.values()
            if x is not None)
            or n < 1 or m0.shape != (n,) + kind.tail
            or m_half.shape != (n,) + kind.tail or fst.dim() != 1):
        raise ValueError(f"{kind.name} takes a state of {(n, 3) + kind.tail}"
                         f", n >= 1, masses {(n,) + kind.tail} and a table "
                         f"fst, got q {tuple(c.q.shape)}, m0 "
                         f"{tuple(m0.shape)}, m_half {tuple(m_half.shape)}, "
                         f"fst {tuple(fst.shape)}")
    if not 0 <= s0 < s1 < fst.shape[0]:
        raise ValueError(f"steps {s0}+1..{s1} need 0 <= s0 < s1 < "
                         f"len(fst) = {fst.shape[0]}")
    if any(x.device != c.q.device for x in tensors + [m0, m_half]):
        raise ValueError(f"{kind.name} takes tensors on one device, got "
                         f"{[str(x.device) for x in tensors + [m0, m_half]]}")
    if not all(x.is_contiguous() for x in tensors + [m0, m_half]):
        raise ValueError(f"{kind.name} takes contiguous tensors")


def _check_dist3(dist3_mode: str) -> None:
    if dist3_mode not in DIST3_CODES:
        raise ValueError(f"dist3_mode must be one of {sorted(DIST3_CODES)}, "
                         f"got {dist3_mode!r}")


def _on_cpu(c: SimCarry, name: str) -> bool:
    """Whether the carry goes to the plain version; a carry on neither the
    CPU nor CUDA is refused."""
    if c.q.device.type == "cpu":
        return True
    if c.q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {c.q.device}")
    return False


def _lib():
    """The kernel library, checked against this module's slots."""
    from . import _build

    lib = _build.load()
    if lib.sim_step_slots() != SLOTS:
        raise RuntimeError(f"the step kernels' state buffer has "
                           f"{lib.sim_step_slots()} slots, not {SLOTS}")
    return lib


def _state(c: SimCarry) -> tuple:
    """The carry's tensors in their slots' order (None where absent)."""
    return (c.q, c.v, c.a, c.qc, c.vc)


def _pair(c: SimCarry, rows: int, graphs) -> torch.Tensor:
    """The ping-pong pair of state buffers (2, SLOTS, rows, ...) of a chunk
    with the carry's state in the first buffer's slots: without graphs a
    fresh one; with graphs the carry's own (`c.slots`, made at its first
    chunk there, zero so that the mesh's rows past n stay zero), into
    which only a tensor that is not already its slot is copied."""
    shape = (2, SLOTS, rows) + tuple(c.q.shape[1:])
    n = c.q.shape[0]
    if graphs is None:
        st = c.q.new_zeros(shape) if rows > n else c.q.new_empty(shape)
    else:
        st = c.slots
        if st is None or st.shape != shape or st.dtype != c.q.dtype \
                or st.device != c.q.device:
            st = c.slots = c.q.new_zeros(shape)
    for slot, x in enumerate(_state(c)):
        if x is not None and (graphs is None
                              or x.data_ptr() != st[0, slot].data_ptr()):
            st[0, slot, :n] = x
    return st


def _run(c: SimCarry, s0: int, graphs, rows: int, key: tuple, body):
    """One chunk of a step kernel on a CUDA carry: body(st, word)() runs
    the chunk's launches on the pair st (`_pair`), reading the base step
    from the device word, and leaves the result in st[0]. Without graphs
    it runs once, the base step in a fresh word; with graphs, one replay
    of the graph of `key` and the pair, captured at the first chunk of
    that key. The carry is then read from st[0]. Returns the body that
    ran, or that the replayed graph captured."""
    st = _pair(c, rows, graphs)
    if graphs is None:
        run = body(st, torch.full((1,), s0, dtype=torch.int32,
                                  device=c.q.device))
        run()
    else:
        run = graphs.run(key + (c.q.device, st.data_ptr()),
                         lambda word: body(st, word), c.q.device, s0)
    _read(c, st[0, :, :c.q.shape[0]])
    return run


def _check_rc(wrapper, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {rc}")


def _launch(wrapper, c: SimCarry, s0: int, s1: int, graphs, name: str,
            args: tuple) -> None:
    """A step kernel's chunk on a CUDA carry through the library's C call
    `name`(st0, st1, *args, word, K, launched, stream) (the kernel's
    sim_chunk_*_launch, which returns its CUDA error and writes the
    kernels it launched into the host int at `launched`: one persistent
    launch, or the pre-launch and one a step), and those launches added
    to `wrapper.launches`."""
    lib = _lib()
    with torch.cuda.device(c.q.device):
        _chunk(wrapper, c, s0, s1, graphs, name, args, lib)


def _chunk(wrapper, c: SimCarry, s0: int, s1: int, graphs, name: str,
           args: tuple, lib) -> None:
    """`_launch`'s chunk with the kernel library `lib` (a stand-in in the
    CPU tests): one C call and, for an odd K, the copy of the carry's
    slots back from the second buffer; a replay counts the launches its
    graph captured. The key of its graph is the call's arguments but the
    buffers', which `_run` adds: everything that decides the captured
    work."""
    K = s1 - s0
    launch = getattr(lib, name)
    top = 1 + max(i for i, x in enumerate(_state(c)) if x is not None)

    def body(st, word):
        ptrs = (st[0].data_ptr(), st[1].data_ptr())
        launched = ctypes.c_int(0)

        def run() -> None:
            _check_rc(wrapper, launch(*ptrs, *args, word.data_ptr(), K,
                                      ctypes.addressof(launched),
                                      _stream(st)))
            if K % 2:
                st[0, :top].copy_(st[1, :top])
        run.launched = launched
        return run

    run = _run(c, s0, graphs, c.q.shape[0], ("chunk", name, args, K), body)
    wrapper.launches += run.launched.value


def _read(c: SimCarry, out: torch.Tensor) -> None:
    """The carry from the slots of a state buffer."""
    c.q, c.v = out[0], out[1]
    if c.a is not None:
        c.a = out[2]
    if c.qc is not None:
        c.qc, c.vc = out[3], out[4]


def sim_chunk_f64_ref(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                      fst: torch.Tensor, s0: int, s1: int, *, G: float,
                      eps: float, dt: float, integrator: str,
                      compensated: bool, dist3_mode: str = "dsqrt") -> None:
    """Plain PyTorch version of the binary64 step kernel: the eager loop
    (`eager_chunk`) with kernel B1's plain twin as its force, on c in
    place, on any device."""
    _check(_F64, c, m0, m_half, fst, s0, s1, integrator, compensated)
    _check_dist3(dist3_mode)

    def force(q, gm):
        return accel_f64_ref(q[None], q[None], gm[None], eps=eps,
                             dist3_mode=dist3_mode)[0]

    eager_chunk(c, m0, m_half, fst.tolist(), s0, s1, G=G, eps=eps, dt=dt,
                integrator=integrator, compensated=compensated,
                dist3_mode=dist3_mode, force=force)


def _check_grid_cap(grid_cap: int) -> None:
    if not isinstance(grid_cap, int) or grid_cap < 0:
        raise ValueError(f"grid_cap is a block count >= 0 (0: no cap), got "
                         f"{grid_cap!r}")


def sim_chunk_f64(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                  fst: torch.Tensor, s0: int, s1: int, *, G: float,
                  eps: float, dt: float, integrator: str, compensated: bool,
                  dist3_mode: str = "dsqrt",
                  graphs: Optional[ChunkGraphs] = None,
                  grid_cap: int = 0) -> None:
    """Steps s0+1..s1 of simulate's binary64 loop on the carry c (q, v (n,
    3) float64; a for the leapfrog, qc and vc with compensation), in place,
    under m_eff = m0 + m_half * fst[s] (fst the oscillation table (steps +
    1,) as a float64 tensor).

    A CUDA carry runs the step kernel: one C call, and one persistent
    launch for the chunk's s1 - s0 steps (on at most `grid_cap` blocks if
    it is not 0) or, at a larger n, a pre-launch and one launch a step,
    added to `sim_chunk_f64.launches`; with `graphs`, as one replay of the
    graph of the chunk's shape (module docstring). A CPU carry runs
    `sim_chunk_f64_ref`."""
    _check(_F64, c, m0, m_half, fst, s0, s1, integrator, compensated)
    _check_dist3(dist3_mode)
    _check_grid_cap(grid_cap)
    if _on_cpu(c, "sim_chunk_f64"):
        sim_chunk_f64_ref(c, m0, m_half, fst, s0, s1, G=G, eps=eps, dt=dt,
                          integrator=integrator, compensated=compensated,
                          dist3_mode=dist3_mode)
        return
    _launch(sim_chunk_f64, c, s0, s1, graphs, "sim_chunk_f64_launch",
            (m0.data_ptr(), m_half.data_ptr(), fst.data_ptr(), c.q.shape[0],
             INTEGRATORS.index(integrator), int(compensated),
             DIST3_CODES[dist3_mode], G, dt, 0.5 * dt, eps * eps, grid_cap))


sim_chunk_f64.launches = 0


def sim_chunk_f32_ref(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                      fst: torch.Tensor, s0: int, s1: int, *, G: float,
                      eps: float, dt: float, integrator: str,
                      compensated: bool) -> None:
    """Plain PyTorch version of the float32 step kernel: the eager loop
    (`eager_chunk`) with kernel B2's plain twin as its force, on c in
    place, on any device."""
    _check(_F32, c, m0, m_half, fst, s0, s1, integrator, compensated)

    def force(q, gm):
        return accel_f32_ref(q, q, gm, eps=eps)

    eager_chunk(c, m0, m_half, fst.tolist(), s0, s1, G=G, eps=eps, dt=dt,
                integrator=integrator, compensated=compensated, force=force)


def sim_chunk_f32(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                  fst: torch.Tensor, s0: int, s1: int, *, G: float,
                  eps: float, dt: float, integrator: str,
                  compensated: bool,
                  graphs: Optional[ChunkGraphs] = None,
                  grid_cap: int = 0) -> None:
    """Steps s0+1..s1 of simulate's float32 loop on the carry c (q, v (n,
    3) float32; a for the leapfrog, qc and vc with compensation), in place,
    under m_eff = m0 + m_half * fst[s] (fst the oscillation table (steps +
    1,) as a float32 tensor); G, dt, dt / 2 and eps^2 rounded to float32
    as the eager loop rounds them.

    A CUDA carry runs the step kernel: one C call, and one persistent
    launch for the chunk's s1 - s0 steps (on at most `grid_cap` blocks if
    it is not 0) or, at a larger n, a pre-launch and one launch a step,
    added to `sim_chunk_f32.launches`; with `graphs`, as one replay of the
    graph of the chunk's shape. A CPU carry runs `sim_chunk_f32_ref`."""
    _check(_F32, c, m0, m_half, fst, s0, s1, integrator, compensated)
    _check_grid_cap(grid_cap)
    if _on_cpu(c, "sim_chunk_f32"):
        sim_chunk_f32_ref(c, m0, m_half, fst, s0, s1, G=G, eps=eps, dt=dt,
                          integrator=integrator, compensated=compensated)
        return
    f32 = torch.float32
    _launch(sim_chunk_f32, c, s0, s1, graphs, "sim_chunk_f32_launch",
            (m0.data_ptr(), m_half.data_ptr(), fst.data_ptr(), c.q.shape[0],
             INTEGRATORS.index(integrator), int(compensated),
             scalar(G, f32), scalar(dt, f32), scalar(0.5 * dt, f32),
             eps2_f32(eps), grid_cap))


sim_chunk_f32.launches = 0


def sim_chunk_dd_ref(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                     fst: torch.Tensor, s0: int, s1: int, *, G: float,
                     eps: float, dt: float, integrator: str) -> None:
    """Plain PyTorch version of the double-double step kernel: the eager
    loop (`eager_chunk_dd`) with kernel B4's plain twin as its force, on c
    in place, on any device."""
    _check(_DD, c, m0, m_half, fst, s0, s1, integrator, False)

    def force(q, gm):
        return accel_dd_ref(q[None], q[None], gm[None], eps=eps)[0]

    eager_chunk_dd(c, m0, m_half, fst.tolist(), s0, s1, G=G, eps=eps, dt=dt,
                   integrator=integrator, force=force)


def sim_chunk_dd(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                 fst: torch.Tensor, s0: int, s1: int, *, G: float,
                 eps: float, dt: float, integrator: str,
                 graphs: Optional[ChunkGraphs] = None) -> None:
    """Steps s0+1..s1 of simulate's double-double loop on the carry c (q,
    v (n, 3, 2) float64 pairs (hi, lo); a for the leapfrog; no
    compensation), in place, under m_eff = m0 + m_half * fst[s] (m0,
    m_half (n, 2), fst the oscillation table (steps + 1,) as a float64
    tensor); G and dt binary64 values.

    A CUDA carry runs the step kernel: one C call, s1 - s0 step launches
    and one launch that forms the chunk's first inputs, all added to
    `sim_chunk_dd.launches`; with `graphs`, as one replay of the graph of
    the chunk's shape. A CPU carry runs `sim_chunk_dd_ref`."""
    _check(_DD, c, m0, m_half, fst, s0, s1, integrator, False)
    if _on_cpu(c, "sim_chunk_dd"):
        sim_chunk_dd_ref(c, m0, m_half, fst, s0, s1, G=G, eps=eps, dt=dt,
                         integrator=integrator)
        return
    _launch(sim_chunk_dd, c, s0, s1, graphs, "sim_chunk_dd_launch",
            (m0.data_ptr(), m_half.data_ptr(), fst.data_ptr(), c.q.shape[0],
             INTEGRATORS.index(integrator), G, dt, 0.5 * dt,
             *eps2_dd(eps)))


sim_chunk_dd.launches = 0


def _check_rows(name: str, blocks: Blocks, gather, n: int) -> None:
    mine = blocks.mine
    if blocks.n != n or blocks.k < 1 or not mine \
            or len(set(mine)) != len(mine) \
            or not all(0 <= r < blocks.k for r in mine) \
            or len(mine) != (blocks.k if gather is None else 1):
        raise ValueError(f"{name} takes blocks of the carry's {n} bodies, "
                         f"its rank's block and a gather, or all k blocks "
                         f"without one, got {blocks} and gather {gather!r}")


def rows_force(cross, blocks: Blocks, gather):
    """The plain row-range force(q, gm) of a whole state q (n, 3[, 2]):
    cross(q_rows, q, gm) on the rows of each block of `blocks.mine`, then
    `gather` of the blocks' forces (k, ni, 3[, 2]) in place."""
    n, k, ni = blocks.n, blocks.k, blocks.ni

    def force(q: torch.Tensor, gm: torch.Tensor) -> torch.Tensor:
        out = q.new_zeros((k, ni) + tuple(q.shape[1:]))
        for r in blocks.mine:
            r0, r1 = blocks.rows(r)
            if r1 > r0:
                out[r, :r1 - r0] = cross(q[r0:r1].contiguous(), q, gm)
        if gather is not None:
            gather(out)
            profiling.gathered(1, out.numel() * out.element_size())
        return out.flatten(0, 1)[:n]

    return force


def _launch_rows(wrapper, c: SimCarry, s0: int, s1: int, blocks: Blocks,
                 gather, graphs, name: str, head: tuple,
                 tail: tuple) -> None:
    """A row-range chunk on a CUDA carry through the library's C call
    `name`(in, out, *head, r0, *tail, word, off, next, stream) (the
    kernel's sim_rows_*_step, which returns its CUDA error), and its
    launches added to `wrapper.launches`."""
    lib = _lib()
    with torch.cuda.device(c.q.device):
        _rows_chunk(wrapper, c, s0, s1, blocks, gather, graphs, name, head,
                    tail, lib)


def _rows_chunk(wrapper, c: SimCarry, s0: int, s1: int, blocks: Blocks,
                gather, graphs, name: str, head: tuple, tail: tuple,
                lib) -> None:
    """`_launch_rows`'s chunk with the kernel library `lib` (a stand-in in
    the CPU tests), on a pair of buffers of k * ni rows a slot whose first
    holds the whole state: the pre-launch, then each step one launch a
    block of `blocks.mine` and, but after the last, `gather` of the slot
    the next force reads; then one `gather` of the carry's slots through a
    buffer of the body's own into the first buffer (without a gather, an
    odd K's copy back from the second). With graphs the graph holds all
    of it, the in-place NCCL all_gathers too. The chunk's K gathers and
    their bytes are counted in the open request (a replay's as its graph
    captured them)."""
    K = s1 - s0
    k, ni, mine = blocks.k, blocks.ni, blocks.mine
    step = getattr(lib, name)
    kept = [slot for slot, x in enumerate(_state(c)) if x is not None]
    # the slot the next step's force reads (tail opens with the integrator)
    pos_slot = _SLOT_P if INTEGRATORS[tail[0]] == "leapfrog" else 0

    def body(st, word):
        ptrs = [x.data_ptr() for x in st]
        pos = [x[pos_slot].unflatten(0, (k, ni)) for x in st]
        # the carry's slots in blocks (k, slots, ni, ...), gathered
        carry = None if gather is None else \
            st.new_empty((k, len(kept), ni) + tuple(st.shape[3:]))

        def call(i, o, r0, off, nxt):
            _check_rc(wrapper, step(i, o, *head, r0, *tail, word.data_ptr(),
                                    off, nxt, _stream(st)))

        def run() -> None:
            call(ptrs[0], None, mine[0] * ni, 1, 0)
            for off in range(1, K + 1):
                i = (off - 1) & 1
                for r in mine:
                    call(ptrs[i], ptrs[i ^ 1], r * ni, off, int(off < K))
                if gather is not None and off < K:
                    gather(pos[i ^ 1])
            last = st[K & 1]
            if gather is None:
                if K & 1:
                    st[0, :kept[-1] + 1].copy_(last[:kept[-1] + 1])
                return
            for j, slot in enumerate(kept):
                carry[:, j].copy_(last[slot].unflatten(0, (k, ni)))
            gather(carry)
            for j, slot in enumerate(kept):
                st[0, slot].unflatten(0, (k, ni)).copy_(carry[:, j])
        run.gathers = run.gather_bytes = 0
        if gather is not None:
            run.gathers = K
            run.gather_bytes = (K - 1) * pos[0].numel() * st.element_size() \
                + carry.numel() * carry.element_size()
        return run

    run = _run(c, s0, graphs, k * ni,
               ("rows", name, head, tail, K, blocks, gather), body)
    wrapper.launches += 1 + K * len(mine)
    profiling.gathered(run.gathers, run.gather_bytes)


def _rows_head(m0, m_half, fst, blocks: Blocks) -> tuple:
    """The arguments of a rows launch from m0 to k (sim_rows_*_step)."""
    return (m0.data_ptr(), m_half.data_ptr(), fst.data_ptr(), blocks.n,
            blocks.ni, blocks.k)


# the leapfrog's drifted positions, the slot its force reads
# (csrc/sim_step.cuh SLOT_P)
_SLOT_P = 5


def _rows_common(kind: _Kind, c: SimCarry, m0, m_half, fst, s0: int,
                 s1: int, blocks: Blocks, gather, integrator: str,
                 compensated: bool) -> bool:
    """The rows chunks' checks; whether the carry goes to the plain
    version."""
    _check(kind, c, m0, m_half, fst, s0, s1, integrator, compensated)
    _check_rows(kind.name.replace("chunk", "rows_chunk"), blocks, gather,
                c.q.shape[0])
    return _on_cpu(c, kind.name.replace("chunk", "rows_chunk"))


def sim_rows_chunk_f64_ref(c: SimCarry, m0: torch.Tensor,
                           m_half: torch.Tensor, fst: torch.Tensor, s0: int,
                           s1: int, *, blocks: Blocks, gather=None,
                           G: float, eps: float, dt: float, integrator: str,
                           compensated: bool,
                           dist3_mode: str = "dsqrt") -> None:
    """Plain PyTorch version of the binary64 row-range step: the eager
    loop (`eager_chunk`) on the whole carry, whose force is kernel B1's
    plain cross form on the rows of `blocks.mine` and `gather` of those
    rows' forces, on c in place, on any device."""
    _check(_F64, c, m0, m_half, fst, s0, s1, integrator, compensated)
    _check_dist3(dist3_mode)
    _check_rows("sim_rows_chunk_f64", blocks, gather, c.q.shape[0])

    def cross(qi, q, gm):
        return accel_f64_ref(qi[None], q[None], gm[None], eps=eps,
                             dist3_mode=dist3_mode)[0]

    eager_chunk(c, m0, m_half, fst.tolist(), s0, s1, G=G, eps=eps, dt=dt,
                integrator=integrator, compensated=compensated,
                dist3_mode=dist3_mode,
                force=rows_force(cross, blocks, gather))


def sim_rows_chunk_f64(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                       fst: torch.Tensor, s0: int, s1: int, *,
                       blocks: Blocks, gather=None, G: float, eps: float,
                       dt: float, integrator: str, compensated: bool,
                       dist3_mode: str = "dsqrt",
                       graphs: Optional[ChunkGraphs] = None) -> None:
    """Steps s0+1..s1 of simulate's binary64 loop on a mesh rank's whole
    carry c, in place (arguments as `sim_chunk_f64`): the rows of the
    blocks `blocks.mine` (the rank's one, with `gather` an in-place
    all_gather over the ranks' blocks (k, ...); or all k blocks in one
    process, without a gather).

    A CUDA carry runs the binary64 step kernel's row-range form: a
    pre-launch, one launch a step and block, a gather a step but the last,
    and one gather of the carry; all launches added to
    `sim_rows_chunk_f64.launches`; with `graphs`, all of it as one replay
    of the graph of the chunk's shape. A CPU carry runs
    `sim_rows_chunk_f64_ref`. Bitwise `sim_chunk_f64` on every split.
    Every rank must pass graphs for the same chunks: a rank that captured
    and one that did not would call the collectives apart."""
    _check_dist3(dist3_mode)
    if _rows_common(_F64, c, m0, m_half, fst, s0, s1, blocks, gather,
                    integrator, compensated):
        sim_rows_chunk_f64_ref(c, m0, m_half, fst, s0, s1, blocks=blocks,
                               gather=gather, G=G, eps=eps, dt=dt,
                               integrator=integrator,
                               compensated=compensated,
                               dist3_mode=dist3_mode)
        return
    tail = (INTEGRATORS.index(integrator), int(compensated),
            DIST3_CODES[dist3_mode], G, dt, 0.5 * dt, eps * eps)
    _launch_rows(sim_rows_chunk_f64, c, s0, s1, blocks, gather, graphs,
                 "sim_rows_f64_step", _rows_head(m0, m_half, fst, blocks),
                 tail)


sim_rows_chunk_f64.launches = 0


def _check_tile(tile: int) -> None:
    if not isinstance(tile, int) or tile < 1:
        raise ValueError(f"the float32 mesh's tile is a positive source "
                         f"count, got {tile!r}")


def sim_rows_chunk_f32_ref(c: SimCarry, m0: torch.Tensor,
                           m_half: torch.Tensor, fst: torch.Tensor, s0: int,
                           s1: int, *, blocks: Blocks, gather=None,
                           G: float, eps: float, dt: float, integrator: str,
                           compensated: bool, tile: int = TILE_J) -> None:
    """Plain PyTorch version of the float32 row-range step: the eager loop
    (`eager_chunk`) on the whole carry, whose force is the ordered sum at
    `tile` of kernel B2's plain cross form (accel_f32_ordered) on the rows
    of `blocks.mine` and `gather` of those rows' forces, on c in place,
    on any device."""
    _check(_F32, c, m0, m_half, fst, s0, s1, integrator, compensated)
    _check_tile(tile)
    _check_rows("sim_rows_chunk_f32", blocks, gather, c.q.shape[0])

    def cross(qi, q, gm):
        return accel_f32_ordered(qi, q, gm, eps=eps, tile=tile,
                                 force=accel_f32_ref)

    eager_chunk(c, m0, m_half, fst.tolist(), s0, s1, G=G, eps=eps, dt=dt,
                integrator=integrator, compensated=compensated,
                force=rows_force(cross, blocks, gather))


def sim_rows_chunk_f32(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                       fst: torch.Tensor, s0: int, s1: int, *,
                       blocks: Blocks, gather=None, G: float, eps: float,
                       dt: float, integrator: str, compensated: bool,
                       tile: int = TILE_J,
                       graphs: Optional[ChunkGraphs] = None) -> None:
    """Steps s0+1..s1 of simulate's float32 loop on a mesh rank's whole
    carry c, in place, the force the mesh's ordered sum at `tile` (bitwise
    `sim_chunk_f32` at tile 128); blocks, gather and graphs as
    `sim_rows_chunk_f64` has them, the rest as `sim_chunk_f32`. A CUDA
    carry runs the float32 step kernel's row-range form (its launches
    added to `sim_rows_chunk_f32.launches`), a CPU carry
    `sim_rows_chunk_f32_ref`."""
    _check_tile(tile)
    if _rows_common(_F32, c, m0, m_half, fst, s0, s1, blocks, gather,
                    integrator, compensated):
        sim_rows_chunk_f32_ref(c, m0, m_half, fst, s0, s1, blocks=blocks,
                               gather=gather, G=G, eps=eps, dt=dt,
                               integrator=integrator,
                               compensated=compensated, tile=tile)
        return
    f32 = torch.float32
    tail = (INTEGRATORS.index(integrator), int(compensated), tile,
            scalar(G, f32), scalar(dt, f32), scalar(0.5 * dt, f32),
            eps2_f32(eps))
    _launch_rows(sim_rows_chunk_f32, c, s0, s1, blocks, gather, graphs,
                 "sim_rows_f32_step", _rows_head(m0, m_half, fst, blocks),
                 tail)


sim_rows_chunk_f32.launches = 0


def sim_rows_chunk_dd_ref(c: SimCarry, m0: torch.Tensor,
                          m_half: torch.Tensor, fst: torch.Tensor, s0: int,
                          s1: int, *, blocks: Blocks, gather=None, G: float,
                          eps: float, dt: float, integrator: str) -> None:
    """Plain PyTorch version of the double-double row-range step: the eager
    loop (`eager_chunk_dd`) on the whole carry, whose force is kernel B4's
    plain cross form on the rows of `blocks.mine` and `gather` of those
    rows' forces, on c in place, on any device."""
    _check(_DD, c, m0, m_half, fst, s0, s1, integrator, False)
    _check_rows("sim_rows_chunk_dd", blocks, gather, c.q.shape[0])

    def cross(qi, q, gm):
        return accel_dd_ref(qi[None], q[None], gm[None], eps=eps)[0]

    eager_chunk_dd(c, m0, m_half, fst.tolist(), s0, s1, G=G, eps=eps, dt=dt,
                   integrator=integrator,
                   force=rows_force(cross, blocks, gather))


def sim_rows_chunk_dd(c: SimCarry, m0: torch.Tensor, m_half: torch.Tensor,
                      fst: torch.Tensor, s0: int, s1: int, *,
                      blocks: Blocks, gather=None, G: float, eps: float,
                      dt: float, integrator: str,
                      graphs: Optional[ChunkGraphs] = None) -> None:
    """Steps s0+1..s1 of simulate's double-double loop on a mesh rank's
    whole carry c, in place; blocks, gather and graphs as
    `sim_rows_chunk_f64` has them, the rest as `sim_chunk_dd`. A CUDA
    carry runs the double-double step kernel's row-range form (its
    launches added to `sim_rows_chunk_dd.launches`), a CPU carry
    `sim_rows_chunk_dd_ref`."""
    if _rows_common(_DD, c, m0, m_half, fst, s0, s1, blocks, gather,
                    integrator, False):
        sim_rows_chunk_dd_ref(c, m0, m_half, fst, s0, s1, blocks=blocks,
                              gather=gather, G=G, eps=eps, dt=dt,
                              integrator=integrator)
        return
    tail = (INTEGRATORS.index(integrator), G, dt, 0.5 * dt, *eps2_dd(eps))
    _launch_rows(sim_rows_chunk_dd, c, s0, s1, blocks, gather, graphs,
                 "sim_rows_dd_step", _rows_head(m0, m_half, fst, blocks),
                 tail)


sim_rows_chunk_dd.launches = 0
