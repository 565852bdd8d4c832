"""General simulation API: march a scene for N steps.

The graded solve only answers the three scenario questions; a user of the
engine also wants the capability underneath ("integrate this system"),
with device oscillation on or off, checkpointing and a choice of
precision:

    final = simulate(scene, n_steps=..., precision="f32",
                     integrator="leapfrog", device="cuda", on_chunk=callback)

The port of `nbody_tpu.simulate.simulate`, on one device or over a mesh of
ranks (`mesh`). On one device a chunk goes to the step kernel's wrapper
of its precision (ops/sim_step: `sim_chunk_f32`, `sim_chunk_f64`,
`sim_chunk_dd`): on a card one persistent launch a chunk (binary64 up to
512 bodies, float32 up to 8192) or one launch a step, as the JAX package
compiles a chunk into one scan; on the CPU its plain version. On the mesh every
rank holds the whole state and a chunk goes to the row-range form of the
same step kernel (ops/sim_step: `sim_rows_chunk_f32`,
`sim_rows_chunk_f64`, `sim_rows_chunk_dd`): a step is one launch on the
rank's rows and one in-place all_gather over 'body' of the positions the
next step reads, with the same bits as the step kernels on one device
(in 'f32' at tile 128). A chunk whose length repeats in the run is one
replay of a CUDA graph, captured at its first chunk (on the mesh with its
all_gathers); one that runs once is the direct C call, whose host work
costs about what a capture does (`_plan`). `chunk` sets how often the
host reads the state back for `on_chunk` and never changes the
arithmetic, so results are bitwise invariant to it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SimConfig
from .device import resolve_device
from .io import Scene
from .ops import ddfloat as ddf
from .ops.forces import check_dist3
from .ops.integrate import accel, accel_dd_state
from .ops.accel_dd import accel_dd
from .ops.accel_f32 import accel_f32_ordered
from .ops.accel_f64 import accel_f64
from .ops.chunking import ChunkGraphs
from .ops.sim_step import SimCarry, m_eff_dd, rows_force, sim_chunk_dd, \
    sim_chunk_f32, sim_chunk_f64, sim_rows_chunk_dd, sim_rows_chunk_f32, \
    sim_rows_chunk_f64
from .physics import oscillation_table
from .utils import profiling
from .utils.rescale import IDENTITY, compute_rescale

# beyond binary64: double-double through kernel B4 (simulate() has no
# graded decision quantities, so 'ddp' and 'dd+' run it too, as in the JAX
# package)
_DOUBLE_DOUBLE = ("tf3", "ddp", "dd+")
# native binary64 through kernel B1
_BINARY64 = ("f64", "e64", "dd")
# the representations that carry their own low-order bits
_EXTENDED = _DOUBLE_DOUBLE + ("dd", "e64")


@dataclasses.dataclass
class SimState:
    step: int
    q: np.ndarray
    v: np.ndarray
    # the double-double paths ('tf3', 'ddp', 'dd+'): what q and v, rounded
    # to binary64, leave out, so q + q_lo is the state exactly (None on the
    # other paths)
    q_lo: Optional[np.ndarray] = None
    v_lo: Optional[np.ndarray] = None


@profiling.entry("simulate")
def simulate(scene: Scene, cfg: SimConfig = DEFAULT_CONFIG, *,
             n_steps: Optional[int] = None, precision: str = "f64",
             device: str = "cuda", devices_on: bool = True,
             chunk: int = 10000, integrator: str = "euler",
             mesh=None, tile: Optional[int] = None,
             compensated: Optional[bool] = None,
             on_chunk: Optional[Callable[[SimState], None]] = None
             ) -> SimState:
    """March the scene and return the final state (original units, host
    float64 arrays).

    precision:
      'f32'        — float32 state on the scene rescaled by powers of two
                     (utils/rescale: graded scenes overflow float32), force
                     kernel B2 (ops/accel_f32; on one card inside the
                     float32 step kernel, ops/sim_step).
      'f64', 'e64' — native IEEE binary64, force kernel B1 with the serial
                     fold (ops/accel_f64; on one card inside the binary64
                     step kernel, ops/sim_step), d2^1.5 in cfg.dist3_mode's
                     form
                     ('dsqrt' or 'sqrt3'; 'pow' is refused: libm's pow is
                     reproduced by neither CUDA nor torch). On the TPU
                     'e64' is a softfloat emulation of the same semantics
                     and 'f64' runs only on the CPU; the card has binary64
                     in hardware, so both are this one path.
      'dd'         — the same binary64 path. The JAX package runs its
                     double-double 'dd' (float32's range) on the scene
                     rescaled by powers of two; in binary64 that rescale is
                     exact and changes no bit, so the port leaves it out.
      'tf3', 'ddp', 'dd+' — beyond binary64: double-double state and
                     update (ops/ddfloat, about 2^-104 an operation) around
                     force kernel B4 (ops/accel_dd; on one card inside the
                     double-double step kernel), on the raw scene. The
                     JAX package runs triple-float32 there (about 2^-70),
                     for want of binary64 on a TPU.
    integrator: 'euler' (the graded spec's semi-implicit Euler) or
    'leapfrog' (KDK velocity Verlet, 2nd order, the same one force
    evaluation per step). The leapfrog's force at the initial positions,
    its seed, is one launch of the force kernel outside the chunks (on
    one card kernel B1's self form in binary64, B2's in 'f32', B4's in
    double-double; on the mesh the cross form on the rank's rows and an
    all_gather), and a span of its own (utils/profiling `seed`).
    device: 'cuda' (raises without a card) or 'cpu' (the plain PyTorch
    versions of the kernels).
    compensated: Kahan-compensated q/v accumulation (~6 elementwise ops a
    step): each fp32 += of a per-step increment ~1e-5 of the state loses
    ~17 bits of it, and the compensation, carried across chunks, recovers
    them. Default (None): on for 'f32'. 'e64' and the extended
    representations carry their own low-order bits; asking for it there
    is an error.
    mesh: a ('scen', 'body') DeviceMesh of ranks (parallel/mesh.make_mesh);
    every rank calls simulate and gets the whole final state, and
    `device` is the mesh's. Every rank holds the whole state and steps
    its rows (an equal split over 'body') through the row-range form of
    its precision's step kernel, then gathers them: in binary64 and
    double-double bitwise the one-device run on every mesh shape; in
    'f32' the force is the mesh's ordered sum at `tile` (one partial per
    group of `tile` sources, added in ascending order, as the JAX
    package's ordered ring sums): bitwise the same on every mesh shape for
    one tile, and at the default 128, kernel B2's tile, bitwise the
    one-device run.
    tile: the float32 mesh's force tile (a positive source count); only
    with a mesh.
    `on_chunk` is called with a host SimState after every chunk of
    `chunk` steps (on the mesh on rank 0 alone; the checkpointing hook:
    pair it with utils.checkpoint.CheckpointPolicy); a double-double state
    is handed over rounded to binary64 (hi + lo), with the remainders in
    q_lo, v_lo.
    The call is a request (utils/profiling.entry) whose chunks, graph
    captures and leapfrog seed are spans; on one card its record counts
    the chunks' bodies x steps by precision and form (`sim_row_steps`).
    """
    if integrator not in ("euler", "leapfrog"):
        raise ValueError(f"unknown integrator: {integrator}")
    if compensated is None:
        compensated = precision == "f32"
    elif compensated and precision in _EXTENDED:
        raise ValueError(
            "compensated accumulation applies to the native-dtype paths "
            "('f32', 'f64'); the extended representations carry their own "
            "low-order bits")
    if mesh is None and tile is not None:
        raise ValueError("tile sets the mesh's float32 force tile; it "
                         "applies only with a mesh")
    if precision not in ("f32",) + _BINARY64 + _DOUBLE_DOUBLE:
        raise ValueError(f"unknown precision for simulate: {precision}")
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    if n_steps is None:
        n_steps = cfg.n_steps
    if mesh is not None:
        from .parallel.mesh import check_mesh, mesh_device
        check_mesh(mesh)
        dev = mesh_device(mesh)
    else:
        dev = resolve_device(device)

    rescale = IDENTITY
    run_scene, run_cfg = scene, cfg
    dist3 = "dsqrt"
    if precision == "f32":
        rescale = compute_rescale(scene, eps=cfg.eps)
        run_scene = rescale.apply_scene(scene)
        run_cfg = rescale.apply_cfg(cfg)
    if precision == "f32":
        dtype, np_dtype = torch.float32, np.float32
    else:
        if precision in _BINARY64:
            dist3 = check_dist3(cfg.dist3_mode, precision)
        dtype, np_dtype = torch.float64, np.float64
    rows = seed = None
    if mesh is not None:
        from .parallel.sharded import TILE, body_blocks
        rows = dict(zip(("blocks", "gather"), body_blocks(mesh, scene.n)))
        tile = tile or TILE
        seed = _seed_force(precision, rows, eps=run_cfg.eps, dist3=dist3,
                           tile=tile)
        on_chunk = _on_rank0(on_chunk)
    if precision in _DOUBLE_DOUBLE:
        return _simulate_dd(run_scene, run_cfg, n_steps=n_steps, device=dev,
                            devices_on=devices_on, chunk=chunk,
                            integrator=integrator, on_chunk=on_chunk,
                            rows=rows, seed=seed)

    # the oscillation table as host scalars of the state's dtype: each step
    # scales the device half-masses by one of them (the step kernels read
    # the same values from a device table)
    table = oscillation_table(run_cfg, n_steps).astype(np_dtype)
    fst = table.tolist()
    mask = run_scene.device_mask()
    m0 = run_scene.m * (1.0 if devices_on else (1.0 - mask))
    m_half = 0.5 * m0 * mask

    def put(x):
        return torch.from_numpy(np.asarray(x, dtype=np_dtype)).to(dev)

    c = SimCarry(put(run_scene.q), put(run_scene.v))
    m0t, m_halft = put(m0), put(m_half)
    G, eps, dt = run_cfg.G, run_cfg.eps, run_cfg.dt
    inv = 1.0 / rescale.length_scale

    def host_state(step):
        return SimState(step=step,
                        q=c.q.cpu().numpy().astype(np.float64) * inv,
                        v=c.v.cpu().numpy().astype(np.float64) * inv)

    if integrator == "leapfrog":
        # seeded at the initial positions with the first step's masses
        with profiling.seed(dev):
            c.a = accel(c.q, m0t + m_halft * fst[min(1, n_steps)], G=G,
                        eps=eps, dist3_mode=dist3, force=seed)
    if compensated:
        c.qc, c.vc = torch.zeros_like(c.q), torch.zeros_like(c.v)
    kw = {"G": G, "eps": eps, "dt": dt, "integrator": integrator,
          "compensated": compensated}
    fst_t = torch.from_numpy(table).to(dev)
    if precision == "f32":
        def advance(s0, s1, graphs):
            if rows is None:
                sim_chunk_f32(c, m0t, m_halft, fst_t, s0, s1, graphs=graphs,
                              **kw)
            else:
                sim_rows_chunk_f32(c, m0t, m_halft, fst_t, s0, s1, **rows,
                                   tile=tile, graphs=graphs, **kw)
    else:
        def advance(s0, s1, graphs):
            if rows is None:
                sim_chunk_f64(c, m0t, m_halft, fst_t, s0, s1,
                              dist3_mode=dist3, graphs=graphs, **kw)
            else:
                sim_rows_chunk_f64(c, m0t, m_halft, fst_t, s0, s1, **rows,
                                   dist3_mode=dist3, graphs=graphs, **kw)

    return _march(c, n_steps, chunk, advance, host_state, on_chunk)


def _plan(n_steps: int, chunk: int) -> list:
    """The run's chunks (s0, s1, repeats): `repeats` where the chunk's
    length occurs more than once. Capturing a chunk into a CUDA graph
    costs about what its direct C call's host work costs, plus the
    graph's instantiation, so only a length that repeats is captured
    (once) and replayed; one that runs once, such as a single chunk or
    the shorter last one, is the direct call. The plan depends on n_steps
    and chunk alone, so every rank of a mesh makes the same captures."""
    spans = [(s0, min(s0 + chunk, n_steps))
             for s0 in range(0, n_steps, chunk)]
    count = collections.Counter(s1 - s0 for s0, s1 in spans)
    return [(s0, s1, count[s1 - s0] > 1) for s0, s1 in spans]


def _march(c, n_steps: int, chunk: int, advance, host_state,
           on_chunk) -> SimState:
    """advance(s0, s1, graphs) over the run's chunks (`_plan`), graphs
    the run's ChunkGraphs (c.graphs) for a chunk whose length repeats and
    None otherwise, each a chunk span of one row; on_chunk after each; the
    final host state."""
    plan = _plan(n_steps, chunk)
    if any(repeats for _, _, repeats in plan):
        c.graphs = ChunkGraphs()
    for s0, s1, repeats in plan:
        with profiling.chunk("sim", 1, s1 - s0, c.q.device):
            advance(s0, s1, c.graphs if repeats else None)
        if on_chunk is not None:
            on_chunk(host_state(s1))
    return host_state(n_steps)


def _seed_force(precision: str, rows: dict, *, eps: float, dist3: str,
                tile: int):
    """The mesh's force for the leapfrog's seed, once a run: the force
    kernel's cross form on this rank's rows (in 'f32' the ordered sum at
    `tile`, one launch a group unless the tile is 128), then one all_gather
    of the rows' forces (ops/sim_step.rows_force)."""
    if precision in _DOUBLE_DOUBLE:
        def cross(qi, q, gm):
            return accel_dd(qi[None], q[None], gm[None], eps=eps)[0]
    elif precision == "f32":
        def cross(qi, q, gm):
            return accel_f32_ordered(qi, q, gm, eps=eps, tile=tile)
    else:
        def cross(qi, q, gm):
            return accel_f64(qi[None], q[None], gm[None], eps=eps,
                             dist3_mode=dist3)[0]
    return rows_force(cross, rows["blocks"], rows["gather"])


def _on_rank0(on_chunk):
    """on_chunk called on rank 0 of the mesh alone."""
    import torch.distributed as dist

    if on_chunk is None or dist.get_rank() == 0:
        return on_chunk
    return lambda state: None


def _simulate_dd(scene: Scene, cfg: SimConfig, *, n_steps: int,
                 device: torch.device, devices_on: bool, chunk: int,
                 integrator: str,
                 on_chunk: Optional[Callable[[SimState], None]],
                 rows: Optional[dict] = None, seed=None) -> SimState:
    """simulate() in double-double: the state, masses and update in
    ops/ddfloat's arithmetic around kernel B4's force, in the
    double-double step kernel (sim_chunk_dd; on the mesh its row-range
    form over `rows`, the leapfrog seeded by `seed`), on the raw scene;
    the host sees hi + lo rounded to binary64."""
    table = oscillation_table(cfg, n_steps)
    mask = scene.device_mask()
    m0 = scene.m * (1.0 if devices_on else (1.0 - mask))

    def put(x):
        return ddf.from_f64(np.asarray(x, dtype=np.float64)).to(device)

    c = SimCarry(put(scene.q), put(scene.v))
    m0t, m_halft = put(m0), put(0.5 * m0 * mask)
    G, eps, dt = cfg.G, cfg.eps, cfg.dt

    def host_state(step):
        qs, vs = (ddf.two_sum(x[..., 0], x[..., 1]) for x in (c.q, c.v))
        return SimState(step=step, q=qs.hi.cpu().numpy(),
                        v=vs.hi.cpu().numpy(), q_lo=qs.lo.cpu().numpy(),
                        v_lo=vs.lo.cpu().numpy())

    if integrator == "leapfrog":
        with profiling.seed(device):
            c.a = accel_dd_state(c.q, m_eff_dd(m0t, m_halft,
                                               float(table[min(1, n_steps)])),
                                 G=G, eps=eps, force=seed)
    kw = {"G": G, "eps": eps, "dt": dt, "integrator": integrator}
    fst_t = torch.from_numpy(table).to(device)

    def advance(s0, s1, graphs):
        if rows is None:
            sim_chunk_dd(c, m0t, m_halft, fst_t, s0, s1, graphs=graphs, **kw)
        else:
            sim_rows_chunk_dd(c, m0t, m_halft, fst_t, s0, s1, **rows,
                              graphs=graphs, **kw)

    return _march(c, n_steps, chunk, advance, host_state, on_chunk)
