"""The mesh's graded step, ops/graded_step `graded_rows_chunk`, on the CPU
and on a card.

A rank of the binary64 or double-double mesh computes the force on its own
rows [r0, r0 + ni) against every body, updates those rows, and gathers the
ranks' rows with one all_gather; every rank then checks the whole state.
The state lies in the blocks the all_gather makes, (k, 2, B, ni, 3): block
r holds q and then v of the rows [r * ni, (r + 1) * ni), ni = ceil(n / k).

On the CPU (the plain version): the row-range chunk run over k = 1 to 4
row blocks one after another in one process (every block computed, nothing
gathered), on the block layout, bitwise equal to the one-device plain chunk
on every carry: P1+P2 with both rows, across the P2 early exit, with the
roles split (P1 alone, P2 alone), and Problem 3 with rows that arrive
mid-chunk; in binary64 (dsqrt and sqrt3) and double-double ('tf3'); at
n=20 (fuzz seed 103: a hit at step 90) and n=33, 300 steps in two chunks,
ragged blocks at k = 3, 4 and (n=33) 2. The layout's round trip is the
identity for a ragged n, and the chunk refuses what it does not take.
The gloo mesh tests (tests/test_torch_solver_sharded.py) hold the whole
solve, ranks and gathers included.

On a card (skipped without one): the same cases through the graded step
kernels, launched once a block and step, bitwise equal to the one-device
kernels at n=1024 and n=20 over k = 1 to 4 blocks; the C launcher refuses
bad (r0, ni, k) and bad roles. On the card's machine:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mesh_step.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.physics import oscillation_table
import torch_mesh_workers as W

STEPS = 300
CHUNKS = [(0, 150), (150, STEPS)]
# (seed, devices) of the fuzz scenes: at n=20 a hit at step 90 and
# arrivals at 4, 38 and 17; at n=33 arrivals at 82, 10 and 93, no hit
SEED, DEVICES = 103, 3
CARD_SCENES = {20: (103, 20, 3), 1024: (1, 1024, 3)}
# the Problem-3 rows' arrival steps: one before, one inside, one after
# the first chunk
P3_ARRIVALS = (5, 120, 200)
PRECISIONS = {"dsqrt": (torch.float64, "dsqrt"),
              "sqrt3": (torch.float64, "sqrt3"),
              "tf3": (ds.DD, "dsqrt"),
              "f32": (torch.float32, "dsqrt")}
# what a case holds against the one-device run of its reference case
CASES = {"p12": ("p12", None), "p12_exit": ("p12_exit", None),
         "p3": ("p3", None),
         "p1": ("p12", ("q", "v", "min_d2")),
         "p2": ("p12", ("q", "v", "arr", "hit", "q_snap", "v_snap"))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _carry(spec: tuple, precision: str, mode: int, device) -> gs.Carry:
    """The step-0 carry of driver `mode` on the fuzz scene spec (seed, n,
    devices) as the graded solve builds it (rescaled in 'f32'); Problem 3
    with one row a device, each from the initial state, arriving at
    P3_ARRIVALS."""
    from nbody_tpu_torch.utils.rescale import compute_rescale

    dtype, dist3 = PRECISIONS[precision]
    scene = W.fuzz_scene(*spec)
    cfg = SimConfig(n_steps=STEPS, dist3_mode=dist3)
    if dtype == torch.float32:
        rs = compute_rescale(scene, eps=cfg.eps, G=cfg.G)
        scene, cfg = rs.apply_scene(scene), rs.apply_cfg(cfg)
    fst = oscillation_table(cfg)
    if mode == gs.P12:
        return ds._p12_carry(scene, fst, cfg, device, dtype)
    D = scene.device_cnt
    qv = [ds._t(np.stack([x] * D), device, dtype) for x in (scene.q, scene.v)]
    p12 = ds.P12Result(min_dist=0.0, hit_time_step=STEPS,
                       arrivals=np.asarray(P3_ARRIVALS[:D]),
                       q_snaps=qv[0], v_snaps=qv[1])
    return ds._p3_carry(scene, p12, fst, cfg, np.arange(D), device, dtype)


def _keep(c: gs.Carry, rows: list, blocks: bool) -> None:
    """Keep scenario rows `rows` of the carry's state and masses."""
    c.m0, c.m_half = c.m0[rows], c.m_half[rows]
    if blocks:
        c.q = c.q[:, :, rows].contiguous()
    else:
        c.q, c.v = c.q[rows], c.v[rows]


def _run(case: str, spec: tuple, precision: str, device,
         k: int | None = None, tile: int = 128, step=None) -> gs.Carry:
    """The carry of `case` after CHUNKS: through the one-device chunk (k
    None; with `step`, the plain chunk around that step) or the row-range
    chunk over k blocks (float32 at `tile`), all computed in turn; in the
    one-device layout either way. p12_exit drops P2's row after the first
    chunk, as the P2 early exit does; p1 and p2 run one row, the other on
    another rank of 'scen'."""
    mode = gs.P3 if case == "p3" else gs.P12
    c = _carry(spec, precision, mode, device)
    roles = {"p1": (0, None), "p2": (None, 0)}.get(case)
    if roles is not None:
        _keep(c, [0 if case == "p1" else 1], False)
    if k is not None:
        c.q, c.v = gs.to_blocks(c.q, c.v, k), None
        blocks = gs.Blocks(spec[1], k, tuple(range(k)))
    for s0, s1 in CHUNKS:
        if case == "p12_exit" and s0:
            _keep(c, [0], k is not None)
        if k is None and step is not None:
            ref = gs._p3_chunk_ref if mode == gs.P3 else functools.partial(
                gs._p12_chunk_ref, roles=roles)
            ref(c, s0, s1, step=step)
        elif k is None:
            gs.graded_chunk(mode, c, s0, s1)
        else:
            gs.graded_rows_chunk(mode, c, s0, s1, blocks, roles=roles,
                                 tile=tile)
    if k is not None:
        c.q, c.v = gs.from_blocks(c.q, spec[1])
    return c


_REFERENCE = {}


def _reference(case: str, spec: tuple, precision: str, device) -> gs.Carry:
    key = (case, spec, precision, device.type)
    if key not in _REFERENCE:
        _REFERENCE[key] = _run(case, spec, precision, device)
    return _REFERENCE[key]


def _differ(case: str, got: gs.Carry, want: gs.Carry) -> list:
    """The carry fields where got and want differ, bit for bit (a split
    role against its row of the both-rows run)."""
    fields = CASES[case][1] or [
        f.name for f in dataclasses.fields(got)
        if isinstance(getattr(want, f.name), torch.Tensor)]
    row = {"p1": 0, "p2": 1}.get(case)
    out = []
    for name in fields:
        a, b = getattr(got, name).cpu(), getattr(want, name).cpu()
        if row is not None and name in ("q", "v"):
            b = b[row:row + 1]
        if not torch.equal(a, b):
            out.append(name)
    return out


def _params():
    """(case, precision, k, n): every case in dsqrt at n=20 and 33 and
    several k; sqrt3 and tf3 on fewer (a tf3 case costs about 4 s here)."""
    out = []
    for n in (20, 33):
        out += [("p12", "dsqrt", k, n) for k in (1, 2, 3, 4)]
        out += [("p12", "sqrt3", k, n) for k in (1, 3)]
        out += [("p12", "tf3", k, n) for k in (2, 3)]
        out += [(case, "dsqrt", k, n) for case in ("p1", "p2")
                for k in (2, 4)]
        out += [("p12_exit", "dsqrt", 3, n), ("p3", "dsqrt", 3, n)]
    out += [("p1", "tf3", 3, 33), ("p2", "tf3", 3, 33),
            ("p12_exit", "tf3", 3, 20)]
    out += [("p3", "dsqrt", k, 20) for k in (1, 2, 4)]
    out += [("p3", "sqrt3", 2, 20), ("p3", "tf3", 3, 20),
            ("p3", "tf3", 4, 33)]
    return out


@pytest.mark.parametrize("case,precision,k,n", _params())
def test_rows_chunk_over_k_blocks_bitwise_one_device(case, precision, k, n):
    spec = (SEED, n, DEVICES)
    cpu = torch.device("cpu")
    got = _run(case, spec, precision, cpu, k)
    want = _reference(CASES[case][0], spec, precision, cpu)
    assert _differ(case, got, want) == []


def test_cases_exercise_the_checks():
    """The n=20 scene hits and its devices arrive within the run; the
    Problem-3 rows flag hits."""
    spec = (SEED, 20, DEVICES)
    c = _reference("p12", spec, "dsqrt", torch.device("cpu"))
    assert int(c.hit) == 90 and sorted(c.arr.tolist()) == [4, 17, 38]
    assert bool(c.q_snap.abs().sum(dim=(1, 2)).gt(0).all())
    p3 = _reference("p3", spec, "dsqrt", torch.device("cpu"))
    assert bool(p3.hit.any())


@pytest.mark.parametrize("tail", [(), (2,)], ids=["f64", "dd"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("n", [20, 33])
def test_layout_round_trip(n, k, tail):
    rng = np.random.RandomState(n * 10 + k)
    q, v = (torch.from_numpy(rng.randn(2, n, 3, *tail)) for _ in range(2))
    qv = gs.to_blocks(q, v, k)
    ni = -(-n // k)
    assert qv.shape == (k, 2, 2, ni, 3, *tail) and qv.is_contiguous()
    for r in range(k):
        r0, r1 = min(r * ni, n), min(r * ni + ni, n)
        assert torch.equal(qv[r, 0, :, :r1 - r0], q[:, r0:r1])
        assert torch.equal(qv[r, 1, :, :r1 - r0], v[:, r0:r1])
        assert not qv[r, :, :, r1 - r0:].any()      # padding
    q2, v2 = gs.from_blocks(qv, n)
    assert torch.equal(q2, q) and torch.equal(v2, v)


def _p12_blocks(k: int = 2):
    c = _carry((SEED, 20, DEVICES), "dsqrt", gs.P12, torch.device("cpu"))
    c.q, c.v = gs.to_blocks(c.q, c.v, k), None
    return c


@pytest.mark.parametrize("change,kw,match", [
    ("p123", {}, "P12 or P3"),
    ("f16", {}, "float64, float32 or double-double"),
    ("v", {}, "v None"),
    ("shape", {}, "blocks"),
    (None, {"roles": (0, 0)}, "roles"),
    (None, {"roles": (0, None)}, "roles"),
    (None, {"roles": (0, 2)}, "roles"),
    (None, {"mine": (0,)}, "gather"),
    (None, {"mine": (0, 1), "gather": print}, "gather"),
    (None, {"mine": (0, 2)}, "block"),
    ("p3", {"roles": (0, 1)}, "no roles"),
])
def test_rows_chunk_refuses(change, kw, match):
    c = _p12_blocks()
    mode = gs.P12
    if change == "p123":
        mode = gs.P123
    elif change == "f16":
        c.q = c.q.half()
    elif change == "v":
        c.v = c.q.clone()
    elif change == "shape":
        c.q = c.q[:, :, :, :-1].contiguous()
    elif change == "p3":
        mode = gs.P3
    blocks = gs.Blocks(20, 2, kw.get("mine", (0, 1)))
    with pytest.raises((ValueError, TypeError), match=match):
        gs.graded_rows_chunk(mode, c, 0, 1, blocks, kw.get("gather"),
                             kw.get("roles"))


def test_rows_chunk_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    c = _p12_blocks()
    with pytest.raises(ValueError, match="cuda"):
        gs._launch_rows(gs.graded_step_f64, gs.P12, c, 0, 1,
                        gs.Blocks(20, 2, (0, 1)), None, (0, 1), 128)


def _card_params():
    out = []
    for n in (20, 1024):
        for k in (1, 2, 3, 4):
            for case in CASES:
                out += [(case, p, k, n) for p in PRECISIONS]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case,precision,k,n", _card_params())
def test_rows_kernel_over_k_blocks_bitwise_one_device_kernel_on_card(
        cuda, case, precision, k, n):
    spec = CARD_SCENES[n]
    kernels = (gs.graded_step_dd, gs.graded_step_f64, gs.graded_step_f32)
    before = sum(fn.launches for fn in kernels)
    got = _run(case, spec, precision, cuda, k)
    torch.cuda.synchronize()
    launched = sum(fn.launches for fn in kernels)
    assert launched - before == k * STEPS + len(CHUNKS)
    want = _reference(CASES[case][0], spec, precision, cuda)
    assert _differ(case, got, want) == []


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["dsqrt", "tf3"])
def test_rows_launchers_refuse_bad_blocks_and_roles_on_card(cuda,
                                                            precision):
    """cudaErrorInvalidValue (1), and no launch: ni not ceil(n / k), no
    block, the same row in both roles, a role past the rows, fewer roles
    than rows, P3 rows with roles, the fused driver (and in binary64 no
    dist3 form); r0 not a block's first row or past the last block, a
    step at offset 0 in its chunk, or no base-step word."""
    from nbody_tpu_torch.ops import _build

    lib = _build.load()
    c = _carry(CARD_SCENES[20], precision, gs.P12, cuda)
    dd = precision == "tf3"
    n, k = 20, 3
    ni = -(-n // k)
    qv = gs.to_blocks(c.q, c.v, k)
    out = torch.zeros_like(qv)
    launch = lib.graded_rows_dd_step if dd else lib.graded_rows_f64_step
    p = lambda x: x.data_ptr()   # noqa: E731
    ptrs = (p(c.m0), p(c.m_half), p(c.fst), p(c.md2), p(c.others),
            p(c.arr), p(c.arr.clone()), p(c.hit), None, p(c.min_d2),
            p(c.q_snap), p(c.v_snap))
    stream = torch.cuda.current_stream().cuda_stream
    base = torch.zeros(1, dtype=torch.int32, device=cuda)
    word = p(base)

    def step(mode=gs.P12, roles=(0, 1), ni_=ni, k_=k, dist3=1, r0=0, t=1,
             dst=p(out), s0=word):
        reals = (1.0, 0.0, 60.0, 0.0, 1e-6, 0.0, 1.0, 0.0) if dd else \
            (dist3, 1.0, 60.0, 1e-6, 1.0)
        return launch(*ptrs, mode, 2, n, 3, c.planet, *roles, ni_, k_,
                      *reals, p(qv), dst, r0, s0, t, 0, stream)

    bad = [{"ni_": ni + 1}, {"k_": 0}, {"roles": (0, 0)}, {"roles": (0, 2)},
           {"roles": (-1, -1)}, {"roles": (0, -1)}, {"mode": gs.P3},
           {"mode": gs.P123}, {"r0": 1}, {"r0": 3 * ni}, {"r0": -ni},
           {"t": 0}, {"s0": None}]
    if not dd:
        bad.append({"dist3": 0})
    for kw in bad:
        assert step(**kw) == 1, kw
    assert step() == 0
    assert step(r0=ni) == 0
    assert step(r0=ni, t=0, dst=None) == 0    # closing checks
    torch.cuda.synchronize()
