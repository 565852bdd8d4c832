"""B1''s launch-a-step kernel (csrc/graded_step_f64.cu) and the geometry
each shape takes: counted in a request's record, and held bitwise on a
card.

The C entries `graded_chunk_f64_launch` and `graded_rows_f64_step` choose
the geometry of B1''s step kernel from the sources and the rows of a
launch (`b1_geometry` in the source), one of B1''s own producers
(f64_force.cuh `F64Producer`: zero numerators without the slow-path call,
several rows a compute thread, the source and its masses a tile ahead).
`graded_step_f64_geometry`
reports the choice; the wrapper names it (ops/graded_step `b1_geometry`)
and counts the rows x steps of each binary64 chunk that ran a launch a
step under that name in the request's record (`b1_row_steps`,
utils/profiling). Here, on the CPU, the host code runs against
`FakeGradedLib` (tests/test_torch_graded_graph.py), which reports one
producer geometry at every shape:

  * the geometry's name from what the library reports;
  * `b1_row_steps` in the record and the `--stats` line of a CLI solve:
    every row-step of the phased drivers and of the fused driver above the
    resident limit, none where the resident kernel runs;
  * the mesh's row-range chunk counted likewise, a float32 one not;
  * several copies of the sources built at once, each linked alone
    (`ops/_build._compile_and_link`, as `build_chunk_variants` uses it);
  * `chip_smoke.py`'s split of the step (phase 17) still finds the code it
    edits in these sources.

On a card (marked `cuda`, skipped here): at shapes on either side of each
threshold of the choice, the geometry the library reports, every carry of
the chunks bitwise the plain chunk on the card (P1+P2 at B=2 and B=1,
Problem 3 with a destroyed device, the fused driver's launch-a-step side,
the mesh form over one and two row blocks; every scene's sources hold
massless devices and each row's self-pair), and whole solves' answers
bitwise the native core, in dsqrt and sqrt3:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_b1_producer.py
"""

import ctypes
import functools
import json
import os
import tempfile

import pytest
import torch

from nbody_tpu_torch import config, engine
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.io import write_input
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.utils import profiling

from test_torch_graded_graph import RESIDENT_MAX_N, FakeGradedLib, StandIn
import torch_mesh_workers as W

# hit at step 130, arrivals 23, 39, 7 (tests/test_torch_trace.py's scene)
SCENE = W.fuzz_scene(70, 16, 3)
STEPS, CHUNK = 300, 40
FAKE = "producer_{1}x{2}_tile{3}_ring{4}".format(*FakeGradedLib.geometry)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Reports:
    """A library that reports geometry `out` at every shape."""

    def __init__(self, out):
        self.out = out
        self.asked = []

    def graded_step_f64_geometry(self, B, n, ni, out):
        self.asked.append((B, n, ni))
        for k, x in enumerate(self.out):
            ctypes.c_int.from_address(out + 4 * k).value = x
        return 0


@pytest.mark.parametrize("out,name", [
    ((0, 4, 1, 64, 4), "producer_4x1_tile64_ring4"),
    ((3, 8, 2, 64, 3), "producer_8x2_tile64_ring3"),
    ((2, 4, 2, 128, 3), "producer_4x2_tile128_ring3")])
def test_geometry_names(out, name):
    lib = Reports(out)
    assert gs.b1_geometry(lib, 2, 1024, 512) == name
    assert lib.asked == [(2, 1024, 512)]


def test_geometry_report_that_fails_raises():
    lib = Reports((0,) * 5)
    lib.graded_step_f64_geometry = lambda *a: 1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        gs.b1_geometry(lib, 1, 20, 20)


@pytest.mark.parametrize("path", ["resident", "step", "phased"])
def test_stats_count_the_row_steps_of_each_geometry(tmp_path, monkeypatch,
                                                    capsys, path):
    """A CLI solve whose chunks run through the graph path (stand-in
    capture and library): `b1_row_steps` in the record and the `--stats`
    line holds every row-step of the chunks that ran a launch a step,
    under the geometry the library reported (all of the phased drivers'
    and of the fused driver's above the resident limit), and none where
    each chunk is one launch of the resident kernel."""
    inp, out = str(tmp_path / "s.in"), str(tmp_path / "s.out")
    write_input(inp, SCENE)
    monkeypatch.setattr(config, "SimConfig",
                        functools.partial(config.SimConfig,
                                          chunk_steps=CHUNK))
    if path == "phased":
        monkeypatch.setattr(engine, "FUSED_MAX_N", 0)

    def chunk_fn(mode, c, s0, s1):
        gs._check(mode, c, s0, s1)
        c.graphs = c.graphs or gs.ChunkGraphs(capture=StandIn())
        lib = FakeGradedLib(c)
        lib.resident_max_n = 0 if path == "step" else RESIDENT_MAX_N
        with profiling.chunk(gs.DRIVERS[mode], c.q.shape[0], s1 - s0,
                             c.q.device):
            gs._replay_chunk(gs.graded_step_f64, mode, c, s0, s1, lib)

    monkeypatch.setattr(ds, "graded_chunk", chunk_fn)
    assert main([inp, out, "--device", "cpu", "--n-steps", str(STEPS),
                 "--stats"]) == 0
    stats = json.loads(capsys.readouterr().err.strip().split("\n")[-1])
    assert stats["answers"]["hit_time_step"] == 130
    ran = sum(stats["row_steps"].values())
    assert ran > 0
    assert stats["b1_row_steps"] == ({} if path == "resident"
                                     else {FAKE: ran})
    assert profiling.RECORDS[-1]["b1_row_steps"] == stats["b1_row_steps"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rows_chunk_counts_its_geometry(dtype):
    """The mesh's row-range chunk through the graph path (stand-in capture
    and library, two blocks of one rank each computed here): a binary64
    chunk's rows x steps under the geometry reported for its rows a
    launch, asked at (B, n, ni); a float32 chunk's none."""
    cfg = config.SimConfig(n_steps=60)
    from nbody_tpu_torch.physics import oscillation_table

    c = ds._p12_carry(SCENE, oscillation_table(cfg), cfg,
                      torch.device("cpu"), dtype)
    blocks = gs.Blocks(SCENE.n, 2, (0, 1))
    c.q, c.v = gs.to_blocks(c.q, c.v, 2), None
    c.graphs = gs.ChunkGraphs(capture=StandIn())
    lib = FakeGradedLib(c)
    asked = []
    report = lib.graded_step_f64_geometry
    lib.graded_step_f64_geometry = lambda *a: asked.append(a[:3]) or \
        report(*a)
    fn = gs.graded_step_f64 if dtype == torch.float64 else \
        gs.graded_step_f32
    with profiling.entry("test") as req:
        for s0, s1 in [(0, 7), (7, 14)]:
            gs._check(gs.P12, c, s0, s1, blocks)
            gs._replay_rows(fn, gs.P12, c, s0, s1, blocks, None, (0, 1),
                            gs.TILE_J, lib)
    f64 = dtype == torch.float64
    assert req.record["b1_row_steps"] == ({FAKE: 2 * 14} if f64 else {})
    assert asked == ([(2, SCENE.n, blocks.ni)] if f64 else [])


def test_variants_compile_at_once_and_link_each(tmp_path, monkeypatch):
    """Several libraries built from several copies of the sources: every
    compile of every copy in one batch, then one link a library of its own
    objects, each library moved to its path."""
    batches, source_of = [], {}

    def nvcc_all(cmds):
        cmds = list(cmds)
        batches.append(cmds)
        for cmd in cmds:
            out = cmd[cmd.index("-o") + 1]
            source_of[out] = cmd[-1]
            with open(out, "w") as f:
                f.write(" ".join(cmd))

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_nvcc_all", nvcc_all)
    libs = {str(tmp_path / f"lib{k}.so"): f"/src{k}" for k in range(3)}
    _build._compile_and_link(libs, ("a.cu", "b.cu"))
    compiles, links = batches
    assert len(compiles) == 6 and len(links) == 3
    assert sorted(c[-1] for c in compiles) == sorted(
        f"/src{k}/{name}" for k in range(3) for name in ("a.cu", "b.cu"))
    for k, path in enumerate(libs):
        with open(path) as f:
            link = f.read().split()
        objs = link[link.index("-o") + 2:]
        assert sorted(source_of[o] for o in objs) == [
            f"/src{k}/a.cu", f"/src{k}/b.cu"]


def test_split_edits_find_their_code():
    """chip_smoke.py phase 17 times a checkout's step with parts taken
    out (this one's, and a parent's with these sources), and each of its
    geometries forced, by editing a copy of the sources: each edit it
    makes here is found, once; the geometries are the four of the
    source."""
    import chip_smoke

    assert chip_smoke.b1_geometries() == 4
    edits = dict(chip_smoke.SPLIT_EDITS)
    edits.update({f"g{g}": chip_smoke.forced_geometry(g) for g in range(4)})
    with tempfile.TemporaryDirectory() as tmp:
        for name, edit in edits.items():
            chip_smoke.edited_csrc(_build.CSRC, edit,
                                   os.path.join(tmp, name))


# --- on a card -----------------------------------------------------------

# the shapes on either side of each threshold of the library's choice
# (b1_geometry), (driver, n, rows) with the geometry b1_expected gives on
# a card of 132 SMs: 64 | 65 sources (one tile), 256 | 257 (one row a
# compute thread), the blocks of two rows in one wave or not (n = 512 at
# B = 2 | 3, 1024 at B = 1 | 2; at 3 blocks an SM up to 256 sources, n =
# 128 at B = 6 | 7), 512 | 513 sources past it; the fused driver's
# launch-a-step side at 61 to 128 bodies (its B = 2 + D rows); many
# sources, a whole last tile and a ragged one (4096 | 4097)
CARD_CHUNKS = [("p12", 64, 2), ("p12", 65, 2), ("p12", 256, 1),
               ("p12", 257, 1), ("p12", 512, 2), ("p3", 512, 3),
               ("p3", 513, 3), ("p12", 1024, 1), ("p12", 1024, 2),
               ("p123", 61, 5), ("p123", 100, 5), ("p123", 128, 5),
               ("p123", 128, 6), ("p123", 128, 7),
               ("p12", 4096, 1), ("p12", 4097, 1)]
# (fuzz seed 79 grown to n: hit at step 73, saved by device 3, so Problem
# 3 runs with a destroyed device; fused up to 128 bodies, phased above)
CARD_SOLVES = [65, 128, 257, 1024]
SOLVE_SEED, SOLVE_STEPS = 79, 120


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def b1_expected(n: int, B: int, ni: int, sms: int) -> int:
    """The geometry csrc/graded_step_f64.cu b1_geometry chooses, by its
    rule (the test's own statement of it)."""
    blocks = B * ((ni + 1) // 2)
    if n <= 64:
        return 0
    if n <= 256:
        return 1 if blocks <= 3 * sms else 0
    if blocks <= 4 * sms:
        return 2
    return 0 if n <= 512 else 3


def _geometry_index(B: int, n: int, ni: int) -> int:
    out = (ctypes.c_int * 5)()
    lib = _build.load()
    assert lib.graded_step_f64_geometry(B, n, ni, ctypes.addressof(out)) == 0
    return out[0]


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _scene(n: int):
    """Fuzz scene (1, n, 3) for the phased drivers, RESIDENT_SEED's (103,
    n, 3) for the fused one (chip_smoke.py's)."""
    return W.fuzz_scene(1, n, 3)


def _make(driver: str, n: int, B: int, dist3: str):
    """A maker of the driver's step-0 carry on a device: P1+P2 at B = 2 or
    B = 1 (as after the P2 early exit); Problem 3 with a row a device,
    each from the initial state, arriving at steps 5, 120 and 40 (each
    device destroyed from its arrival on); the fused driver with B - 2
    devices."""
    import numpy as np

    from nbody_tpu_torch.physics import oscillation_table

    cfg = config.SimConfig(dist3_mode=dist3)
    fst = oscillation_table(cfg)
    if driver == "p123":
        scene = W.fuzz_scene(103, n, B - 2)
        return lambda d: ds._p123_carry(scene, fst, cfg, d, torch.float64)
    scene = _scene(n)
    if driver == "p12":
        def make(d):
            c = ds._p12_carry(scene, fst, cfg, d, torch.float64)
            if B == 1:
                c.q, c.v, c.m0, c.m_half = (x[:1] for x in (
                    c.q, c.v, c.m0, c.m_half))
            return c
        return make

    def make(d):
        qv = [ds._t(np.stack([x] * B), d, torch.float64)
              for x in (scene.q, scene.v)]
        p12 = ds.P12Result(min_dist=0.0, hit_time_step=300,
                           arrivals=np.asarray([5, 120, 40][:B]),
                           q_snaps=qv[0], v_snaps=qv[1])
        return ds._p3_carry(scene, p12, fst, cfg, np.arange(B), d,
                            torch.float64)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("dist3", ["dsqrt", "sqrt3"])
@pytest.mark.parametrize("driver,n,B", CARD_CHUNKS)
def test_each_geometry_bitwise_plain_chunk_on_card(cuda, driver, n, B,
                                                   dist3):
    """Every carry of two chunks (150 + 150 steps; 40 + 40 from 4096
    sources on) bitwise the plain chunk's on the card, at a shape whose
    geometry is b1_expected's."""
    import chip_smoke

    assert _geometry_index(B, n, n) == b1_expected(n, B, n, _sms())
    mode = {"p12": gs.P12, "p3": gs.P3, "p123": gs.P123}[driver]
    half = 150 if n < 4096 else 40
    rec = chip_smoke.check_step(f"{driver} n={n} B={B}", mode,
                                _make(driver, n, B, dist3),
                                [(0, half), (half, 2 * half)])
    assert rec["bitwise_equal"], rec


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_mesh_form_bitwise_plain_chunk_on_card(cuda, k):
    """The row-range chunk over k = 1 and 2 row blocks (a mesh of one and
    of two body ranks, every block computed here) bitwise the plain
    chunk's at n = 1024, B = 2: the blocks of two rows fill the card once
    at k = 2 and not at k = 1, so each takes its own geometry."""
    n, B, ni = 1024, 2, -(-1024 // k)
    assert _geometry_index(B, n, ni) == b1_expected(n, B, ni, _sms())
    make = _make("p12", n, B, "dsqrt")
    got, want = make(cuda), make(cuda)
    got.q, got.v = gs.to_blocks(got.q, got.v, k), None
    blocks = gs.Blocks(n, k, tuple(range(k)))
    for s0, s1 in [(0, 150), (150, 300)]:
        gs.graded_rows_chunk(gs.P12, got, s0, s1, blocks)
        gs._REF[gs.P12](want, s0, s1)
    got.q, got.v = gs.from_blocks(got.q, n)
    for name in ("q", "v", "arr", "hit", "min_d2", "q_snap", "v_snap"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dist3", ["dsqrt", "sqrt3"])
@pytest.mark.parametrize("n", CARD_SOLVES)
def test_solve_bitwise_native_core_on_card(cuda, n, dist3):
    """A whole solve on the card (the fused driver up to 128 bodies, the
    phased ones above; Problem 3 with a destroyed device) gives the
    native core's answers, bit for bit; its record counts every row-step
    of its launch-a-step chunks under the geometries the library chose."""
    from test_torch_graded_step import _bits, _grown

    from nbody_tpu_torch import native
    from nbody_tpu_torch.engine import solve_scene

    scene = _grown(SOLVE_SEED, n)
    cfg = config.SimConfig(n_steps=SOLVE_STEPS, dist3_mode=dist3)
    want = native.solve_exact(scene, cfg, dist3)
    assert want[1] != -2
    with profiling.entry("test") as req:
        got = solve_scene(scene, cfg, device="cuda").as_tuple()
    assert _bits(got) == _bits(want)
    rec = req.record
    assert sum(rec["b1_row_steps"].values()) == \
        sum(rec["row_steps"].values())
