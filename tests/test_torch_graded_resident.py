"""The resident chunk (csrc/graded_step_f64.cu): the binary64 fused
driver's chunk of K steps as one launch of a thread block cluster, one
block a scenario row keeping its carry in shared memory, where n is at
most RESIDENT_MAX_N, the rows at most RES_MAX_ROWS and a block's part
fits.

The C entry `graded_chunk_f64_launch` chooses that path by shape alone and
reports the kernels it launched into a host int; the wrapper
(ops/graded_step._replay_chunk) adds what the call reported at its capture
to `graded_step_f64.launches`, and counts a chunk of one launch in the
request's record as `resident_chunks` (utils/profiling), which `--stats`
prints. Here, on the CPU, the host code runs against `FakeGradedLib`
(tests/test_torch_graded_graph.py), whose chunk call writes the launches
it stands for: one for a binary64 fused chunk of at most its
`resident_max_n` bodies, K + 1 otherwise. The tests hold:

  * the launches the call reports, counted a replay, with a graph and
    with a direct call a chunk, on both sides of the limit;
  * `resident_chunks` in the record and in the `--stats` line of a CLI
    solve whose chunks run through the graph path;
  * a CPU carry still runs the plain chunk: no launch, no resident chunk;
  * every C entry point of the sources declared by the build with as many
    arguments as its definition has.

On a card (marked `cuda`, skipped here) the resident chunk is held bitwise
against the launch-a-step path (a library built from these sources with
RESIDENT_MAX_N at 0) on every carry, and the benchmark's b20 template is
solved with its .out byte-equal to the native oracle
(`chip_smoke.check_resident`, `chip_smoke.resident_b20`):
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graded_resident.py
"""

import ctypes
import dataclasses
import functools
import json
import os
import re
import types

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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fused_carry(n_steps: int = 60) -> gs.Carry:
    cfg = config.SimConfig(n_steps=n_steps)
    from nbody_tpu_torch.physics import oscillation_table

    return ds._p123_carry(SCENE, oscillation_table(cfg), cfg,
                          torch.device("cpu"), torch.float64)


def _chunks_through(c: gs.Carry, chunks: list, lib, graph: bool) -> None:
    """The chunks of the fused carry c through the graph path: one
    capture and a replay a chunk (`graph`), or a direct call a chunk (a
    new entry whose capture is the body itself)."""
    for s0, s1 in chunks:
        if not graph:
            c.graphs = None
        c.graphs = c.graphs or gs.ChunkGraphs(
            capture=StandIn() if graph else (lambda body: body))
        gs._check(gs.P123, c, s0, s1)
        gs._replay_chunk(gs.graded_step_f64, gs.P123, c, s0, s1, lib)


@pytest.mark.parametrize("limit", ["resident", "step"])
@pytest.mark.parametrize("graph", [True, False])
def test_wrapper_adds_the_launches_the_call_reports(graph, limit):
    """Chunks of 7, 7 and 6 steps of the fused driver at n = 16: one
    launch a chunk where the library runs the resident chunk, K + 1 where
    the shape is above its limit; the carry bitwise the plain chunk's
    either way, and a resident chunk counted in the open request alone."""
    got, want = _fused_carry(), _fused_carry()
    lib = FakeGradedLib(got)
    lib.resident_max_n = RESIDENT_MAX_N if limit == "resident" else 15
    chunks = [(0, 7), (7, 14), (14, 20)]
    before = gs.graded_step_f64.launches
    with profiling.entry("test") as req:
        _chunks_through(got, chunks, lib, graph)
    for s0, s1 in chunks:
        gs._p123_chunk_ref(want, s0, s1)
    resident = limit == "resident"
    assert gs.graded_step_f64.launches - before == (
        len(chunks) if resident else sum(s1 - s0 + 1 for s0, s1 in chunks))
    assert req.record["resident_chunks"] == (len(chunks) if resident else 0)
    assert lib.chunks == [(s0, s1 - s0) for s0, s1 in chunks]
    for f in dataclasses.fields(want):
        x = getattr(want, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(getattr(got, f.name), x), f.name
    # no request open: the launches are counted, nothing is recorded
    records = len(profiling.RECORDS)
    _chunks_through(got, [(20, 27)], lib, graph)
    assert len(profiling.RECORDS) == records


def test_replay_adds_what_the_capture_reported():
    """A replay of a CUDA graph makes no C call: the launches it adds are
    those the call reported when it was captured."""
    c = _fused_carry()
    lib = FakeGradedLib(c)
    calls = []

    class CaptureOnce:
        """A stand-in capture that runs the body once, as a capture runs
        the C call, and replays nothing."""

        def __call__(self, body):
            body()
            calls.append(body.launched.value)
            return lambda: None

    c.graphs = gs.ChunkGraphs(capture=CaptureOnce())
    before = gs.graded_step_f64.launches
    for s0, s1 in [(0, 5), (5, 10), (10, 15)]:
        gs._replay_chunk(gs.graded_step_f64, gs.P123, c, s0, s1, lib)
    assert calls == [1] and len(lib.chunks) == 1
    assert gs.graded_step_f64.launches - before == 3


@pytest.mark.parametrize("limit", ["resident", "step", "phased"])
def test_stats_print_the_resident_chunks(tmp_path, monkeypatch, capsys,
                                         limit):
    """A CLI solve whose chunks run through the graph path (stand-in
    capture and library): the record and the `--stats` line count a
    resident chunk a chunk, and one launch each, for fused chunks below
    the limit; none, and K + 1 launches a chunk, above it and in the
    phased drivers (P1+P2, Problem 3), which never take it."""
    inp, out = str(tmp_path / "s.in"), str(tmp_path / "s.out")
    write_input(inp, SCENE)
    monkeypatch.setattr(config, "SimConfig",
                        functools.partial(config.SimConfig,
                                          chunk_steps=CHUNK))
    if limit == "phased":
        monkeypatch.setattr(engine, "FUSED_MAX_N", 0)
    chunks = []

    def chunk_fn(mode, c, s0, s1):
        gs._check(mode, c, s0, s1)
        chunks.append(s1 - s0)
        c.graphs = c.graphs or gs.ChunkGraphs(capture=StandIn())
        lib = FakeGradedLib(c)
        lib.resident_max_n = 0 if limit == "step" else RESIDENT_MAX_N
        with profiling.chunk(gs.DRIVERS[mode], c.q.shape[0], s1 - s0,
                             c.q.device):
            gs._replay_chunk(gs.graded_step_f64, mode, c, s0, s1, lib)

    monkeypatch.setattr(ds, "graded_chunk", chunk_fn)
    assert SCENE.n <= RESIDENT_MAX_N
    assert main([inp, out, "--device", "cpu", "--n-steps", str(STEPS),
                 "--stats"]) == 0
    stats = json.loads(capsys.readouterr().err.strip().split("\n")[-1])
    assert stats["answers"]["hit_time_step"] == 130
    assert len(chunks) == stats["chunks"]
    assert set(stats["row_steps"]) == (
        {"p12", "p3"} if limit == "phased" else {"p123"})
    if limit != "phased":
        assert len(chunks) == -(-STEPS // CHUNK)
    resident = limit == "resident"
    assert stats["resident_chunks"] == (len(chunks) if resident else 0)
    assert stats["graded_step_f64_launches"] == (
        len(chunks) if resident else sum(k + 1 for k in chunks))
    assert profiling.RECORDS[-1]["resident_chunks"] == \
        stats["resident_chunks"]


def test_cpu_carry_runs_the_plain_chunk(monkeypatch):
    """graded_chunk on a CPU fused carry runs the plain chunk
    (`_p123_chunk_ref`): bitwise it, no launch, no resident chunk."""
    got, want = _fused_carry(), _fused_carry()
    ran = []
    plain = gs._REF[gs.P123]
    monkeypatch.setitem(gs._REF, gs.P123,
                        lambda c, s0, s1: ran.append((s0, s1))
                        or plain(c, s0, s1))
    before = gs.graded_step_f64.launches
    with profiling.entry("test") as req:
        gs.graded_chunk(gs.P123, got, 0, 9)
        gs.graded_chunk(gs.P123, got, 9, 20)
    plain(want, 0, 20)
    assert ran == [(0, 9), (9, 20)]
    assert gs.graded_step_f64.launches == before
    assert req.record["resident_chunks"] == 0
    for name in ("q", "v", "arr", "hit", "min_d2", "p3_hit"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _entry_points() -> dict:
    """Every `extern "C"` function of the library's sources: name ->
    its parameter count."""
    out = {}
    for name in _build.SOURCES:
        with open(os.path.join(_build.CSRC, name)) as f:
            text = f.read()
        for fn, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                     text, flags=re.S):
            out[fn] = 0 if not params.strip() else params.count(",") + 1
    return out


def test_build_declares_every_entry_point():
    """The build compiles the resident chunk's source and declares every
    C entry point of the sources, each with as many arguments as its
    definition takes: the graded chunk calls with the host int of their
    launches, and graded_resident_f64_info."""

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, types.SimpleNamespace())

    assert "graded_step_f64.cu" in _build.SOURCES
    lib = Lib()
    assert _build.declare(lib) is lib
    points = _entry_points()
    assert {"graded_chunk_f64_launch", "graded_resident_f64_info"} <= \
        set(points)
    assert set(lib.fns) == set(points)
    for name, count in points.items():
        assert len(lib.fns[name].argtypes) == count, name
    for name in ("graded_chunk_f64_launch", "graded_chunk_f32_launch",
                 "graded_chunk_dd_launch"):
        assert lib.fns[name].argtypes[-2:] == [ctypes.c_void_p] * 2


def test_resident_limit_is_a_fused_size():
    """The limit set in the source lies among the fused driver's sizes."""
    assert 1 <= RESIDENT_MAX_N <= engine.FUSED_MAX_N


# --- on a card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_CASES = ["2-2", "20-3", "20-5", "20-bmax", "max-3", "max-5",
              "max-bmax", "max+1-5"]


@pytest.mark.cuda
@pytest.mark.parametrize("dist3", ["dsqrt", "sqrt3"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_resident_chunk_bitwise_launch_a_step_on_card(cuda, case, dist3):
    """q, v, arr, hit, min_d2 and p3_hit of the fused chunks bitwise the
    launch-a-step path's, over chunks cut at arrivals, of 1999 and 2000
    steps and across a resume; n = 2, 20, the limit and the first size
    above it (the old path), B = 3, 5 and the most rows that fit."""
    import chip_smoke

    n_label, b_label = case.rsplit("-", 1)
    rec = chip_smoke.check_resident(n_label, b_label, dist3)
    assert not rec["differ"] and not rec["differ_resumed"], rec
    assert rec["launches"] == rec["launches_expected"], rec


@pytest.mark.cuda
def test_b20_template_out_byte_equal_oracle_on_card(cuda, tmp_path):
    """The benchmark's b20 template over the full horizon through the
    CLI: .out byte-equal to `native/oracle ... dsqrt`, 100 chunks, each
    one launch of the resident chunk."""
    import chip_smoke

    rec = chip_smoke.resident_b20(str(tmp_path))
    assert rec["out_byte_equal"], rec
    assert rec["launches"] == rec["resident_chunks"] == 100, rec
