"""The port's span recorder (nbody_tpu_torch/utils/profiling.py) on the CPU.

A request (the CLI's solve, a simulate() call, an engine call with no
entry open) becomes one record when its root span closes: its chunk spans
and capture spans summed on the host's clock here (on a card the chunks'
own events; `chip_smoke.py` and the benchmark read those). The tests hold:

  * a CLI solve with `--stats`, fused, phased with an early hit, and
    phased on a mesh of one rank: the record counts the chunks the
    drivers enqueued, their rows x steps by driver, and outside + gaps +
    chunks = wall;
  * simulate() with a repeating chunk length through the graph path
    (stand-in capture and kernel library): one capture span, outside the
    chunk it lies in;
  * `nbody.*` ranges under torch.profiler, none entered without it;
  * a bounded deque, no record of a request that raises;
  * the benchmark's readers of the records (benchmark/metrics) on a
    synthetic run: the warm and the traced requests left out, None with
    too few records or none.
"""

import collections
import functools
import json
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.cells import Bench
from nbody_tpu_torch import config, engine, simulate
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.io import write_input
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.ops import chunking
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.parallel import solver_sharded as shd
from nbody_tpu_torch.utils import profiling
import test_torch_sim_graph as SG
import torch_mesh_workers as W

STEPS, CHUNK = 300, 40
SCENE_CFG = config.SimConfig(n_steps=STEPS, chunk_steps=CHUNK)
# hit at step 130, arrivals 23, 39, 7 (every device's row runs in P3)
SCENE = W.fuzz_scene(70, 16, 3)
_CASES = {"fused": [], "phased": [], "mesh": ["--mesh", "scen=1,body=1"]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy(monkeypatch, calls, module, name, rows_of):
    """Add (driver, rows, steps) of each chunk through module.name to
    calls."""
    fn = getattr(module, name)

    def spy(mode, c, s0, s1, *a, **k):
        calls.append((gs.DRIVERS[mode], rows_of(c), s1 - s0))
        return fn(mode, c, s0, s1, *a, **k)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("case", list(_CASES))
def test_cli_record_counts_the_drivers_chunks(tmp_path, monkeypatch, capsys,
                                              case):
    inp, out = str(tmp_path / "s.in"), str(tmp_path / "s.out")
    write_input(inp, SCENE)
    monkeypatch.setattr(config, "SimConfig",
                        functools.partial(config.SimConfig,
                                          chunk_steps=CHUNK))
    if case != "fused":
        monkeypatch.setattr(engine, "FUSED_MAX_N", 0)
    calls = []
    _spy(monkeypatch, calls, ds, "graded_chunk", lambda c: c.q.shape[0])
    _spy(monkeypatch, calls, shd, "graded_rows_chunk", lambda c: c.q.shape[2])
    assert main([inp, out, "--device", "cpu", "--n-steps", str(STEPS),
                 "--stats", *_CASES[case]]) == 0
    rec = json.loads(capsys.readouterr().err.strip().split("\n")[-1])
    assert rec == {**rec, **profiling.RECORDS[-1]}
    assert rec["answers"]["hit_time_step"] == 130
    assert rec["chunks"] == len(calls)
    want = collections.Counter()
    for driver, rows, steps in calls:
        want[driver] += rows * steps
    assert rec["row_steps"] == dict(want)
    assert rec["pairs"] == 16 * 16 * sum(want.values())
    p12 = [rows for driver, rows, _ in calls if driver == "p12"]
    if case == "fused":
        assert set(rec["row_steps"]) == {"p123"}
        assert len(calls) == len(list(ds._chunks(0, SCENE_CFG)))
        assert {rows for _, rows, _ in calls} == {5}
    else:
        # P1+P2 over every chunk, two rows until the host sees the hit
        assert len(p12) == len(list(ds._chunks(0, SCENE_CFG)))
        assert p12 == [2] * 4 + [1] * (len(p12) - 4)
        assert rec["row_steps"]["p3"] > 0
    phases = {"read_input", "oscillation_table", "write_output",
              *(("problems_fused",) if case == "fused"
                else ("problem_1_2", "problem_3"))}
    assert set(rec["phases_s"]) == phases
    assert rec["outside_s"] + rec["gaps_s"] + rec["chunk_s"] == \
        pytest.approx(rec["wall_s"], rel=1e-9)
    assert rec["span_s"] == pytest.approx(rec["gaps_s"] + rec["chunk_s"])
    assert 0 < rec["chunk_s"] < rec["wall_s"] and rec["gaps_s"] >= 0
    assert rec["chunk_host_s"] == pytest.approx(rec["chunk_s"])
    assert rec["captures"] == 0 and rec["capture_s"] == 0.0


class _SlowCapture(SG.StandIn):
    """The stand-in capture, taking 0.2 s as a slow real capture does."""

    def __call__(self, body):
        time.sleep(0.2)
        return super().__call__(body)


def test_simulate_records_one_capture_outside_its_chunk(monkeypatch):
    """simulate() over 12 steps in chunks of 5 through the graph path:
    three chunk spans of one row and one capture span, in the first chunk,
    whose start moves past it: the capture counts outside the chunks."""
    scene = W.fuzz_scene(103, 20, 3)
    monkeypatch.setattr(sys.modules["nbody_tpu_torch.simulate"],
                        "ChunkGraphs",
                        lambda: chunking.ChunkGraphs(capture=_SlowCapture()))
    W.fake_kernels(monkeypatch.setattr, SG.FakeLib(config.DEFAULT_CONFIG.eps))
    captures = chunking.GRAPHS.captures
    simulate(scene, n_steps=12, precision="f64", device="cpu", chunk=5)
    rec = profiling.RECORDS[-1]
    assert chunking.GRAPHS.captures == captures + 1
    assert rec["captures"] == 1 and rec["chunks"] == 3
    assert rec["row_steps"] == {"sim": 12}
    assert rec["outside_s"] >= rec["capture_s"] >= 0.2
    assert rec["phases_s"] == {}


class _Counting:
    """A stand-in for torch.profiler.record_function that counts."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counting.entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("profiled", [False, True])
def test_spans_mirror_only_under_a_profiler(monkeypatch, profiled):
    scene = W.fuzz_scene(103, 20, 3)
    if not profiled:
        monkeypatch.setattr(torch.profiler, "record_function", _Counting)
        _Counting.entered = 0
        simulate(scene, n_steps=12, precision="f64", device="cpu", chunk=5)
        assert _Counting.entered == 0
        return
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        simulate(scene, n_steps=12, precision="f64", device="cpu", chunk=5)
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith("nbody."))
    assert names == {"nbody.simulate": 1, "nbody.chunk": 3}


def test_records_stay_bounded():
    first = None
    for _ in range(profiling.RECORDS.maxlen + 8):
        with profiling.entry("empty") as req:
            pass
        first = first or req.record["request"]
    assert len(profiling.RECORDS) == profiling.RECORDS.maxlen == 512
    assert profiling.RECORDS[0]["request"] == first + 8
    assert profiling.RECORDS[-1] == req.record
    assert req.record["chunks"] == 0 and req.record["wall_s"] >= 0


def test_a_request_that_raises_leaves_no_record():
    last = profiling.RECORDS[-1] if profiling.RECORDS else None
    with pytest.raises(ValueError):
        with profiling.entry("bad"):
            with profiling.span("phase"):
                raise ValueError("no")
    assert (profiling.RECORDS[-1] if profiling.RECORDS else None) is last
    with profiling.entry("good") as req:       # nothing left open
        pass
    assert req.record["phases_s"] == {}


def _rec(k: float) -> dict:
    return {"wall_s": 10 * k, "outside_s": k, "gaps_s": 2 * k,
            "chunk_s": 7 * k, "capture_s": 0.5 * k,
            "row_steps": {"p12": 300 * k, "p3": 100 * k}}


_CTX = {"cell": {"traffic": {"template": {"n": 2}}}, "requests": 3,
        "work": {"pairs": 4 * 200, "precision": "f64"},
        "trace": {"kernel_s": 6.0, "busy_s": 1.0, "window_s": 1.0}}
# records: warm (k=100), the window's three (k = 1, 2, 3), traced (k=50)
_READERS = [("graded.chunk_gaps_s", 4.0), ("graded.outside_chunks_s", 2.0),
            ("graded.in_chunk_idle_s", 14.0 - 6.0),
            ("graded.rowstep_yield", 100.0 * 200 / 800),
            ("sim.capture_s", 1.0)]


@pytest.mark.parametrize("name,want", _READERS)
@pytest.mark.parametrize("kept", ["window", "too_few", "none"])
def test_readers_of_the_records(monkeypatch, name, want, kept):
    recs = [_rec(k) for k in (100, 1, 2, 3, 50)]
    if kept == "too_few":
        recs = recs[1:]
    monkeypatch.setattr(profiling, "RECORDS", collections.deque(recs))
    if kept == "none":       # a program without the recorder
        monkeypatch.delattr(profiling, "RECORDS")
    got = Bench().reader(name).read(dict(_CTX))
    assert got == (pytest.approx(want) if kept == "window" else None)
    if kept == "window" and name == "graded.in_chunk_idle_s":
        assert Bench().reader(name).read({**_CTX, "trace": None}) is None


def test_records_have_numbers_only():
    with profiling.entry("solve") as req:
        with profiling.chunk("p3", 2, 7, torch.device("cpu")):
            with profiling.capture():
                pass
    rec = req.record
    assert rec["row_steps"] == {"p3": 14} and rec["captures"] == 1
    flat = [v for v in rec.values() if not isinstance(v, dict)] + \
        [v for d in rec.values() if isinstance(d, dict) for v in d.values()]
    assert all(isinstance(v, (int, float)) and np.isfinite(v) for v in flat)
