"""simulate's one-device binary64 and float32 chunks as one persistent
launch (csrc/sim_step.cuh sim_persistent; ops/sim_step sim_chunk_f64 and
sim_chunk_f32).

On a card a chunk of K steps is one cooperative launch whose blocks stay
resident for the K steps, with a grid barrier between two steps, on
min(row blocks, the blocks the card holds at once, `grid_cap`) blocks, up
to a size set in each kernel's source (512 bodies in binary64, 8192 in
float32); above it the pre-launch and one launch a step of the row-range
form on all n rows. Here, on the CPU, the host code around the C call
runs against the stand-in library of tests/test_torch_sim_graph.py
(`FakeLib`, which runs the plain chunk through the buffers' pointers).
The tests hold:

  * the wrapper counts the launches a chunk call reports through its
    out-parameter (one up to the size, K and the pre-launch above it and
    for the double-double kernel), with and without a graph;
  * the grid cap passed to the C call as given (0: none), and refused
    unless it is an int >= 0; a changed cap captures its own graph;
  * a CPU carry runs the plain chunk whatever the cap;
  * the build covers the persistent chunk's sources and headers.

On a card (marked `cuda`, skipped here) every variant (Euler and
leapfrog, Kahan on and off; dsqrt and sqrt3 in binary64) is bitwise its
plain version over a few steps at n = 5, 64, 1000 and bitwise the
unchanged launch-a-step row-range form at world size 1 over a 2000-step
chunk on both sides of the size (binary64 at n = 20, 512, 1024, 4096 and
at 512 with the grid cut to 7 blocks, so that blocks walk many row
blocks; float32 at 20, 1024, 8192 and at 1024 cut to 7); the chunk
kernels' SASS holds no non-coherent load; the barrier probe runs and the
grid is what the card reports. On a card:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sim_persistent.py
"""

import dataclasses
import math

import pytest
import torch

from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.ops import sim_step as ss
import test_torch_sim_graph as SG
import test_torch_sim_rows as R

VARIANTS = R.VARIANTS
_ONE = {"f64": ss.sim_chunk_f64, "f32": ss.sim_chunk_f32,
        "tf3": ss.sim_chunk_dd}
CHUNKS = [(0, 6), (6, 12), (12, 19)]


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


@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("graphs", [False, True])
@pytest.mark.parametrize("precision,integrator,compensated", SG.PRECISIONS)
def test_launches_counted_a_chunk(monkeypatch, precision, integrator,
                                  compensated, graphs, persistent):
    """The wrapper counts the launches the chunk call reports: one for a
    persistent chunk of the binary64 and float32 kernels, K and the
    pre-launch above their size (the stand-in's persistent_max_n) and for
    the double-double kernel; a replay counts what its capture reported;
    bitwise the plain chunks."""
    c, m0, m_half, fst, kw, lib = SG._setup(monkeypatch, precision,
                                            integrator, compensated)
    if not persistent:
        lib.persistent_max_n = c.q.shape[0] - 1
    fn = _ONE[precision]
    g = gs.ChunkGraphs(capture=SG.StandIn()) if graphs else None
    before = fn.launches
    for s0, s1 in CHUNKS:
        fn(c, m0, m_half, fst, s0, s1, graphs=g, **kw)
    want = len(CHUNKS) if precision != "tf3" and persistent else \
        sum(s1 - s0 + 1 for s0, s1 in CHUNKS)
    assert fn.launches - before == want
    assert [k for _, k, _, _ in lib.chunks] == \
        [s1 - s0 for s0, s1 in CHUNKS]
    R._equal(c, SG._plain(precision, integrator, compensated, CHUNKS))


@pytest.mark.parametrize("cap", [None, 0, 1, 7])
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_c_call_takes_the_grid_cap(monkeypatch, precision, cap):
    """The wrapper hands the C call its grid cap (0 when none is given)
    before the base step's word, chunk by chunk."""
    c, m0, m_half, fst, kw, lib = SG._setup(monkeypatch, precision,
                                            "leapfrog", True)
    extra = {} if cap is None else {"grid_cap": cap}
    for s0, s1 in CHUNKS:
        _ONE[precision](c, m0, m_half, fst, s0, s1, **extra, **kw)
    assert lib.grid_caps == [cap or 0] * len(CHUNKS)
    R._equal(c, SG._plain(precision, "leapfrog", True, CHUNKS))


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_grid_cap_is_in_the_graph_key(monkeypatch, precision):
    """A chunk of another grid cap captures its own graph; the same cap
    replays the first."""
    c, m0, m_half, fst, kw, lib = SG._setup(monkeypatch, precision,
                                            "euler", False)
    capture = SG.StandIn()
    graphs = gs.ChunkGraphs(capture=capture)
    for (s0, s1), cap, made in zip([(0, 5), (5, 10), (10, 15)], (0, 3, 0),
                                   (1, 2, 2)):
        _ONE[precision](c, m0, m_half, fst, s0, s1, graphs=graphs,
                        grid_cap=cap, **kw)
        assert len(capture.bodies) == made
    assert lib.grid_caps == [0, 3, 0]
    R._equal(c, SG._plain(precision, "euler", False, [(0, 15)]))


@pytest.mark.parametrize("cap", [-1, 1.5, "2", None])
@pytest.mark.parametrize("device", ["cpu", "stand-in"])
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_grid_cap_refused(monkeypatch, precision, device, cap):
    """A grid cap that is not an int >= 0 is refused before any launch,
    on a CPU carry too."""
    c, m0, m_half, fst, kw, lib = SG._setup(monkeypatch, precision,
                                            "euler", False)
    if device == "cpu":
        monkeypatch.setattr(ss, "_on_cpu", lambda c, name: True)
    fn = _ONE[precision]
    before = fn.launches
    with pytest.raises(ValueError, match="grid_cap"):
        fn(c, m0, m_half, fst, 0, 3, grid_cap=cap, **kw)
    assert fn.launches == before and lib.chunks == []


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_cpu_carry_runs_the_plain_chunk_whatever_the_cap(precision):
    inp = R._inputs(precision)
    c, m0, m_half, fst = R._tensors(inp, precision, "leapfrog", False)
    kw = dict(inp["kw"], integrator="leapfrog", compensated=False)
    fn = _ONE[precision]
    before = fn.launches
    for s0, s1 in CHUNKS:
        fn(c, m0, m_half, fst, s0, s1, grid_cap=5, **kw)
    assert fn.launches == before
    R._equal(c, SG._plain(precision, "leapfrog", False, CHUNKS))


@pytest.mark.parametrize("name", ["sim_step.cuh", "f64_force.cuh",
                                  "f32_force.cuh", "sim_step_f64.cu",
                                  "sim_step_f32.cu"])
def test_build_digest_covers_the_persistent_sources(tmp_path, monkeypatch,
                                                    name):
    """The persistent chunks' sources are compiled, and an edit to any of
    them or to the headers they share rebuilds the library."""
    import shutil

    assert {"sim_step_f64.cu", "sim_step_f32.cu"} <= set(_build.SOURCES)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    digest = _build.source_digest()
    path = csrc / name
    path.write_text(path.read_text() + "\n")
    assert _build.source_digest() != digest


# --- on a card -------------------------------------------------------------

CARD_ROWS_CASES = [
    dict(precision=p, integrator=i, compensated=c, n=n, cap=cap, dist3=d)
    for p in ("f64", "f32") for i, c in VARIANTS
    for d in (("dsqrt", "sqrt3") if p == "f64" else ("dsqrt",))
    for n, cap in (((20, 0), (512, 0), (512, 7), (1024, 0), (4096, 0))
                   if p == "f64" else
                   ((20, 0), (1024, 0), (1024, 7), (8192, 0)))]


def _case_id(case: dict) -> str:
    return "-".join(str(v) for v in case.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 64, 1000])
@pytest.mark.parametrize("precision,dist3", [("f64", "dsqrt"),
                                             ("f64", "sqrt3"),
                                             ("f32", "dsqrt")])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_persistent_bitwise_plain_on_card(cuda, integrator, compensated,
                                          precision, dist3, n):
    """A few chunks of one to three steps, one launch each, bitwise the
    plain chunk on the card."""
    import chip_smoke

    got, m0, mh, fst, kw, _ = chip_smoke.sim_carry(
        chip_smoke.plummer(n, 3), integrator, compensated, 7, precision)
    if precision == "f64":
        kw["dist3_mode"] = dist3
    want = dataclasses.replace(got)
    fn = _ONE[precision]
    before, chunks = fn.launches, ((0, 1), (1, 4), (4, 7))
    for s0, s1 in chunks:
        fn(got, m0, mh, fst, s0, s1, **kw)
        getattr(ss, fn.__name__ + "_ref")(want, m0, mh, fst, s0, s1, **kw)
    torch.cuda.synchronize()
    # one persistent launch a chunk up to 512 bodies in binary64 (8192 in
    # float32), above it the pre-launch and one a step (7 steps)
    assert fn.launches == before + (3 if precision == "f32" or n <= 512
                                    else 7 + 3)
    R._equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_ROWS_CASES, ids=_case_id)
def test_persistent_bitwise_rows_form_on_card(cuda, case):
    """A 2000-step chunk (one persistent launch up to the kernel's size,
    the pre-launch and one a step above) bitwise the row-range form at
    world size 1 (chip_smoke.check_persistent raises otherwise)."""
    import chip_smoke

    rec = chip_smoke.check_persistent(**case)
    assert rec["launches"] == (1 if rec["persistent"] else 2001)
    assert not rec["differ_rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("precision,small,big", [("f64", 512, 1024),
                                                 ("f32", 8192, 16384)])
def test_persistent_up_to_its_size_on_card(cuda, precision, small, big):
    """One persistent launch a chunk up to the kernel's size, the
    pre-launch and one a step above it, as the wrapper counts the
    launches the C call reports."""
    import chip_smoke

    fn = _ONE[precision]
    got = []
    for n in (5, 20, small, small + 1, big):
        c, m0, mh, fst, kw, _ = chip_smoke.sim_carry(
            chip_smoke.plummer(n, 3), "euler", False, 7, precision)
        before = fn.launches
        fn(c, m0, mh, fst, 0, 7, **kw)
        got.append(fn.launches - before)
    torch.cuda.synchronize()
    assert got == [1, 1, 1, 8, 8]


@pytest.mark.cuda
def test_persistent_sass_has_no_non_coherent_load(cuda):
    import chip_smoke

    assert chip_smoke.persistent_sass()["constant"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_barrier_probe_and_grid_on_card(cuda, precision):
    """The barriers alone run (a finite, positive time a barrier), and the
    grid the card reports is min(row blocks, resident blocks an SM times
    the SMs)."""
    import chip_smoke

    for n in (20, 1024):
        ms = chip_smoke.barrier_ms(precision, n, steps=200)
        assert math.isfinite(ms) and ms > 0
    info = chip_smoke.sim_step_info()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mine = {k: v for k, v in info.items()
            if k.startswith(f"sim_step_{precision}_")}
    assert mine
    for rec in mine.values():
        assert rec["grid"] == min(rec["row_blocks"],
                                  rec["blocks_per_sm"] * sms)


@pytest.mark.cuda
def test_persistent_refuses_bad_arguments_on_card(cuda):
    """The C entry points refuse a negative cap, K < 1 and no launch
    count without launching."""
    import ctypes

    lib = _build.load()
    word = torch.zeros(1, dtype=torch.int32, device=cuda)
    st = torch.zeros(2, ss.SLOTS, 8, 3, dtype=torch.float64, device=cuda)
    m = torch.ones(8, dtype=torch.float64, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    launched = ctypes.c_int(-1)
    for cap, K, out in ((-1, 3, ctypes.addressof(launched)),
                        (0, 0, ctypes.addressof(launched)), (0, 3, None)):
        rc = lib.sim_chunk_f64_launch(
            st[0].data_ptr(), st[1].data_ptr(), m.data_ptr(), m.data_ptr(),
            m.data_ptr(), 8, 0, 0, 1, 1.0, 1.0, 0.5, 1e-6, cap,
            word.data_ptr(), K, out, stream)
        assert rc != 0 and launched.value == -1
    for name in ("sim_barrier_f64_launch", "sim_barrier_f32_launch"):
        assert getattr(lib, name)(8, 0, 0, stream) != 0
        assert getattr(lib, name)(8, 3, -1, stream) != 0
