"""simulate's chunk as one CUDA graph (ops/sim_step with `graphs`).

On a card a simulate chunk whose length repeats in the run is one replay
of a graph captured from the chunk's C call (one card) or from its loop of
row-range launches and in-place all_gathers (the mesh) at the first chunk
of its shape; the kernels read the chunk's base step from a device word
the host writes before each replay, and the state stays in the carry's
own pair of state buffers (`SimCarry.slots`). Here, on the CPU, the same
host code runs with a stand-in capture (the "replay" calls the captured
body) and a stand-in kernel library (`FakeLib`): its `sim_chunk_*_launch`
reads the state buffers and the base-step word through their pointers,
runs the plain chunk from that step and leaves the result where the
kernels' contract puts it (the slots of the first buffer for an even K,
of the second for an odd one); its `sim_rows_*_step` are
torch_mesh_workers.FakeSimLib's emulated row-range launches. The tests
hold:

  * one capture for successive chunks of one K, and a new one for a
    shorter tail chunk and when the integrator, the compensation, dist3,
    the tile or the blocks change;
  * no capture for a run of a single chunk (`simulate._plan`) or for a
    caller that passes no graphs;
  * the state in the carry's fixed slots for odd and even K;
  * replays bitwise the plain chunks, and `simulate(...)` through the
    graph path bitwise the plain path in f64, f32 and tf3;
  * on the mesh: one launch a block and step, a gather after every step
    but the last, the closing gather into a fixed buffer, bitwise the
    eager loop, also on gloo ranks with the real all_gather;
  * the launch, replay and capture counts.

On a card (marked `cuda`, skipped here) the replay is held bitwise against
a direct C call of the same chunks (`chip_smoke.check_sim_graphs`):
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sim_graph.py
"""

import ctypes
import math
import sys

import numpy as np
import pytest
import torch

from nbody_tpu_torch import simulate
from nbody_tpu_torch.config import DEFAULT_CONFIG
from nbody_tpu_torch.ops import chunking
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.ops import sim_step as ss
from nbody_tpu_torch.ops.forces import DIST3_CODES
from nbody_tpu_torch.ops.chunking import Blocks
from nbody_tpu_torch.parallel.spawn import run_ranks
from nbody_tpu_torch.simulate import _plan
from nbody_tpu_torch.utils.rescale import compute_rescale
import test_torch_sim_rows as R
import torch_mesh_workers as W

VARIANTS = R.VARIANTS
PRECISIONS = [("f64", i, c) for i, c in VARIANTS] + \
    [("f32", i, c) for i, c in VARIANTS] + \
    [("tf3", "euler", False), ("tf3", "leapfrog", False)]
_ONE = {"f64": ss.sim_chunk_f64, "f32": ss.sim_chunk_f32,
        "tf3": ss.sim_chunk_dd}
_REF = {"f64": ss.sim_chunk_f64_ref, "f32": ss.sim_chunk_f32_ref,
        "tf3": ss.sim_chunk_dd_ref}
_DIST3 = {code: name for name, code in DIST3_CODES.items()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _view(ptr, shape: tuple, dtype) -> torch.Tensor:
    """The memory at ptr as a tensor of `shape` (the buffer itself)."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


class FakeLib(W.FakeSimLib):
    """A stand-in for the kernel library's simulate entry points on CPU
    tensors (module docstring); `chunks` records each chunk call as (s0,
    K, st0, st1), `grid_caps` the persistent chunks' grid caps (binary64
    and float32) call by call. A chunk call writes the launches it stands
    for into the host int at `launched`, as the library's does."""

    # the largest n whose binary64 or float32 chunk call stands for one
    # persistent launch; above it, and in double-double, the pre-launch
    # and one a step
    persistent_max_n = 1 << 30

    def __init__(self, eps: float):
        super().__init__(eps)
        self.chunks = []
        self.grid_caps = []

    def sim_chunk_f64_launch(self, st0, st1, m0, mh, fst, n, integ, comp,
                             dist3, G, dt, kick, eps2, grid_cap, word, K,
                             launched, stream):
        self.grid_caps.append(grid_cap)
        return self._chunk("f64", st0, st1, m0, mh, fst, n, integ, comp,
                           {"G": G, "dt": dt, "dist3_mode": _DIST3[dist3]},
                           word, K, launched)

    def sim_chunk_f32_launch(self, st0, st1, m0, mh, fst, n, integ, comp,
                             G, dt, kick, eps2, grid_cap, word, K, launched,
                             stream):
        self.grid_caps.append(grid_cap)
        return self._chunk("f32", st0, st1, m0, mh, fst, n, integ, comp,
                           {"G": G, "dt": dt}, word, K, launched)

    def sim_chunk_dd_launch(self, st0, st1, m0, mh, fst, n, integ, G, dt,
                            kick, eps2_hi, eps2_lo, word, K, launched,
                            stream):
        return self._chunk("tf3", st0, st1, m0, mh, fst, n, integ, None,
                           {"G": G, "dt": dt}, word, K, launched)

    def _chunk(self, precision, st0, st1, m0p, mhp, fstp, n, integ, comp,
               kw, word, K, launched):
        s0 = int(_view(word, (1,), torch.int32)[0])
        self.chunks.append((s0, K, st0, st1))
        ctypes.c_int.from_address(launched).value = \
            1 if precision != "tf3" and n <= self.persistent_max_n else K + 1
        dtype = torch.float32 if precision == "f32" else torch.float64
        tail = (2,) if precision == "tf3" else ()
        bufs = [_view(p, (ss.SLOTS, n, 3) + tail, dtype) for p in (st0, st1)]
        lf = ss.INTEGRATORS[integ] == "leapfrog"
        c = ss.SimCarry(*(bufs[0][slot].clone() if on else None
                          for slot, on in enumerate(
                              (True, True, lf, bool(comp), bool(comp)))))
        if comp is not None:
            kw["compensated"] = bool(comp)
        _REF[precision](c, _view(m0p, (n,) + tail, dtype),
                        _view(mhp, (n,) + tail, dtype),
                        _view(fstp, (s0 + K + 1,), dtype), s0, s0 + K,
                        eps=self.eps, integrator=ss.INTEGRATORS[integ],
                        **kw)
        for slot, x in enumerate(ss._state(c)):
            if x is not None:
                bufs[K & 1][slot].copy_(x)
        return 0


class StandIn:
    """A stand-in capture: it keeps the body, which each replay calls."""

    def __init__(self):
        self.bodies = []

    def __call__(self, body):
        self.bodies.append(body)
        return body


def _counts():
    return (chunking.GRAPHS.replays, chunking.GRAPHS.captures)


def _setup(monkeypatch, precision, integrator, compensated):
    """A CPU carry, its masses and table, the chunk keywords, and the
    stand-in library the wrappers' CUDA path goes to."""
    inp = R._inputs(precision)
    c, m0, m_half, fst = R._tensors(inp, precision, integrator, compensated)
    kw = dict(inp["kw"], integrator=integrator)
    if precision != "tf3":
        kw["compensated"] = compensated
    lib = FakeLib(inp["kw"]["eps"])
    W.fake_kernels(monkeypatch.setattr, lib)
    return c, m0, m_half, fst, kw, lib


def _plain(precision, integrator, compensated, chunks, **extra):
    inp = R._inputs(precision)
    c, m0, m_half, fst = R._tensors(inp, precision, integrator, compensated)
    kw = dict(inp["kw"], integrator=integrator, **extra)
    if precision != "tf3":
        kw["compensated"] = compensated
    for s0, s1 in chunks:
        _REF[precision](c, m0, m_half, fst, s0, s1, **kw)
    return c


def _slot_views(c: ss.SimCarry) -> bool:
    """Whether each of the carry's tensors is its slot of c.slots[0]."""
    return all(x is None or x.data_ptr() == c.slots[0, slot].data_ptr()
               for slot, x in enumerate(ss._state(c)))


@pytest.mark.parametrize("K", [6, 7])
@pytest.mark.parametrize("precision,integrator,compensated", PRECISIONS)
def test_chunks_in_fixed_slots_bitwise_plain(monkeypatch, precision,
                                             integrator, compensated, K):
    """Three successive chunks of K steps through one graph: the carry's
    tensors are views of its own slots at fixed addresses after every
    chunk (an odd K's result copied back from the second buffer), bitwise
    the plain chunks, with one capture, three replays, every chunk call
    on the carry's pair and the launches of a replay: one persistent
    launch (binary64, float32) or K and the pre-launch (double-double)."""
    c, m0, m_half, fst, kw, lib = _setup(monkeypatch, precision, integrator,
                                         compensated)
    capture, fn = StandIn(), _ONE[precision]
    graphs = chunking.ChunkGraphs(capture=capture)
    chunks = [(0, K), (K, 2 * K), (2 * K, 3 * K)]
    before, launches, addresses = _counts(), fn.launches, []
    for s0, s1 in chunks:
        fn(c, m0, m_half, fst, s0, s1, graphs=graphs, **kw)
        assert _slot_views(c)
        addresses.append(tuple(x.data_ptr() for x in ss._state(c)
                               if x is not None))
    R._equal(c, _plain(precision, integrator, compensated, chunks))
    assert len(set(addresses)) == 1
    pair = (c.slots[0].data_ptr(), c.slots[1].data_ptr())
    assert lib.chunks == [(s0, K) + pair for s0, _ in chunks]
    assert len(capture.bodies) == 1 and len(graphs.entries) == 1
    assert _counts() == (before[0] + 3, before[1] + 1)
    assert fn.launches - launches == 3 * (1 if precision != "tf3" else
                                         K + 1)


def test_tail_chunk_captures_anew(monkeypatch):
    """Chunks of 7 steps reuse one graph; a shorter chunk captures its
    own, and the chunks of 7 after it replay the first again."""
    c, m0, m_half, fst, kw, lib = _setup(monkeypatch, "f64", "euler", False)
    capture = StandIn()
    graphs = chunking.ChunkGraphs(capture=capture)
    for s0, s1, made in [(0, 7, 1), (7, 14, 1), (14, 17, 2), (17, 24, 2),
                         (24, 31, 2)]:
        ss.sim_chunk_f64(c, m0, m_half, fst, s0, s1, graphs=graphs, **kw)
        assert len(capture.bodies) == made
    R._equal(c, _plain("f64", "euler", False, [(0, 31)]))


@pytest.mark.parametrize("change", ["integrator", "compensated", "dist3"])
def test_a_changed_variant_captures_anew(monkeypatch, change):
    """The integrator, the compensation and dist3 are in the key: on one
    carry, whose slots stay where they are, a chunk of the other variant
    captures its own graph and runs it (the stand-in runs the variant it
    is called with), bitwise the plain chunks making the same change."""
    c, m0, m_half, fst, kw, lib = _setup(monkeypatch, "f64", "euler", False)
    capture = StandIn()
    graphs = chunking.ChunkGraphs(capture=capture)
    ss.sim_chunk_f64(c, m0, m_half, fst, 0, 5, graphs=graphs, **kw)
    want = _plain("f64", "euler", False, [(0, 5)])
    slots = c.slots.data_ptr()
    kw2 = dict(kw)
    for x in (c, want):
        if change == "integrator":
            x.a = torch.zeros_like(x.q)
            kw2["integrator"] = "leapfrog"
        elif change == "compensated":
            x.qc, x.vc = torch.zeros_like(x.q), torch.zeros_like(x.v)
            kw2["compensated"] = True
        else:
            kw2["dist3_mode"] = "sqrt3"
    ss.sim_chunk_f64(c, m0, m_half, fst, 5, 10, graphs=graphs, **kw2)
    ss.sim_chunk_f64_ref(want, m0, m_half, fst, 5, 10, **kw2)
    assert len(capture.bodies) == 2 and c.slots.data_ptr() == slots
    R._equal(c, want)


def test_direct_call_without_graphs(monkeypatch):
    """A caller that passes no graphs (scripts/bench, a new carry each
    repeat) gets one direct C call a chunk on a fresh pair of buffers:
    no capture, no replay, the carry's own slots untouched, bitwise the
    plain chunks."""
    c, m0, m_half, fst, kw, lib = _setup(monkeypatch, "f32", "leapfrog",
                                         True)
    before, launches = _counts(), ss.sim_chunk_f32.launches
    for s0, s1 in [(0, 5), (5, 10)]:
        ss.sim_chunk_f32(c, m0, m_half, fst, s0, s1, **kw)
    assert _counts() == before and c.slots is None
    assert ss.sim_chunk_f32.launches - launches == 2
    assert [call[:2] for call in lib.chunks] == [(0, 5), (5, 5)]
    R._equal(c, _plain("f32", "leapfrog", True, [(0, 10)]))


@pytest.mark.parametrize("n_steps,chunk,want", [
    (12, 5, [(0, 5, True), (5, 10, True), (10, 12, False)]),
    (10, 10, [(0, 10, False)]),
    (10, 20, [(0, 10, False)]),
    (20, 10, [(0, 10, True), (10, 20, True)]),
    (11, 5, [(0, 5, True), (5, 10, True), (10, 11, False)]),
    (0, 5, []),
])
def test_plan_captures_only_a_repeated_length(n_steps, chunk, want):
    assert _plan(n_steps, chunk) == want


@pytest.mark.parametrize("precision,integrator", [
    ("f64", "euler"), ("f64", "leapfrog"), ("f32", "euler"),
    ("f32", "leapfrog"), ("tf3", "euler"), ("tf3", "leapfrog")])
def test_simulate_through_the_graph_path_bitwise_plain(monkeypatch,
                                                       precision,
                                                       integrator):
    """simulate() with its chunks through the graph path (stand-in capture
    and library): bitwise the plain path; over 12 steps in chunks of 5 one
    capture and two replays (the chunks of 5) and one direct call (the
    tail of 2); a run of one chunk captures nothing."""
    scene = W.fuzz_scene(103, 20, 3)
    want = simulate(scene, n_steps=12, precision=precision, device="cpu",
                    integrator=integrator, chunk=5)
    sim_module = sys.modules["nbody_tpu_torch.simulate"]
    cfg = DEFAULT_CONFIG
    if precision == "f32":   # the kernels see the rescaled scene's eps
        cfg = compute_rescale(scene, eps=cfg.eps).apply_cfg(cfg)
    lib = FakeLib(cfg.eps)
    monkeypatch.setattr(sim_module, "ChunkGraphs",
                        lambda: chunking.ChunkGraphs(capture=StandIn()))
    got = {}
    for chunk in (5, 12):
        with monkeypatch.context() as mp:
            W.fake_kernels(mp.setattr, lib)
            before = _counts()
            lib.chunks.clear()
            got[chunk] = simulate(scene, n_steps=12, precision=precision,
                                  device="cpu", integrator=integrator,
                                  chunk=chunk)
            counts = tuple(a - b for a, b in zip(_counts(), before))
        assert counts == ((2, 1) if chunk == 5 else (0, 0))
        assert [k for _, k, _, _ in lib.chunks] == \
            ([5, 5, 2] if chunk == 5 else [12])
        for name in ("q", "v", "q_lo", "v_lo"):
            a, b = getattr(got[chunk], name), getattr(want, name)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, b), (chunk, name)


def test_replay_raises_on_a_failed_launch(monkeypatch):
    """A launch error raises from the replay and counts no launch."""
    c, m0, m_half, fst, kw, lib = _setup(monkeypatch, "f64", "euler", False)
    lib.sim_chunk_f64_launch = lambda *a: 1
    before = ss.sim_chunk_f64.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ss.sim_chunk_f64(c, m0, m_half, fst, 0, 5,
                         graphs=chunking.ChunkGraphs(capture=StandIn()), **kw)
    assert ss.sim_chunk_f64.launches == before


def test_capture_is_not_run_at_capture(monkeypatch):
    """The stand-in, like a CUDA graph capture, runs nothing when it
    captures: the chunk runs once, at its replay."""
    c, m0, m_half, fst, kw, lib = _setup(monkeypatch, "f64", "euler", False)
    graphs = chunking.ChunkGraphs(capture=lambda body: (lambda: None))
    ss.sim_chunk_f64(c, m0, m_half, fst, 0, 5, graphs=graphs, **kw)
    assert lib.chunks == []


# --- the mesh's row-range chunk ------------------------------------------

_ROWS = R._ROWS


def _rows_graph(monkeypatch, precision, integrator, compensated, chunks,
                blocks, gather=None, tile=128, graphs=None, state=None):
    """The rows chunks through the graph path on a CPU carry (FakeLib's
    emulated launches), or on `state` (carry, m0, m_half, fst) from an
    earlier call; returns the state, the library and the graphs."""
    inp = R._inputs(precision)
    state = state or R._tensors(inp, precision, integrator, compensated)
    c, m0, m_half, fst = state
    kw = dict(inp["kw"], integrator=integrator, compensated=compensated)
    if precision == "f32":
        kw["tile"] = tile
    lib = FakeLib(inp["kw"]["eps"])
    W.fake_kernels(monkeypatch.setattr, lib)
    graphs = graphs or chunking.ChunkGraphs(capture=StandIn())
    for s0, s1 in chunks:
        _ROWS[precision](c, m0, m_half, fst, s0, s1, blocks=blocks,
                         gather=gather, graphs=graphs, **kw)
    return state, lib, graphs


@pytest.mark.parametrize("K", [4, 5])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
def test_rows_graph_gathers_and_fixed_buffer(monkeypatch, integrator,
                                             compensated, K):
    """The mesh of one rank's captured chunk (one block, an in-place
    gather that records its buffers), three chunks of K: a pre-launch and
    a launch a step, a gather after every step but the last on the slot
    the next force reads of the buffer just written, the closing gather of
    the carry's slots into one fixed buffer; one capture, K + 1 launches a
    replay, the carry in its fixed slots, bitwise the plain chunks."""
    gathered = []
    chunks = [(0, K), (K, 2 * K), (2 * K, 3 * K)]
    blocks = Blocks(20, 1, (0,))
    before = ss.sim_rows_chunk_f64.launches
    (c, *_), lib, graphs = _rows_graph(
        monkeypatch, "f64", integrator, compensated, chunks, blocks,
        gather=lambda x: gathered.append((x.data_ptr(), tuple(x.shape))))
    assert len(graphs.entries) == 1 and _slot_views(c)
    assert ss.sim_rows_chunk_f64.launches - before == 3 * (K + 1)
    bufs = (c.slots[0], c.slots[1])
    pos = ss._SLOT_P if integrator == "leapfrog" else 0
    kept = 2 + (integrator == "leapfrog") + 2 * compensated
    for i in range(3):
        calls = lib.calls[i * (K + 1):(i + 1) * (K + 1)]
        assert [call[:4] for call in calls] == \
            [(0, i * K + 1, 0, True)] + \
            [(0, i * K + off, int(off < K), False) for off in range(1, K + 1)]
        assert [call[4:] for call in calls[1:]] == \
            [(bufs[(off - 1) & 1].data_ptr(), bufs[off & 1].data_ptr())
             for off in range(1, K + 1)]
        g = gathered[i * K:(i + 1) * K]
        assert g[:-1] == [(bufs[off & 1][pos].data_ptr(), (1, 20, 3))
                          for off in range(1, K)]
        assert g[-1][1] == (1, kept, 20, 3)
    assert len({g[0] for g in gathered[K - 1::K]}) == 1   # one fixed buffer
    R._equal(c, _plain("f64", integrator, compensated, chunks))


@pytest.mark.parametrize("change", ["tile", "blocks", "K"])
def test_rows_tile_blocks_and_k_capture_anew(monkeypatch, change):
    """The float32 mesh's tile, the blocks and K are in the key: one
    capture for two chunks, a second for the chunks after the change,
    bitwise the plain chunks."""
    state, lib, graphs = _rows_graph(monkeypatch, "f32", "euler", True,
                                     [(0, 4), (4, 8)], Blocks(20, 2, (0, 1)))
    assert len(graphs.entries) == 1
    tile = 5 if change == "tile" else 128
    blocks = Blocks(20, 4, (0, 1, 2, 3)) if change == "blocks" else \
        Blocks(20, 2, (0, 1))
    chunks = [(8, 11), (11, 14)] if change == "K" else [(8, 12), (12, 16)]
    _rows_graph(monkeypatch, "f32", "euler", True, chunks, blocks,
                tile=tile, graphs=graphs, state=state)
    assert len(graphs.entries) == 2
    inp = R._inputs("f32")
    want, m0, m_half, fst = R._tensors(inp, "f32", "euler", True)
    for s0, s1, t in [(0, 8, 128), (8, chunks[-1][1], tile)]:
        ss.sim_rows_chunk_f32_ref(want, m0, m_half, fst, s0, s1,
                                  blocks=Blocks(20, 1, (0,)), tile=t,
                                  integrator="euler", compensated=True,
                                  **inp["kw"])
    R._equal(state[0], want)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_rows_graph_on_gloo_ranks(shape):
    """The graph path on gloo ranks with the real in-place all_gather
    inside the stand-in's captured body: every rank ends with the eager
    loop's whole carry over three chunks of 7 and one of 5 (a capture for
    each length on every rank)."""
    chunks = [(0, 7), (7, 14), (14, 21), (21, 26)]
    jobs, want = [], {}
    for precision, tile in (("f64", 128), ("f32", 5)):
        inp = R._inputs(precision)
        for integrator, compensated in VARIANTS:
            label = f"{precision}/{integrator}/{compensated}"
            kw = dict(inp["kw"], integrator=integrator,
                      compensated=compensated)
            if precision == "f32":
                kw["tile"] = tile
            a = inp["a"] if integrator == "leapfrog" else None
            jobs.append((label, inp["q"], inp["v"], a, inp["m0"],
                         inp["m_half"], inp["fst"], chunks, kw))
            c, m0, m_half, fst = R._tensors(inp, precision, integrator,
                                            compensated)
            ref = R.F.ring_force(tile, inp["kw"]["eps"]) \
                if precision == "f32" else None
            ss.eager_chunk(c, m0, m_half, fst.tolist(), 0, chunks[-1][1],
                           compensated=compensated,
                           force=None if ref is None else
                           (lambda q, gm, ref=ref: ref(q[None], gm[None])[0]),
                           **dict(inp["kw"], integrator=integrator))
            want[label] = (precision, c)
    for precision in ("f64", "f32"):
        its = [job for job in jobs if want[job[0]][0] == precision]
        out = run_ranks(W.sim_rows_emulated, int(np.prod(shape)),
                        ({"scen": shape[0], "body": shape[1]}, precision,
                         its, True), timeout=120)
        for rank in out:
            for label, (got, captures) in rank.items():
                assert captures == 2, label
                c = want[label][1]
                for name, x in zip(("q", "v", "a", "qc", "vc"), got):
                    y = getattr(c, name)
                    assert (x is None) == (y is None), (label, name)
                    if x is not None:
                        np.testing.assert_array_equal(x, y.numpy(),
                                                      err_msg=label)


# --- on a card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "f64-sqrt3", "f32", "tf3"])
def test_sim_graph_replay_bitwise_direct_call_on_card(cuda, precision):
    import chip_smoke

    precision, _, dist3 = precision.partition("-")
    for rec in chip_smoke.check_sim_graphs(precision, dist3 or "dsqrt"):
        assert not rec["differ"], rec
