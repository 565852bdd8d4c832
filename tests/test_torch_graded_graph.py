"""The graded chunk as one CUDA graph (ops/graded_step `ChunkGraphs`).

On a card a graded chunk is one replay of a graph captured from the C call
of its launches at the first chunk of its shape; the kernels read the
chunk's base step from a device word the host writes before each replay.
Here, on the CPU, the same host code runs with a stand-in capture (the
"replay" calls the captured body) and a stand-in kernel library
(`FakeGradedLib`): its `graded_chunk_*_launch` reads the carry's buffers
and the base-step word through their pointers, runs the plain chunk from
that step, and leaves the result where the kernels' contract puts it (the
state in (q, v) for an even K, in the second buffer for an odd one; the
arrivals in both arrival buffers); its `graded_rows_*_step` records each
launch and marks the rows it writes with its step. The tests hold:

  * the cache's key and reuse: one capture for successive chunks of one
    shape, a new one after the P2 early exit's B=2 -> 1, for a shorter tail
    chunk, and when dist3 (binary64) or the tile (float32, the mesh)
    changes;
  * the fixed buffers: the result lies in c.q, c.v and c.arr for odd and
    even K, and those keep their addresses across chunks;
  * the chunks bitwise the plain chunk, and the drivers' answers through
    the graph path bitwise the plain drivers';
  * the mesh's captured loop: a launch a block and a gather a step, the
    closing check, the result in c.q;
  * the launch, replay and capture counts.

On a card (marked `cuda`, skipped here) the replay is held bitwise against
a direct C call of the same chunk (`chip_smoke.check_graphs`):
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_graded_graph.py
"""

import ctypes
import dataclasses
import math
import os
import re

import numpy as np
import pytest
import torch

from nbody_tpu_torch import SimConfig, solve_scene
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import chunking
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.physics import oscillation_table

from test_torch_graded_step import STEPS, _carry, _fuzz, _grown

CPU = torch.device("cpu")
# the largest n and rows of a binary64 fused chunk that the library runs
# as one launch of its resident kernel (csrc/graded_step_f64.cu)
_F64 = open(os.path.join(_build.CSRC, "graded_step_f64.cu")).read()
RESIDENT_MAX_N = int(re.search(r"RESIDENT_MAX_N = (\d+);", _F64).group(1))
RES_MAX_ROWS = int(re.search(r"RES_MAX_ROWS = (\d+);", _F64).group(1))


def _view(ptr, shape: tuple, dtype) -> torch.Tensor:
    """The memory at ptr as a tensor of `shape` (the buffer itself)."""
    count = math.prod(shape)
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


class FakeGradedLib:
    """A stand-in for the kernel library's graded entry points on CPU
    tensors, for one carry's constants (module docstring). Its chunk calls
    write the launches they stand for into the host int they are given:
    one for a binary64 fused chunk of at most `resident_max_n` bodies and
    RES_MAX_ROWS rows (the resident kernel), else K + 1; the binary64 call
    also the step launches made as programmatic dependents into the int
    after it: none for the resident kernel, else K - 1."""

    resident_max_n = RESIDENT_MAX_N

    def __init__(self, c: gs.Carry):
        self.c = c
        self.chunks = []       # (s0, K) of each chunk call
        self.launches = []     # (s0, r0, off, check, qv, qv_out)

    def graded_chunk_f64_launch(self, *a):
        resident = (a[16] == gs.P123 and a[18] <= self.resident_max_n
                    and a[17] <= RES_MAX_ROWS)
        return self._chunk(*a[:21], *a[-4:], resident=resident,
                           dependents=True)

    def graded_chunk_f32_launch(self, *a):
        return self._chunk(*a[:21], *a[-4:])

    # B1''s launch-a-step geometry: one of the library's producers, at
    # every shape (its choice by shape is held on a card)
    geometry = (1, 8, 2, 64, 3)

    def graded_step_f64_geometry(self, B, n, ni, out):
        assert 1 <= ni <= n and B >= 1
        for k, x in enumerate(self.geometry):
            ctypes.c_int.from_address(out + 4 * k).value = x
        return 0

    def graded_chunk_dd_launch(self, *a):
        return self._chunk(*a[:21], *a[-4:])

    def _chunk(self, q, v, q2, v2, m0, mh, fst, md2, others, arr, arr2, hit,
               flag, min_d2, q_snap, v_snap, mode, B, n, D, planet, word, K,
               launched, stream, resident=False, dependents=False):
        c0 = self.c
        dt = c0.q.dtype
        tail = (2,) if gs.is_dd(c0.q) else ()
        s0 = int(_view(word, (1,), torch.int32)[0])
        self.chunks.append((s0, K))
        ctypes.c_int.from_address(launched).value = 1 if resident else K + 1
        if dependents:
            ctypes.c_int.from_address(launched + 4).value = \
                0 if resident else K - 1

        def real(p, shape):
            return _view(p, shape + tail, dt)

        def ints(p, shape):
            return _view(p, shape, torch.int64)

        rows = (B,) if mode == gs.P3 else (D,)
        if mode != gs.P3:
            assert torch.equal(ints(arr, rows), ints(arr2, rows))
        c = dataclasses.replace(
            c0, q=real(q, (B, n, 3)).clone(), v=real(v, (B, n, 3)).clone(),
            m0=real(m0, (B, n)), m_half=real(mh, (B, n)),
            fst=real(fst, (s0 + K + 1,)), others=ints(others, (D + 1,)),
            arr=ints(arr, rows).clone(), planet=planet, graphs=None)
        if mode == gs.P3:
            c.hit = _view(flag, (B,), torch.bool).clone()
        else:
            c.hit = ints(hit, ()).clone()
            c.md2 = real(md2, (s0 + K + 1,))
            c.min_d2 = real(min_d2, ()).clone()
        if mode == gs.P12:
            c.q_snap = real(q_snap, (D, n, 3)).clone()
            c.v_snap = real(v_snap, (D, n, 3)).clone()
        if mode == gs.P123:
            c.p3_hit = _view(flag, (D,), torch.bool).clone()
        gs._REF[mode](c, s0, s0 + K)
        out_q, out_v = (q, v) if K % 2 == 0 else (q2, v2)
        real(out_q, (B, n, 3)).copy_(c.q)
        real(out_v, (B, n, 3)).copy_(c.v)
        if mode == gs.P3:
            _view(flag, (B,), torch.bool).copy_(c.hit)
            return 0
        for p in (arr, arr2):        # the closing check leaves both
            ints(p, rows).copy_(c.arr)
        ints(hit, ()).copy_(c.hit)
        real(min_d2, ()).copy_(c.min_d2)
        if mode == gs.P12:
            real(q_snap, (D, n, 3)).copy_(c.q_snap)
            real(v_snap, (D, n, 3)).copy_(c.v_snap)
        else:
            _view(flag, (D,), torch.bool).copy_(c.p3_hit)
        return 0

    def graded_rows_f64_step(self, *a):
        return self._rows(a)

    def graded_rows_f32_step(self, *a):
        return self._rows(a)

    def graded_rows_dd_step(self, *a):
        return self._rows(a)

    def _rows(self, a):
        qv, qv_out, r0, word, off, check = a[-7:-1]
        B, ni, k = a[13], a[19], a[20]
        s0 = int(_view(word, (1,), torch.int32)[0])
        self.launches.append((s0, r0, off, check, qv, qv_out))
        if qv_out is not None:     # mark this launch's rows with its step
            out = _view(qv_out, (k, 2, B, ni, 3), self.c.q.dtype)
            out[r0 // ni] = s0 + off
        return 0


class StandIn:
    """A stand-in capture: it keeps the body, which each replay calls."""

    def __init__(self):
        self.bodies = []

    def __call__(self, body):
        self.bodies.append(body)
        return body


def _kernel(c: gs.Carry):
    return gs.graded_step_dd if gs.is_dd(c.q) else \
        gs.graded_step_f32 if c.q.dtype == torch.float32 \
        else gs.graded_step_f64


def _run(mode, c, chunks, lib=None, capture=None):
    """The graph path's chunks on a CPU carry; returns the capture."""
    capture = capture or StandIn()
    c.graphs = c.graphs or chunking.ChunkGraphs(capture=capture)
    lib = lib or FakeGradedLib(c)
    for s0, s1 in chunks:
        gs._check(mode, c, s0, s1)
        gs._replay_chunk(_kernel(c), mode, c, s0, s1, lib)
    return capture


def _tensor_fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), torch.Tensor)}


def _assert_bitwise(got, want):
    fields = _tensor_fields(want)
    assert set(_tensor_fields(got)) == set(fields)
    for name, x in fields.items():
        assert torch.equal(getattr(got, name), x), name


def _counts():
    return (chunking.GRAPHS.replays, chunking.GRAPHS.captures)


MODES = {"p12": gs.P12, "p3": gs.P3, "p123": gs.P123}
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.mark.parametrize("K", [6, 7])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("mode", ["p12", "p3", "p123"])
def test_chunks_in_place_and_bitwise_plain(mode, dtype, K):
    """Three successive chunks of K steps through one graph: c.q, c.v and
    c.arr hold the result at the addresses they had (the odd K's result
    copied back from the second buffer), bitwise the plain chunk's, with
    one capture, three replays and K + 1 launches a replay (one, the
    resident kernel's, for the binary64 fused chunk at n = 10)."""
    m = MODES[mode]
    got, want = _carry(m, DTYPES[dtype]), _carry(m, DTYPES[dtype])
    ptrs = {k: x.data_ptr() for k, x in _tensor_fields(got).items()}
    fn = _kernel(got)
    before, launches = _counts(), fn.launches
    chunks = [(0, K), (K, 2 * K), (2 * K, 3 * K)]
    lib = FakeGradedLib(got)
    capture = _run(m, got, chunks, lib)
    for s0, s1 in chunks:
        gs._REF[m](want, s0, s1)
    _assert_bitwise(got, want)
    assert {k: x.data_ptr() for k, x in _tensor_fields(got).items()} == ptrs
    assert lib.chunks == [(s0, K) for s0, _ in chunks]
    assert len(capture.bodies) == 1 and len(got.graphs.entries) == 1
    assert _counts() == (before[0] + 3, before[1] + 1)
    resident = (mode, dtype) == ("p123", "f64")
    assert fn.launches - launches == 3 * (1 if resident else K + 1)


def test_arrivals_stay_in_carry_across_parities():
    """A P1+P2 chunk of odd length that starts at an odd step, then one of
    even length: the arrivals (written by the checks into the buffer of
    each step's parity) are in c.arr at the end of each, bitwise the
    plain chunk's; the second buffer is the entry's own."""
    got, want = _carry(gs.P12), _carry(gs.P12)
    arr = got.arr
    for s0, s1 in [(0, 3), (3, 10), (10, 30), (30, 49)]:
        _run(gs.P12, got, [(s0, s1)])
        gs._REF[gs.P12](want, s0, s1)
        assert got.arr is arr
        assert torch.equal(got.arr, want.arr)
    assert (want.arr != -2).any()    # an arrival fell in these steps
    _assert_bitwise(got, want)


def test_one_capture_per_shape_and_a_new_one_for_a_tail():
    """Chunks on the grid of 7 steps reuse one graph; the shorter last
    chunk (n_steps not a multiple of 7) captures a second."""
    c = _carry(gs.P12)
    capture = _run(gs.P12, c, [(0, 7), (7, 14), (14, 21), (21, 28)])
    assert len(capture.bodies) == 1
    _run(gs.P12, c, [(28, 31)], capture=capture)
    assert len(capture.bodies) == 2
    _run(gs.P12, c, [(31, 38)], capture=capture)
    assert len(capture.bodies) == 2


def test_early_exit_captures_anew():
    """The P2 early exit keeps row 0 (views of the same memory): the
    graph of B=2 does not serve it; B=1 captures its own, bitwise the plain
    chunk's."""
    got, want = _carry(gs.P12), _carry(gs.P12)
    capture = _run(gs.P12, got, [(0, 10)])
    gs._REF[gs.P12](want, 0, 10)
    for c in (got, want):
        c.q, c.v, c.m0, c.m_half = (x[:1] for x in (c.q, c.v, c.m0,
                                                    c.m_half))
    q = got.q.data_ptr()
    _run(gs.P12, got, [(10, 20), (20, 30)], capture=capture)
    gs._REF[gs.P12](want, 10, 30)
    assert len(capture.bodies) == 2 and got.q.data_ptr() == q
    _assert_bitwise(got, want)


def test_dist3_change_captures_anew():
    """The binary64 force's dist3 form is in the key: sqrt3 captures its
    own graph, and the fake kernel runs the carry's form."""
    got, want = _carry(gs.P12), _carry(gs.P12)
    capture = _run(gs.P12, got, [(0, 5)])
    gs._REF[gs.P12](want, 0, 5)
    got.dist3 = want.dist3 = "sqrt3"
    _run(gs.P12, got, [(5, 10)], capture=capture)
    gs._REF[gs.P12](want, 5, 10)
    assert len(capture.bodies) == 2
    _assert_bitwise(got, want)


def test_new_buffers_capture_anew():
    """A carry tensor replaced by another (a restored checkpoint) is a new
    key: the old graph's addresses would be stale."""
    c = _carry(gs.P12)
    capture = _run(gs.P12, c, [(0, 5)])
    c.min_d2 = c.min_d2.clone()
    _run(gs.P12, c, [(5, 10)], capture=capture)
    assert len(capture.bodies) == 2


def test_dd_chunk_bitwise_plain():
    """A double-double carry through the graph path, odd and even K."""
    from nbody_tpu_torch.ops import ddfloat as ddf

    scene = _fuzz(5)
    cfg = SimConfig(n_steps=20)
    fst = oscillation_table(cfg)
    got, want = (ds._p12_carry(scene, fst, cfg, CPU, ddf.NAME)
                 for _ in range(2))
    _run(gs.P12, got, [(0, 3), (3, 7), (7, 10)])
    gs._REF[gs.P12](want, 0, 10)
    _assert_bitwise(got, want)


def test_replay_raises_on_a_failed_launch():
    """A launch error raises from the replay and counts no launch."""
    c = _carry(gs.P12)
    lib = FakeGradedLib(c)
    lib.graded_chunk_f64_launch = lambda *a: 1
    before = gs.graded_step_f64.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _run(gs.P12, c, [(0, 5)], lib=lib)
    assert gs.graded_step_f64.launches == before


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("chunk", [7, 2000])
def test_drivers_through_the_graph_path_bitwise_plain(monkeypatch, dtype,
                                                      chunk):
    """The three drivers with every chunk through the graph path (stand-in
    capture, emulated kernels): answers bitwise the plain drivers', a
    replay a chunk, and a capture for each chunk shape: the fused solve
    (n=10) and the phased one (n=140: P1+P2, the P2 early exit, Problem
    3)."""
    captures = []

    def chunk_fn(mode, c, s0, s1):
        gs._check(mode, c, s0, s1)
        if c.graphs is None:
            c.graphs = chunking.ChunkGraphs(capture=StandIn())
            captures.append(c.graphs)
        gs._replay_chunk(_kernel(c), mode, c, s0, s1, FakeGradedLib(c))

    for scene, n_steps in ((_fuzz(5), STEPS), (_grown(79, 140), 120)):
        cfg = SimConfig(n_steps=n_steps, chunk_steps=chunk)
        want = solve_scene(scene, cfg, precision=dtype, device="cpu")
        with monkeypatch.context() as mp:
            mp.setattr(ds, "graded_chunk", chunk_fn)
            before = _counts()
            got = solve_scene(scene, cfg, precision=dtype, device="cpu")
            replays, made = (a - b for a, b in zip(_counts(), before))
        assert np.float64(got.min_dist).tobytes() == \
            np.float64(want.min_dist).tobytes()
        assert got.as_tuple()[1:] == want.as_tuple()[1:]
        shapes = sum(len(g.entries) for g in captures)
        assert made == shapes and 1 <= shapes <= replays
        if chunk == 2000:        # one chunk a driver run
            assert replays == shapes
        captures.clear()


# --- the mesh's row-range chunk ------------------------------------------

def _rows_carry(dtype=torch.float64, k: int = 2):
    c = _carry(gs.P12, dtype)
    n = c.q.shape[1]
    c.q, c.v = chunking.to_blocks(c.q, c.v, k), None
    return c, chunking.Blocks(n, k, tuple(range(k)))


def _run_rows(c, blocks, chunks, lib, capture, gather=None, tile=128,
              mine=None):
    c.graphs = c.graphs or chunking.ChunkGraphs(capture=capture)
    b = blocks if mine is None else dataclasses.replace(blocks, mine=mine)
    for s0, s1 in chunks:
        gs._replay_rows(_kernel(c), gs.P12, c, s0, s1, b, gather, (0, 1),
                        tile, lib)


@pytest.mark.parametrize("K", [4, 5])
def test_rows_graph_replays_the_per_step_loop(K):
    """The captured loop of a mesh rank over three chunks of K steps: a
    launch on each of the blocks a step (the ping-pong buffers c.q and the
    entry's own), the gather after each step on the buffer just written,
    one closing check on the last, and the last step's rows in c.q at its
    address; one capture, and K * blocks + 1 launches a replay."""
    c, blocks = _rows_carry()
    q = c.q.data_ptr()
    lib, capture = FakeGradedLib(c), StandIn()
    before = gs.graded_step_f64.launches
    chunks = [(0, K), (K, 2 * K), (2 * K, 3 * K)]
    _run_rows(c, blocks, chunks, lib, capture)
    assert len(capture.bodies) == 1
    assert gs.graded_step_f64.launches - before == 3 * (2 * K + 1)
    bufs = [q, lib.launches[0][5]]      # c.q and the entry's own buffer
    assert bufs[1] != q
    for i, (s0, _) in enumerate(chunks):
        calls = lib.launches[i * (2 * K + 1):(i + 1) * (2 * K + 1)]
        want = [(s0, r * blocks.ni, off, int(off > 1),
                 bufs[(off - 1) & 1], bufs[off & 1])
                for off in range(1, K + 1) for r in range(2)]
        want.append((s0, 0, K, 0, bufs[K & 1], None))
        assert calls == want
    assert c.q.data_ptr() == q
    assert torch.equal(c.q, torch.full_like(c.q, 3 * K))


def test_rows_gather_after_each_step():
    """With a rank's own block and a gather: one gather a step, on the
    buffer the step wrote."""
    c, blocks = _rows_carry()
    lib, gathered = FakeGradedLib(c), []
    _run_rows(c, blocks, [(0, 3)], lib, StandIn(), mine=(0,),
              gather=lambda x: gathered.append(x.data_ptr()))
    outs = [call[5] for call in lib.launches if call[5] is not None]
    assert gathered == outs and len(outs) == 3


def test_rows_tile_and_k_capture_anew():
    """The float32 mesh's tile and the chunk's K are in the key."""
    c, blocks = _rows_carry(torch.float32)
    lib, capture = FakeGradedLib(c), StandIn()
    _run_rows(c, blocks, [(0, 4), (4, 8)], lib, capture)
    assert len(capture.bodies) == 1
    _run_rows(c, blocks, [(8, 12)], lib, capture, tile=200)
    assert len(capture.bodies) == 2
    _run_rows(c, blocks, [(12, 15)], lib, capture, tile=200)
    assert len(capture.bodies) == 3
    assert [call[0] for call in lib.launches if call[5] is None] == \
        [0, 4, 8, 12]


def test_capture_is_not_run_at_capture():
    """The stand-in, like a CUDA graph capture, runs nothing when it
    captures: the chunk runs once, at its replay."""
    c = _carry(gs.P12)
    lib = FakeGradedLib(c)
    c.graphs = chunking.ChunkGraphs(capture=lambda body: (lambda: None))
    gs._replay_chunk(gs.graded_step_f64, gs.P12, c, 0, 5, lib)
    assert lib.chunks == []


# --- on a card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "f64-sqrt3", "f32", "tf3"])
def test_graph_replay_bitwise_direct_call_on_card(cuda, precision):
    import chip_smoke

    precision, _, dist3 = precision.partition("-")
    for rec in chip_smoke.check_graphs(precision, dist3 or "dsqrt"):
        assert not rec["differ"], rec
