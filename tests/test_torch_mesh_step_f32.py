"""The float32 mesh's graded step, ops/graded_step `graded_rows_chunk` on
a float32 state, on the CPU and on a card.

A rank of the mesh computes the force on its own rows against every body
in the mesh's ordered sum at a tile T (one partial per group of T sources,
kernel B2's cross form, the partials added from 0 in ascending order: the
order of parallel/sharded.ring_accel_ordered and of the JAX package's
mesh), updates those rows and gathers them; every rank checks the whole
state (tests/test_torch_mesh_step.py has the layout and the helpers).

On the CPU (the plain version, over k = 1 to 4 row blocks one after
another in one process), on the rescaled fuzz scenes of
test_torch_mesh_step.py, 300 steps in two chunks:
  * at T = 128, bitwise the one-device plain chunk (kernel B2's own sum)
    on every carry: P1+P2 with both rows, across the P2 early exit, the
    roles split (P1 alone, P2 alone) and Problem 3, n = 20 and 33;
  * at T = 5, 7, 200 and 256 bitwise the eager ordered ring: the
    one-device plain chunk whose force pads the sources with zero-mass
    bodies to a multiple of T and adds B2's partial of each group of T in
    order, as the ring does on a padded sharded state; and at n = 300
    (40 steps), where a group of 200 or 256 spans sub-tiles of 128 and
    the last group is ragged;
  * the tile is refused below 1.
On a card (skipped without one): the float32 graded step kernel's
row-range form over k = 1 to 4 blocks, launched once a block and step,
bitwise its plain version on the card at T = 128, 200 and 256 and the
one-device kernel at T = 128 (n = 1024). On the card's machine:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mesh_step_f32.py
"""

import dataclasses

import pytest
import torch

from nbody_tpu_torch.ops import chunking
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.ops.accel_f32 import accel_f32
import test_torch_mesh_step as M

CASES = ("p12", "p12_exit", "p1", "p2", "p3")


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


def ring_force(tile: int, eps: float):
    """The eager ordered ring's force in one process: the sources padded
    with zero-mass bodies at the origin to a multiple of `tile`, B2's cross
    form (its plain version on the CPU) on each group of `tile`, the
    partials added from 0 in ascending order."""
    def force(q, gm):
        B, n = q.shape[:2]
        pad = -(-n // tile) * tile - n
        qp = torch.cat([q, q.new_zeros((B, pad, 3))], dim=1)
        gp = torch.cat([gm, gm.new_zeros((B, pad))], dim=1)
        acc = torch.zeros_like(q)
        for j in range(0, n + pad, tile):
            acc = acc + accel_f32(q, qp[:, j:j + tile].contiguous(),
                                  gp[:, j:j + tile].contiguous(), eps=eps)
        return acc
    return force


def ring_step(tile: int):
    """The plain chunks' step around the eager ordered ring's force."""
    def step(c, q, v, s):
        return gs._Native.step(c, q, v, s, force=ring_force(tile, c.eps))
    return step


_RING = {}


def _ring_reference(case: str, spec: tuple, tile: int) -> gs.Carry:
    key = (case, spec, tile)
    if key not in _RING:
        _RING[key] = M._run(M.CASES[case][0], spec, "f32",
                            torch.device("cpu"), step=ring_step(tile))
    return _RING[key]


def _params_128():
    out = [(case, k, n) for n in (20, 33) for case in ("p12", "p3")
           for k in (1, 2, 3, 4)]
    out += [(case, k, 20) for case in ("p12_exit", "p1", "p2")
            for k in (2, 3)]
    return out


@pytest.mark.parametrize("case,k,n", _params_128())
def test_f32_rows_chunk_at_tile_128_bitwise_one_device(case, k, n):
    spec = (M.SEED, n, M.DEVICES)
    cpu = torch.device("cpu")
    got = M._run(case, spec, "f32", cpu, k, tile=128)
    want = M._reference(M.CASES[case][0], spec, "f32", cpu)
    assert M._differ(case, got, want) == []


def _params_tiles():
    out = [(case, tile, k, 33) for tile in (5, 7) for case in CASES
           for k in (1, 3)]
    out += [(case, tile, k, 33) for tile in (200, 256)
            for case in ("p12", "p3") for k in (2, 4)]
    out += [("p12", 5, 4, 20), ("p3", 5, 2, 20), ("p2", 7, 4, 20)]
    return out


@pytest.mark.parametrize("case,tile,k,n", _params_tiles())
def test_f32_rows_chunk_at_a_tile_bitwise_the_ordered_ring(case, tile, k, n):
    spec = (M.SEED, n, M.DEVICES)
    got = M._run(case, spec, "f32", torch.device("cpu"), k, tile=tile)
    want = _ring_reference(case, spec, tile)
    assert M._differ(case, got, want) == []


@pytest.mark.parametrize("tile", [200, 256])
def test_f32_rows_chunk_groups_across_sub_tiles(monkeypatch, tile):
    """n = 300: a group of 200 (sub-tiles of 128 and 72) or 256 (two of
    128), the last group ragged (100 or 44 sources); 40 steps in two
    chunks over 3 blocks, bitwise the eager ordered ring."""
    monkeypatch.setattr(M, "STEPS", 40)
    monkeypatch.setattr(M, "CHUNKS", [(0, 15), (15, 40)])
    spec = (M.SEED, 300, M.DEVICES)
    got = M._run("p12", spec, "f32", torch.device("cpu"), 3, tile=tile)
    want = M._run("p12", spec, "f32", torch.device("cpu"),
                  step=ring_step(tile))
    assert M._differ("p12", got, want) == []


@pytest.mark.parametrize("tile", [0, -3, 2.0])
def test_f32_rows_chunk_refuses_a_bad_tile(tile):
    c = M._carry((M.SEED, 20, M.DEVICES), "f32", gs.P12,
                 torch.device("cpu"))
    c.q, c.v = chunking.to_blocks(c.q, c.v, 2), None
    with pytest.raises(ValueError, match="tile"):
        gs.graded_rows_chunk(gs.P12, c, 0, 1, chunking.Blocks(20, 2, (0, 1)),
                             tile=tile)


def _card_params():
    return [(case, tile, k) for case in ("p12", "p1", "p2", "p3")
            for tile in (128, 200, 256) for k in (1, 2, 3, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,tile,k", _card_params())
def test_f32_rows_kernel_bitwise_plain_and_one_device_on_card(cuda, case,
                                                              tile, k):
    spec = M.CARD_SCENES[1024]
    before = gs.graded_step_f32.launches
    got = M._run(case, spec, "f32", cuda, k, tile=tile)
    torch.cuda.synchronize()
    assert gs.graded_step_f32.launches - before == \
        k * M.STEPS + len(M.CHUNKS)
    mode = gs.P3 if case == "p3" else gs.P12
    plain = M._carry(spec, "f32", mode, cuda)
    roles = {"p1": (0, None), "p2": (None, 0)}.get(case)
    if roles is not None:
        M._keep(plain, [0 if case == "p1" else 1], False)
    plain.q, plain.v = chunking.to_blocks(plain.q, plain.v, k), None
    for s0, s1 in M.CHUNKS:
        gs._rows_ref(mode, plain, s0, s1,
                     chunking.Blocks(spec[1], k, tuple(range(k))), None,
                     roles or ((None, None) if mode == gs.P3 else
                               (0, 1)), tile)
    plain.q, plain.v = chunking.from_blocks(plain.q, spec[1])
    assert [f.name for f in dataclasses.fields(got)
            if isinstance(getattr(got, f.name), torch.Tensor)
            and not torch.equal(getattr(got, f.name),
                                getattr(plain, f.name))] == []
    if tile == 128:
        want = M._reference(M.CASES[case][0], spec, "f32", cuda)
        assert M._differ(case, got, want) == []
