"""simulate's step on the mesh: ops/sim_step `sim_rows_chunk_f64`,
`sim_rows_chunk_f32` and `sim_rows_chunk_dd`, the row-range form of the
step kernels, on the CPU and on a card.

Every rank holds the whole carry; a step updates the rank's rows (its
block of an equal split, ni = ceil(n / k)) and gathers the positions the
next step's force reads; float32 sums the force in the mesh's ordered
order at a tile T (B2's own at T = 128).

On the CPU, on the fuzz scene of n = 20 (fuzz seed 103, rescaled for
float32), 40 steps in chunks of 7 and 33, Euler and leapfrog, Kahan on
and off (binary64, float32):
  * the plain versions over k = 1 to 4 blocks in one process bitwise the
    one-device eager loop (`eager_chunk`, `eager_chunk_dd`); float32 at
    T = 5 and 24 bitwise the eager loop around the eager ordered ring
    (sources padded with zero-mass bodies to a multiple of T,
    test_torch_mesh_step_f32.ring_force);
  * the host loop around the kernels (the slots, the ping-pong pair, the
    pre-launch, the gathers and the carry read back) with the kernels
    emulated in PyTorch ops (torch_mesh_workers.FakeSimLib): over k
    blocks in one process, and on gloo ranks of 1x2, 1x3 and 2x2 meshes
    with the real in-place all_gather, bitwise the eager loop; one
    pre-launch a chunk and one launch a step and block;
  * the refusals.
On a card (skipped here): each row-range kernel over k = 1 to 4 blocks
bitwise its plain version on the card and (float32 at T = 128) the
one-device step kernel; on the card's machine:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sim_rows.py
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import ddfloat as ddf
from nbody_tpu_torch.ops import sim_step as ss
from nbody_tpu_torch.ops.chunking import Blocks
from nbody_tpu_torch.parallel.spawn import run_ranks
from nbody_tpu_torch.physics import oscillation_table
from nbody_tpu_torch.utils.rescale import compute_rescale
import test_torch_mesh_step_f32 as F
import torch_mesh_workers as W

STEPS = 40
CHUNKS = [(0, 7), (7, STEPS)]
VARIANTS = [("euler", False), ("euler", True), ("leapfrog", False),
            ("leapfrog", True)]


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


def _inputs(precision: str, n: int = 20) -> dict:
    """Host arrays of simulate's inputs on the fuzz scene (seed 103), as
    simulate builds them (rescaled for f32), and a leapfrog seed a."""
    scene = W.fuzz_scene(103, n, 3)
    cfg = SimConfig(n_steps=STEPS)
    if precision == "f32":
        rs = compute_rescale(scene, eps=cfg.eps)
        scene, cfg = rs.apply_scene(scene), rs.apply_cfg(cfg)
    np_dtype = np.float32 if precision == "f32" else np.float64
    mask = scene.device_mask()
    a = np.random.RandomState(5).randn(n, 3) * np.abs(scene.v).max() * 1e-4
    cast = (lambda x: np.asarray(x, np_dtype))
    return {"q": cast(scene.q), "v": cast(scene.v), "a": cast(a),
            "m0": cast(scene.m), "m_half": cast(0.5 * scene.m * mask),
            "fst": oscillation_table(cfg, STEPS).astype(np_dtype),
            "kw": {"G": cfg.G, "eps": cfg.eps, "dt": cfg.dt}}


def _tensors(inp: dict, precision: str, integrator: str, compensated: bool,
             device="cpu"):
    """(carry, m0, m_half, fst) as the chunk functions take them."""
    dd = precision == "tf3"

    def t(x):
        return (ddf.from_f64(x) if dd else torch.from_numpy(x.copy())).to(
            device)

    c = ss.SimCarry(t(inp["q"]), t(inp["v"]))
    if integrator == "leapfrog":
        c.a = t(inp["a"])
    if compensated:
        c.qc, c.vc = torch.zeros_like(c.q), torch.zeros_like(c.v)
    fst = torch.from_numpy(inp["fst"]).to(device)
    return c, t(inp["m0"]), t(inp["m_half"]), fst


def _eager(precision: str, integrator: str, compensated: bool,
           tile: int = 128) -> ss.SimCarry:
    """The one-device eager loop (float32 at a tile other than 128:
    around the eager ordered ring) over CHUNKS."""
    inp = _inputs(precision)
    c, m0, m_half, fst = _tensors(inp, precision, integrator, compensated)
    kw = dict(inp["kw"], integrator=integrator)
    force = None
    if precision == "f32" and tile != 128:
        ring = F.ring_force(tile, inp["kw"]["eps"])

        def force(q, gm):
            return ring(q[None], gm[None])[0]
    for s0, s1 in CHUNKS:
        if precision == "tf3":
            ss.eager_chunk_dd(c, m0, m_half, fst.tolist(), s0, s1, **kw)
        else:
            ss.eager_chunk(c, m0, m_half, fst.tolist(), s0, s1,
                           compensated=compensated, force=force, **kw)
    return c


_ROWS = {"f64": ss.sim_rows_chunk_f64, "f32": ss.sim_rows_chunk_f32,
         "tf3": ss.sim_rows_chunk_dd}


def _rows(precision: str, integrator: str, compensated: bool, k: int,
          tile: int = 128, device="cpu") -> ss.SimCarry:
    """The row-range chunks over k blocks in one process over CHUNKS."""
    inp = _inputs(precision)
    c, m0, m_half, fst = _tensors(inp, precision, integrator, compensated,
                                  device)
    kw = dict(inp["kw"], integrator=integrator)
    if precision != "tf3":
        kw["compensated"] = compensated
    if precision == "f32":
        kw["tile"] = tile
    blocks = Blocks(c.q.shape[0], k, tuple(range(k)))
    for s0, s1 in CHUNKS:
        _ROWS[precision](c, m0, m_half, fst, s0, s1, blocks=blocks, **kw)
    return c


def _equal(got: ss.SimCarry, want: ss.SimCarry) -> None:
    for name in ("q", "v", "a", "qc", "vc"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a.cpu(), b.cpu()), name


def _params():
    out = [(p, i, c, k) for p in ("f64", "f32") for i, c in VARIANTS
           for k in (1, 2, 3, 4)]
    out += [("tf3", i, False, k) for i in ("euler", "leapfrog")
            for k in (1, 3, 4)]
    return out


@pytest.mark.parametrize("precision,integrator,compensated,k", _params())
def test_rows_plain_bitwise_eager_loop(precision, integrator, compensated,
                                       k):
    _equal(_rows(precision, integrator, compensated, k),
           _eager(precision, integrator, compensated))


@pytest.mark.parametrize("tile", [5, 24])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
@pytest.mark.parametrize("k", [1, 3])
def test_f32_rows_plain_at_a_tile_bitwise_the_ordered_ring(integrator,
                                                           compensated, k,
                                                           tile):
    _equal(_rows("f32", integrator, compensated, k, tile),
           _eager("f32", integrator, compensated, tile))


@pytest.mark.parametrize("precision,tile", [("f64", 128), ("f32", 128),
                                            ("f32", 5)])
@pytest.mark.parametrize("integrator,compensated", VARIANTS)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_rows_host_loop_with_emulated_kernels(monkeypatch, precision, tile,
                                              integrator, compensated, k):
    inp = _inputs(precision)
    lib = W.FakeSimLib(inp["kw"]["eps"])
    W.fake_kernels(monkeypatch.setattr, lib)
    fn = _ROWS[precision]
    before = fn.launches
    got = _rows(precision, integrator, compensated, k, tile)
    assert fn.launches - before == len(CHUNKS) + STEPS * k
    pre = [call for call in lib.calls if call[3]]
    assert [call[1] for call in pre] == [s0 + 1 for s0, _ in CHUNKS]
    _equal(got, _eager(precision, integrator, compensated, tile))


@pytest.mark.parametrize("shape", [(1, 2), (1, 3), (2, 2)])
def test_rows_host_loop_on_gloo_ranks(shape):
    """The real in-place all_gather over 'body' between the emulated
    launches, and the carry gathered at each chunk's end: every rank ends
    with the eager loop's whole carry."""
    jobs, want = [], {}
    for precision, tile in (("f64", 128), ("f32", 5)):
        inp = _inputs(precision)
        for integrator, compensated in VARIANTS:
            label = f"{precision}/{integrator}/{compensated}"
            kw = dict(inp["kw"], integrator=integrator,
                      compensated=compensated)
            if precision == "f32":
                kw["tile"] = tile
            a = inp["a"] if integrator == "leapfrog" else None
            jobs.append((label, inp["q"], inp["v"], a, inp["m0"],
                         inp["m_half"], inp["fst"], CHUNKS, kw))
            want[label] = (precision, _eager(precision, integrator,
                                             compensated, tile))
    by_precision = {}
    for job in jobs:
        by_precision.setdefault(want[job[0]][0], []).append(job)
    for precision, its in by_precision.items():
        out = run_ranks(W.sim_rows_emulated, int(np.prod(shape)),
                        ({"scen": shape[0], "body": shape[1]}, precision,
                         its), timeout=120)
        for rank in out:
            for label, got in rank.items():
                c = want[label][1]
                for name, x in zip(("q", "v", "a", "qc", "vc"), got):
                    y = getattr(c, name)
                    assert (x is None) == (y is None), (label, name)
                    if x is not None:
                        np.testing.assert_array_equal(x, y.numpy(),
                                                      err_msg=label)


def _refuse(**kw):
    inp = _inputs("f64")
    c, m0, m_half, fst = _tensors(inp, "f64", "euler", False)
    args = dict(inp["kw"], integrator="euler", compensated=False,
                blocks=Blocks(20, 2, (0, 1)))
    args.update(kw)
    ss.sim_rows_chunk_f64(c, m0, m_half, fst, 0, 1, **args)


@pytest.mark.parametrize("kw,match", [
    ({"blocks": Blocks(21, 2, (0, 1))}, "blocks"),
    ({"blocks": Blocks(20, 2, (0,))}, "gather"),
    ({"blocks": Blocks(20, 2, (0, 1)), "gather": print}, "gather"),
    ({"blocks": Blocks(20, 2, (0, 2))}, "block"),
    ({"blocks": Blocks(20, 0, ())}, "blocks"),
    ({"integrator": "rk4"}, "integrator"),
    ({"dist3_mode": "pow"}, "dist3_mode"),
])
def test_rows_chunk_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        _refuse(**kw)


@pytest.mark.parametrize("tile", [0, -1, 2.5])
def test_f32_rows_chunk_refuses_a_bad_tile(tile):
    inp = _inputs("f32")
    c, m0, m_half, fst = _tensors(inp, "f32", "euler", True)
    with pytest.raises(ValueError, match="tile"):
        ss.sim_rows_chunk_f32(c, m0, m_half, fst, 0, 1,
                              blocks=Blocks(20, 1, (0,)), tile=tile,
                              integrator="euler", compensated=True,
                              **inp["kw"])


def _card_params():
    out = [(p, i, c, k, 128) for p in ("f64", "f32") for i, c in VARIANTS
           for k in (1, 2, 3, 4)]
    out += [("f32", i, c, k, t) for i, c in VARIANTS for k in (1, 3)
            for t in (5, 200)]
    out += [("tf3", i, False, k, 128) for i in ("euler", "leapfrog")
            for k in (1, 2, 3, 4)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("precision,integrator,compensated,k,tile",
                         _card_params())
def test_rows_kernel_bitwise_plain_on_card(cuda, precision, integrator,
                                           compensated, k, tile):
    fn = _ROWS[precision]
    before = fn.launches
    got = _rows(precision, integrator, compensated, k, tile, cuda)
    torch.cuda.synchronize()
    assert fn.launches - before == len(CHUNKS) + STEPS * k
    inp = _inputs(precision)
    c, m0, m_half, fst = _tensors(inp, precision, integrator, compensated,
                                  cuda)
    kw = dict(inp["kw"], integrator=integrator)
    if precision != "tf3":
        kw["compensated"] = compensated
    if precision == "f32":
        kw["tile"] = tile
    ref = {"f64": ss.sim_rows_chunk_f64_ref, "f32": ss.sim_rows_chunk_f32_ref,
           "tf3": ss.sim_rows_chunk_dd_ref}[precision]
    for s0, s1 in CHUNKS:
        ref(c, m0, m_half, fst, s0, s1, blocks=Blocks(20, k, tuple(range(k))),
            **kw)
    _equal(got, c)
    if tile == 128:
        one = {"f64": ss.sim_chunk_f64, "f32": ss.sim_chunk_f32,
               "tf3": ss.sim_chunk_dd}[precision]
        c, m0, m_half, fst = _tensors(inp, precision, integrator,
                                      compensated, cuda)
        kw.pop("tile", None)
        for s0, s1 in CHUNKS:
            one(c, m0, m_half, fst, s0, s1, **kw)
        _equal(got, c)
