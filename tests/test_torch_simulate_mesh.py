"""`simulate(mesh=..., tile=...)` of the port over gloo ranks on the CPU:
the contracts of the JAX package's tests/test_simulate_mesh.py.

  * binary64 ('f64', Euler and leapfrog): bitwise the one-device run
    (each rank folds its rows through kernel B1's cross form; the JAX
    package's f64 mesh agrees with its one device to 1e-12), and within
    1e-12 of the JAX package's f64 mesh run;
  * 'f32' at a pinned tile: bitwise the same on every mesh shape, Kahan
    compensation on (the default) and off; at the default tile 128
    bitwise the one-device run; within 1e-5 of the JAX package's f32 mesh
    run; and over 600 steps the compensated run tracks the f64 trajectory
    at least as well as the plain one;
  * 'tf3' (Euler and leapfrog): bitwise the one-device run, q_lo too;
  * on_chunk with devices off: rank 0 sees every chunk, the others none;
  * compensated accumulation with an extended precision, and a tile
    without a mesh, are refused.

Shapes: 1x1, 1x2, 1x4 and 2x2, one group of ranks each.
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch import SimConfig, simulate
from nbody_tpu_torch.parallel.spawn import run_ranks
import torch_mesh_workers as W

SHAPES = [(1, 1), (1, 2), (1, 4), (2, 2)]
TILE = 5
LONG = 600              # the Kahan study's horizon
TIMEOUT = 120
CFG = SimConfig()


def _scene():
    return W.fuzz_scene(103, 20, 3)


def _jobs(shape):
    s = _scene()
    jobs = [(f"f64/{i}", s, dict(n_steps=40, chunk=16, integrator=i))
            for i in ("euler", "leapfrog")]
    jobs += [(f"tf3/{i}", s, dict(n_steps=20, chunk=20, precision="tf3",
                                  integrator=i))
             for i in ("euler", "leapfrog")]
    jobs += [("f32/tile", s, dict(n_steps=30, chunk=30, precision="f32",
                                  tile=TILE)),
             ("f32/plain", s, dict(n_steps=30, chunk=30, precision="f32",
                                   tile=TILE, compensated=False)),
             ("f64/off", s, dict(n_steps=30, chunk=10, devices_on=False))]
    if shape in ((1, 1), (1, 2)):
        jobs.append(("f32/128", s, dict(n_steps=30, chunk=30,
                                        precision="f32")))
    if shape == (1, 4):
        jobs += [(f"f32/long/{c}", s, dict(n_steps=LONG, chunk=300,
                                           precision="f32", tile=TILE,
                                           compensated=c))
                 for c in (True, False)]
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for shape in SHAPES:
        out[shape] = run_ranks(
            W.simulate_jobs, shape[0] * shape[1],
            ({"scen": shape[0], "body": shape[1]}, _jobs(shape)),
            workdir=str(tmp_path_factory.mktemp("sim")), timeout=TIMEOUT)
    return out


@pytest.fixture(params=SHAPES, ids=[f"{s}x{b}" for s, b in SHAPES])
def ranks(request, runs):
    return runs[request.param]


@pytest.fixture(scope="module")
def one_device():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for label, s, kw in _jobs((1, 1)):
            kw = {k: v for k, v in kw.items() if k != "tile"}
            st = simulate(s, CFG, device="cpu", **kw)
            out[label] = (st.q, st.v, st.q_lo)
        return out
    finally:
        torch.set_num_threads(n)


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    if a[2] is not None or b[2] is not None:
        np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("label", ["f64/euler", "f64/leapfrog", "f64/off",
                                   "tf3/euler", "tf3/leapfrog"])
def test_bitwise_equal_to_one_device(ranks, one_device, label):
    for r in ranks:
        _equal(r[label], one_device[label])


@pytest.mark.parametrize("label", ["f32/tile", "f32/plain"])
def test_f32_bitwise_the_same_on_every_shape(ranks, runs, label):
    for r in ranks:
        _equal(r[label], runs[(1, 1)][0][label])


def test_f32_at_tile_128_bitwise_equal_to_one_device(runs, one_device):
    for shape in ((1, 1), (1, 2)):
        for r in runs[shape]:
            _equal(r["f32/128"], one_device["f32/128"])


def test_on_chunk_on_rank_0_alone(ranks):
    assert ranks[0]["f64/off"][3] == [10, 20, 30]
    assert all(r["f64/off"][3] == [] for r in ranks[1:])


def test_f32_kahan_tracks_f64_at_least_as_well(runs):
    comp = runs[(1, 4)][0]["f32/long/True"][0]
    plain = runs[(1, 4)][0]["f32/long/False"][0]
    ref = simulate(_scene(), CFG, n_steps=LONG, chunk=300, device="cpu").q
    scale = np.abs(ref).max()
    err_comp = np.abs(comp - ref).max() / scale
    err_plain = np.abs(plain - ref).max() / scale
    assert err_comp <= err_plain * 1.05
    assert err_comp < 1e-5


@pytest.fixture(scope="module")
def jax_mesh():
    from nbody_tpu.io import Scene as JaxScene
    from nbody_tpu.parallel import make_mesh
    from nbody_tpu.simulate import simulate as jax_simulate

    s = JaxScene(**W.scene_fields(_scene()))
    mesh = make_mesh({"body": 4})
    return {"f64/euler": jax_simulate(s, n_steps=40, chunk=16, mesh=mesh,
                                      tile=TILE),
            "f32/tile": jax_simulate(s, n_steps=30, chunk=30,
                                     precision="f32", mesh=mesh, tile=TILE)}


@pytest.mark.parametrize("label,rtol", [("f64/euler", 1e-12),
                                        ("f32/tile", 1e-5)])
def test_against_jax_mesh(runs, jax_mesh, label, rtol):
    got, want = runs[(1, 4)][0][label], jax_mesh[label]
    np.testing.assert_allclose(got[0], want.q, rtol=rtol)
    np.testing.assert_allclose(got[1], want.v, rtol=rtol,
                               atol=rtol * np.abs(want.v).max())


@pytest.mark.parametrize("precision", ["tf3", "ddp", "dd+", "dd", "e64"])
def test_compensated_extended_refused_on_the_mesh(precision):
    with pytest.raises(ValueError, match="compensated"):
        simulate(_scene(), n_steps=4, chunk=4, precision=precision,
                 mesh=object(), tile=TILE, compensated=True)


def test_tile_without_a_mesh_refused():
    with pytest.raises(ValueError, match="mesh"):
        simulate(_scene(), n_steps=4, device="cpu", tile=TILE)

