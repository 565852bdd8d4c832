"""simulate()'s binary64 path with the KDK leapfrog, held to the plain
direct-difference reference `benchmark/reference/plummer_kdk.py` (which
imports nothing of the port), on seeded Plummer spheres.

Here, on the CPU, the tests hold:

  * simulate(precision='f64', integrator='leapfrog') at n = 64 and 600, in
    chunks of 7 and 25, bitwise the reference's serial mode: both take the
    spec program's expression, folded over ascending j, and the port's
    plain version is bitwise its card kernel; Euler too;
  * chunk invariance: chunks of 7 and 25 give the same bits;
  * the reference's block mode (blocks of rows, each row's terms summed by
    torch.sum) within a tenth of the cell's limits of its serial mode, on
    ragged blocks;
  * the control, the reference marched in float32, fails the cell's
    limits;
  * the reference's Euler mode against `reference/plummer.march` (whose
    force loses some 1e-12 of a pair's force to cancellation) over 5
    steps, within a limit that cancellation sets;
  * on a two-body circular orbit the port's KDK energy error stays bounded
    over three orbits and falls as dt^2;
  * a call's record holds one `seed` span for the leapfrog and none for
    Euler; `sim_row_steps` counts n x steps under its precision and the
    form that the one-device C call reports, a launch a step under the
    geometry the library reports (through the stand-in library of
    tests/test_torch_sim_graph), and nothing for the plain versions;
  * each geometry of the Blocked step can be forced by an edit of a copy
    of its source (chip_smoke.py phase 18);
  * the cell `plummer-n65536-f64-leapfrog`'s traffic at a tiny size through
    the harness: `correct`, the work with the seed, the seed's reader;
    `correct` false with half the sources left out of the force.

On a card (marked `cuda`, skipped here): `sim_chunk_f64` through
simulate() with KDK at n = 512 (one persistent launch a chunk), 513 and
4096 (a launch a step of the Blocked form), 50 steps in chunks of 25,
bitwise the reference's serial mode on the card, each counted under its
form; the block mode against the serial mode at n = 4096; each geometry
of the Blocked step forced, and the library's choice, bitwise the plain
chunk at n = 513 and 16384 in every variant, dsqrt and sqrt3; the mesh's
row-range form at world size 1 bitwise one device there:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sim_f64_kdk.py
"""

import functools
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.cells import Bench
from benchmark.reference import plummer, plummer_kdk, scenes
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.io import Scene
from nbody_tpu_torch.simulate import simulate
from nbody_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "plummer-n65536-f64-leapfrog"
with open(os.path.join(ROOT, "benchmark", "workloads", CELL + ".json")) as f:
    LIMITS = json.load(f)["limits"]
with open(os.path.join(ROOT, "benchmark", "configs",
                       "plummer-f64-leapfrog.json")) as f:
    CONSTANTS = json.load(f)["constants"]
STEPS = 30
SEED = 2 ** 31 + 4099          # more than 32 signed bits hold
# the Euler references' gap: plummer.accel's cancellation costs some 1e-12
# of a pair's force; over 5 steps the velocities' own rounding (a step
# changes a velocity by some 1e-5 of itself) hides most of it, so a
# hundred times that bounds both gaps
EULER_GAP = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**more) -> dict:
    c = CONSTANTS
    return {"G": c["G"], "eps": c["eps"], "dt": c["dt"], **more}


@functools.lru_cache(maxsize=None)
def _sphere(n: int) -> tuple:
    c = CONSTANTS
    return scenes.plummer_scene(n, seed=SEED, total_mass=c["total_mass"],
                                scale_radius=c["scale_radius"], G=c["G"])


def _scene(q, v, m) -> Scene:
    n = len(m)
    return Scene(n=n, planet=0, asteroid=1, q=q, v=v, m=m,
                 types=["star"] * n, device_idx=np.zeros(0, np.int64))


@functools.lru_cache(maxsize=None)
def _reference(n: int, integrator: str, mode: str = "serial",
               dtype=torch.float64, block: int = plummer_kdk.BLOCK) -> tuple:
    return plummer_kdk.march(*_sphere(n), n_steps=STEPS, device="cpu",
                             integrator=integrator, mode=mode, block=block,
                             dtype=dtype, **_kw())


@functools.lru_cache(maxsize=None)
def _port(n: int, chunk: int, integrator: str = "leapfrog") -> tuple:
    """The final (q, v) of simulate() on the CPU, and its record."""
    st = simulate(_scene(*_sphere(n)), SimConfig(**_kw()), n_steps=STEPS,
                  chunk=chunk, precision="f64", integrator=integrator,
                  device="cpu")
    return st.q, st.v, profiling.RECORDS[-1]


@pytest.mark.parametrize("chunk", [7, 25])
@pytest.mark.parametrize("n", [64, 600])
def test_leapfrog_bitwise_the_serial_reference(n, chunk):
    q, v, _ = _port(n, chunk)
    rq, rv = _reference(n, "leapfrog")
    assert np.array_equal(q, rq) and np.array_equal(v, rv)


def test_euler_bitwise_the_serial_reference():
    q, v, _ = _port(64, 7, "euler")
    rq, rv = _reference(64, "euler")
    assert np.array_equal(q, rq) and np.array_equal(v, rv)


@pytest.mark.parametrize("n", [64, 600])
def test_chunk_invariance(n):
    a, b = _port(n, 7), _port(n, 25)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("block", [128, 600, 1024])
def test_block_mode_within_a_tenth_of_the_limits(block):
    """Blocks of 128 rows leave a short last block (600 = 4 x 128 + 88),
    so the self pair's zero lands off the blocks' first column."""
    got = plummer.gaps([_reference(600, "leapfrog", "block", block=block)],
                       _reference(600, "leapfrog"), *_sphere(600)[:2])
    assert all(got[k] <= LIMITS[k] / 10 for k in LIMITS), got


def test_the_float32_control_fails_a_limit():
    got = plummer.gaps([_reference(600, "leapfrog", "block",
                                   torch.float32)],
                       _reference(600, "leapfrog"), *_sphere(600)[:2])
    assert any(got[k] > LIMITS[k] for k in LIMITS), got
    assert all(math.isfinite(x) for x in got.values())


def test_euler_mode_against_the_product_reference():
    q0, v0, m = _sphere(600)
    kw = _kw(n_steps=5, device="cpu")
    got = plummer.march(q0, v0, m, **kw)
    want = plummer_kdk.march(q0, v0, m, integrator="euler", mode="serial",
                             **kw)
    gaps = plummer.gaps([got], want, q0, v0)
    assert all(x <= EULER_GAP for x in gaps.values()), gaps


def test_reference_refuses_bad_arguments():
    q0, v0, m = _sphere(64)
    with pytest.raises(ValueError, match="mode"):
        plummer_kdk.march(q0, v0, m, n_steps=1, device="cpu", mode="tree",
                          **_kw())
    with pytest.raises(ValueError, match="integrator"):
        plummer_kdk.march(q0, v0, m, n_steps=1, device="cpu",
                          integrator="rk4", **_kw())
    with pytest.raises(TypeError):
        plummer_kdk.accel(torch.zeros(4, 3), torch.ones(4), 1e-3)


def _circular_orbit(per_orbit: int, orbits: int = 12) -> tuple:
    """The port's KDK on two equal bodies in a circular orbit, per_orbit
    steps an orbit: |E - E0| / |E0| after each step, and the distance of
    the first body from where the exact orbit has it at the end, over the
    orbit's radius (the phase error)."""
    G, M, r, eps = 6.674e-11, 1e20, 1e7, 1e-3
    v = math.sqrt(G * M / (2 * r))              # each about the centre
    w = v / (r / 2)
    dt = 2 * math.pi / w / per_orbit
    q = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]])
    vel = np.array([[0, -v, 0], [0, v, 0]])

    def energy(q, vel):
        d = np.linalg.norm(q[1] - q[0])
        return 0.5 * M * (vel * vel).sum() - G * M * M / math.sqrt(
            d * d + eps * eps)

    e0, out = energy(q, vel), []
    st = simulate(_scene(q, vel, np.array([M, M])),
                  SimConfig(G=G, eps=eps, dt=dt),
                  n_steps=orbits * per_orbit, chunk=1, precision="f64",
                  integrator="leapfrog", device="cpu",
                  on_chunk=lambda st: out.append(energy(st.q, st.v)))
    end = math.pi + w * dt * orbits * per_orbit
    exact = (r / 2) * np.array([math.cos(end), math.sin(end), 0.0])
    return (np.abs(np.array(out) - e0) / abs(e0),
            np.linalg.norm(st.q[0] - exact) / (r / 2))


def test_kdk_energy_bounded_and_second_order():
    """Over 12 orbits each orbit's largest energy error is the first's (no
    drift), and halving dt cuts the phase error four times. On a circle
    the dt^2 term of the leapfrog's energy error is the same at every
    point, so the error seen falls faster than dt^2 (some 16 times)."""
    (e64, p64), (e128, p128) = _circular_orbit(64), _circular_orbit(128)
    for err, k in ((e64, 64), (e128, 128)):
        each = err.reshape(-1, k).max(1)
        assert each.max() <= 1.01 * each[0]
    assert e64.max() < 1e-4
    assert e64.max() / e128.max() >= 3.6
    assert 3.6 < p64 / p128 < 4.4


@pytest.mark.parametrize("integrator,seeds", [("leapfrog", 1),
                                              ("euler", 0)])
def test_record_counts_the_seed_and_the_rows(integrator, seeds):
    _, _, rec = _port(64, 7, integrator)
    assert rec["seeds"] == seeds
    assert (rec["seed_s"] > 0) == bool(seeds)
    assert rec["sim_row_steps"] == {}         # the plain versions'
    assert rec["row_steps"] == {"sim": STEPS}


@pytest.mark.parametrize("max_n,wide,form", [(64, 64, "persistent"),
                                             (63, 65, "blocked.g0"),
                                             (63, 64, "blocked.g1")])
def test_record_counts_the_rows_under_the_form_the_call_reports(
        monkeypatch, max_n, wide, form):
    """simulate() through the C call's path on CPU tensors, the stand-in
    library's chunk call reporting one launch up to `persistent_max_n`
    bodies and the pre-launch and one a step above, its geometry entry
    the wide geometry (1) from `wide` rows: n x steps under the form and,
    for a launch a step, the geometry it reported, and the plain path's
    bits."""
    import test_torch_sim_graph as sim_graph
    import torch_mesh_workers

    q, v, _ = _port(64, 7)        # the plain path's, before the stand-in
    lib = sim_graph.FakeLib(CONSTANTS["eps"])
    lib.persistent_max_n = max_n
    lib.wide_min_rows = wide
    torch_mesh_workers.fake_kernels(monkeypatch.setattr, lib)
    st = simulate(_scene(*_sphere(64)), SimConfig(**_kw()), n_steps=STEPS,
                  chunk=STEPS, precision="f64", integrator="leapfrog",
                  device="cpu")
    assert [k for _, k, _, _ in lib.chunks] == [STEPS]
    assert profiling.RECORDS[-1]["sim_row_steps"] == {
        f"f64.{form}": 64 * STEPS}
    assert np.array_equal(st.q, q) and np.array_equal(st.v, v)


# the cell's traffic at a tiny size, through the harness on the CPU
TINY = {"name": "t-calls-n96", "kind": "simulate_calls_f64", "n": 96,
        "n_steps": 12, "chunk": 4}


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout's benchmark with the cell's configuration at a tiny
    size, added as a file and an entry of BENCHMARK.json alone. This
    process holds JAX (tests/conftest.py), so the harness's refusal of its
    modules, which benchmark/tests holds, is set aside here."""
    monkeypatch.setattr(run, "forbidden_modules", lambda names: [])
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    body = {"name": "tiny-f64", "config": "plummer-f64-leapfrog",
            "chips": 1, "traffic": TINY, "limits": LIMITS, "why": "a test"}
    (tmp_path / "benchmark" / "workloads" / "tiny-f64.json").write_text(
        json.dumps(body))
    spec["workloads"].append({"name": "tiny-f64",
                              "config": "plummer-f64-leapfrog",
                              "traffic": TINY["name"], "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-f64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_through_the_harness(tiny_root, trace):
    r = run.run_cell(Bench(tiny_root), "tiny-f64", SEED, 0.3, trace,
                     device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) == {"q_gap", "v_med_gap"}
    if trace:
        # on the CPU no kernel is traced: the roofline is left out
        assert "sim.kernel_roofline" not in r["metrics"]
        assert r["metrics"]["sim.seed_s"]["value"] > 0
        assert r["metrics"]["sim.capture_s"]["value"] == 0.0
    else:
        assert set(r["metrics"]) == {"sim_pairs_per_s", "setup_s"}


def test_tiny_cell_work_counts_the_seed(tiny_root):
    cell, config = Bench(tiny_root).cell("tiny-f64")
    t = Bench(tiny_root).driver("simulate_calls_f64").Traffic(
        cell, config, SEED, "cpu")
    t.request("one")
    numbers, work = t.check()
    assert all(numbers[k] <= LIMITS[k] / 10 for k in LIMITS), numbers
    assert work == {"pairs": 96 * 96 * 13, "precision": "f64"}
    assert t.end_to_end(2.0, 3) == {"sim_pairs_per_s":
                                    96 * 96 * 12 * 3 / 2.0}


def test_tiny_cell_with_half_the_sources_is_not_correct(tiny_root,
                                                        monkeypatch):
    from nbody_tpu_torch.ops import sim_step

    orig = sim_step.accel_f64_ref

    def half(qi, qj, gm, **kw):
        h = qj.shape[-2] // 2
        return orig(qi, qj[..., :h, :].contiguous(),
                    gm[..., :h].contiguous(), **kw)

    monkeypatch.setattr(sim_step, "accel_f64_ref", half)
    r = run.run_cell(Bench(tiny_root), "tiny-f64", SEED, 0.1, False,
                     device="cpu")
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_control_fails_at_a_tiny_size(tiny_root):
    cell, config = Bench(tiny_root).cell("tiny-f64")
    got = Bench(tiny_root).driver("simulate_calls_f64").control(
        cell, config, SEED, "cpu")
    assert set(got) == {"f32", "program_f32"}
    for numbers in got.values():
        assert any(numbers[k] > LIMITS[k] for k in LIMITS), got


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _blocked_key(n: int) -> str:
    """The record's key of a one-device Blocked chunk at n bodies: the
    geometry this card's library takes for n rows."""
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops.sim_step import sim_f64_geometry

    return f"f64.blocked.g{sim_f64_geometry(_build.load(), n, n)[0]}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,form", [(512, "persistent"), (513, "blocked"),
                                    (4096, "blocked")])
def test_kdk_bitwise_serial_reference_on_card(cuda, n, form):
    """50 steps in chunks of 25 (a capture and a replay), each chunk one
    C call of sim_chunk_f64, bitwise the serial reference on the card, and
    counted under the form the C call chose (a launch a step under its
    geometry)."""
    q0, v0, m = _sphere(n)
    with profiling.entry("card") as req:
        st = simulate(_scene(q0, v0, m), SimConfig(**_kw()), n_steps=50,
                      chunk=25, precision="f64", integrator="leapfrog",
                      device="cuda")
    rq, rv = plummer_kdk.march(q0, v0, m, n_steps=50, device=cuda,
                               mode="serial", **_kw())
    key = "f64.persistent" if form == "persistent" else _blocked_key(n)
    assert req.record["sim_row_steps"] == {key: n * 50}
    assert req.record["seeds"] == 1 and req.record["seed_s"] > 0
    assert np.array_equal(st.q, rq) and np.array_equal(st.v, rv)


@pytest.mark.cuda
def test_block_mode_against_serial_on_card(cuda):
    q0, v0, m = _sphere(4096)
    kw = _kw(n_steps=50, device=cuda)
    got = plummer.gaps([plummer_kdk.march(q0, v0, m, **kw)],
                       plummer_kdk.march(q0, v0, m, mode="serial", **kw),
                       q0, v0)
    assert all(got[k] <= LIMITS[k] / 10 for k in LIMITS), got


# the Blocked step's geometries, each forced in a library of its own
# (chip_smoke.sim_f64_libs), at a size each form is chosen at: 513 rows
# take blocks of four rows, WIDE_N the wide geometry
WIDE_N = 16384


@functools.lru_cache(maxsize=None)
def _forced_libs() -> dict:
    import chip_smoke

    return chip_smoke.sim_f64_libs(None, "checks")


def sim_expected(rows: int, sms: int) -> int:
    """The geometry csrc/sim_step_f64.cu sim_geometry chooses for a
    launch of `rows` rows, by its rule (the test's own statement of it):
    the wide one where its blocks of 8 rows outnumber two an SM."""
    return 1 if -(-rows // 8) > 2 * sms else 0


def test_forced_geometries_cover_the_choice(tmp_path):
    """Every index the choice can return is a geometry of the source,
    each forced by one edit (chip_smoke.sim_forced) that finds its line;
    the persistent limit's edit finds its line too, and a sweep copy of
    the sources holds its one geometry, always chosen."""
    import chip_smoke

    from nbody_tpu_torch.ops import _build

    assert chip_smoke.sim_geometries() == 2
    with open(os.path.join(_build.CSRC, "sim_step_f64.cu")) as f:
        text = f.read()
    assert text.count(chip_smoke._SIM_CHOICE) == 1
    assert text.count(chip_smoke._SIM_PMAX) == 1
    assert len(chip_smoke._SIM_TABLE.findall(text)) == 1
    copy = chip_smoke.sim_sweep_csrc((8, 4, 64, 3, 3), str(tmp_path / "s"))
    with open(os.path.join(copy, "sim_step_f64.cu")) as f:
        edited = f.read()
    cases = chip_smoke._SIM_TABLE.search(edited).group(2)
    assert cases.strip() == ("case 0: return f(nbody::F64Producer<8, 4, "
                             "64, 3, 3>{});")
    assert f"{chip_smoke._SIM_CHOICE}    return 0;\n" in edited
    assert [sim_expected(r, 132) for r in (513, 2048, 2112, 2113, WIDE_N,
                                           65536)] == [0, 0, 0, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dist3", ["dsqrt", "sqrt3"])
@pytest.mark.parametrize("integrator,compensated",
                         [("euler", False), ("euler", True),
                          ("leapfrog", False), ("leapfrog", True)])
@pytest.mark.parametrize("n", [513, WIDE_N])
@pytest.mark.parametrize("library", ["change"] + [
    f"g{g}" for g in range(2)])
def test_each_geometry_bitwise_plain_chunk_on_card(cuda, library, n,
                                                   integrator, compensated,
                                                   dist3):
    """3 steps of the Blocked form in chunks of 2 and 1, each geometry
    forced and the library's own choice, every carry bitwise
    sim_chunk_f64_ref on the same carry on the card
    (chip_smoke.sim_f64_blocked_check); the choice is sim_expected's."""
    import chip_smoke

    from nbody_tpu_torch.ops import _build

    assert chip_smoke.sim_geometries() == 2
    rec = chip_smoke.sim_f64_blocked_check(_forced_libs()[library], n,
                                           integrator, compensated, dist3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = sim_expected(n, sms) if library == "change" else int(library[1:])
    assert rec["geometry"] == want, rec
    assert rec["bitwise_equal"], rec
    if library == "change":
        from nbody_tpu_torch.ops.sim_step import sim_f64_geometry

        assert sim_f64_geometry(_build.load(), n, n)[0] == want


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,compensated",
                         [("euler", False), ("euler", True),
                          ("leapfrog", False), ("leapfrog", True)])
@pytest.mark.parametrize("n", [513, WIDE_N])
def test_mesh_rows_at_world_size_one_bitwise_one_device_on_card(
        cuda, n, integrator, compensated):
    """sim_rows_chunk_f64 on one block of all n rows (sim_rows_f64_step,
    world size 1) bitwise sim_chunk_f64 on one device, 3 steps in chunks
    of 2 and 1, both a launch a step in the geometry of n rows."""
    import chip_smoke

    from nbody_tpu_torch.ops import sim_step as ss
    from nbody_tpu_torch.ops.chunking import Blocks

    scene = chip_smoke.sim_cell_scene(n, chip_smoke.SIM_F64_SEED)
    out = []
    for rows in (False, True):
        c, m0, mh, fst, kw, _ = chip_smoke.sim_carry(scene, integrator,
                                                     compensated, 3)
        for s0, s1 in ((0, 2), (2, 3)):
            if rows:
                ss.sim_rows_chunk_f64(c, m0, mh, fst, s0, s1,
                                      blocks=Blocks(n, 1, (0,)), **kw)
            else:
                ss.sim_chunk_f64(c, m0, mh, fst, s0, s1, **kw)
        out.append(c)
    for name in ("q", "v", "a", "qc", "vc"):
        a, b = getattr(out[0], name), getattr(out[1], name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
