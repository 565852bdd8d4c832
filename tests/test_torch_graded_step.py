"""The graded step (ops/graded_step) on the CPU and on a card.

On the CPU the drivers run the plain chunks `_p12_chunk_ref`,
`_p3_chunk_ref` and `_p123_chunk_ref`: their answers must stay bit-equal
to the native serial core in dsqrt mode at any chunk length (1, 7 and
2000 steps; at 7 a chunk boundary falls between the step that starts a
chunk and the arrival and hit steps inside it), and the float32 solve
within test_torch_precisions' 1e-3 of the JAX package's float32 solve. The
step tables must equal the host floats the drivers read before they moved
to the device, and the wrappers must refuse what the kernels do not take.

On a card, each graded step kernel (fp64 in both dist3 forms, fp32 and
double-double) is held bitwise, on
every carry, against the plain chunk run on the card: P1+P2 at B=2 and
B=1 (n=1024, 300 steps), Problem 3 with rows that arrive mid-chunk, and the
fused driver at n=20 over two chunks; the double-double kernel (B4') also
at n one off its block's rows and its tile in each of its two geometries,
where the geometry changes, and at 1000, in every driver with one, two and
five rows. The JAX package is imported inside
the tests that use it, so the card's tests run where no JAX is installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_graded_step.py
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from nbody_tpu_torch import Scene, SimConfig, solve_scene
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.physics import oscillation_table

CPU = torch.device("cpu")
STEPS = 240          # tests/test_fuzz_differential.py's N_STEPS
JAX_RTOL = 1e-3      # tests/test_torch_precisions.py's f32 bound vs JAX
# fuzz seeds that hit (5 at step 148; 79 at 73, saved; 91 at 101) with
# arrivals before the hit, and two scenes grown to the phased sizes
FUSED_SEEDS = [5, 79, 91]
GROWN = [(79, 140, 120), (91, 256, 110)]
CHUNKS = [1, 7, 2000]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fuzz(seed: int) -> Scene:
    from test_fuzz_differential import _fuzz_scene

    s = _fuzz_scene(seed)
    return Scene(**{f.name: getattr(s, f.name)
                    for f in dataclasses.fields(s)})


def _grown(seed: int, n: int) -> Scene:
    """A fuzz scene with light far-off stars appended up to n bodies, as
    tests/test_torch_solver.py grows it."""
    s = _fuzz(seed)
    rng = np.random.RandomState(1000 + seed)
    k = n - s.n
    return Scene(n=n, planet=s.planet, asteroid=s.asteroid,
                 q=np.concatenate([s.q, rng.randn(k, 3) * 1e12]),
                 v=np.concatenate([s.v, rng.randn(k, 3) * 1e2]),
                 m=np.concatenate([s.m, np.abs(rng.randn(k)) * 1e18]),
                 types=list(s.types) + ["star"] * k,
                 device_idx=s.device_idx)


def _bits(ans):
    md, hs, dev, cost = ans
    return (np.float64(md).tobytes(), hs, dev, np.float64(cost).tobytes())


def _native(scene, n_steps):
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.native import solve_exact

    cfg = dataclasses.replace(JaxSimConfig(), n_steps=n_steps,
                              dist3_mode="dsqrt")
    return solve_exact(scene, cfg, dist3_mode="dsqrt")


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("seed", FUSED_SEEDS)
def test_fused_driver_bit_equal_to_native_at_any_chunk(seed, chunk):
    scene = _fuzz(seed)
    want = _native(scene, STEPS)
    assert want[1] != -2 and want[1] % 7 != 0   # the hit falls mid-chunk
    cfg = SimConfig(n_steps=STEPS, chunk_steps=chunk)
    assert _bits(solve_scene(scene, cfg, device="cpu").as_tuple()) == \
        _bits(want)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("seed,n,n_steps", GROWN)
def test_phased_drivers_bit_equal_to_native_at_any_chunk(seed, n, n_steps,
                                                         chunk):
    scene = _grown(seed, n)
    want = _native(scene, n_steps)
    assert want[1] != -2
    cfg = SimConfig(n_steps=n_steps, chunk_steps=chunk)
    assert _bits(solve_scene(scene, cfg, device="cpu").as_tuple()) == \
        _bits(want)


def test_arrivals_fall_inside_chunks():
    """Each fused seed has an arrival or hit strictly inside a 7-step chunk
    (neither its first nor its last step), so the checks that a step's
    launch hands to the next one are exercised across chunk boundaries."""
    for seed in FUSED_SEEDS:
        scene = _fuzz(seed)
        cfg = SimConfig(n_steps=STEPS)
        p123 = ds.run_problems_123(scene, oscillation_table(cfg), cfg,
                                   device=CPU)
        steps = [p123.hit_time_step, *p123.arrivals[p123.arrivals > 0]]
        assert any(s % 7 not in (0, 1) for s in steps), (seed, steps)


@pytest.mark.parametrize("chunk", [7, 2000])
@pytest.mark.parametrize("scene_of", [lambda: _fuzz(79), lambda: _fuzz(5),
                                      lambda: _grown(91, 256)],
                         ids=["fused_saved", "fused_hit", "phased_seq_p3"])
def test_f32_close_to_jax_f32_at_any_chunk(scene_of, chunk):
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.engine import solve_scene as jax_solve_scene

    scene = scene_of()
    n_steps = 110 if scene.n > 128 else STEPS
    got = solve_scene(scene, SimConfig(n_steps=n_steps, chunk_steps=chunk),
                      precision="f32", device="cpu")
    want = jax_solve_scene(scene, dataclasses.replace(
        JaxSimConfig(), n_steps=n_steps), precision="f32", platform="cpu")
    assert got.as_tuple()[1:] == (want.hit_time_step, want.gravity_device_id,
                                  want.missile_cost)
    assert got.min_dist == pytest.approx(want.min_dist, rel=JAX_RTOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_step_tables_equal_the_host_floats(dtype):
    """fst[s] and md2[s] on the device are the floats the drivers used on
    the host: the libm table rounded to the state's dtype, and
    md = fl(fl(speed*dt) * s) squared in that dtype (hw5.cu:270)."""
    cfg = SimConfig(n_steps=500)
    t = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    fst = oscillation_table(cfg)
    got = ds._fst_table(fst, CPU, dtype)
    assert got.dtype == dtype
    assert got.tolist() == np.asarray(fst, dtype=t).tolist()
    md = t(cfg.missile_speed * cfg.dt) * np.arange(cfg.n_steps + 1, dtype=t)
    got = ds._md2_table(cfg, CPU, dtype)
    assert got.dtype == dtype and got.tolist() == (md * md).tolist()


def _carry(mode: int, dtype=torch.float64) -> gs.Carry:
    scene = _fuzz(5)
    cfg = SimConfig(n_steps=50)
    fst = oscillation_table(cfg)
    if mode == gs.P12:
        return ds._p12_carry(scene, fst, cfg, CPU, dtype)
    if mode == gs.P123:
        return ds._p123_carry(scene, fst, cfg, CPU, dtype)
    q = torch.from_numpy(np.stack([scene.q] * 2)).to(dtype)
    p12 = ds.P12Result(min_dist=0.0, hit_time_step=30,
                       arrivals=np.asarray([3, 20]), q_snaps=q,
                       v_snaps=torch.from_numpy(np.stack([scene.v] * 2))
                       .to(dtype))
    return ds._p3_carry(scene, p12, fst, cfg, np.arange(2), CPU, dtype)


@pytest.mark.parametrize("mode", [gs.P12, gs.P3, gs.P123])
def test_chunk_on_cpu_is_the_plain_chunk(mode):
    """graded_chunk on CPU tensors runs the plain chunk and counts no
    launch; two chunks equal one over the same steps."""
    whole, split = _carry(mode), _carry(mode)
    before = gs.graded_step_f64.launches, gs.graded_step_f32.launches
    gs._REF[mode](whole, 0, 30)
    gs.graded_chunk(mode, split, 0, 11)
    gs.graded_chunk(mode, split, 11, 30)
    assert (gs.graded_step_f64.launches, gs.graded_step_f32.launches) == \
        before
    for f in dataclasses.fields(whole):
        x = getattr(whole, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, getattr(split, f.name)), f.name


@pytest.mark.parametrize("case", [
    "float16", "arr_float", "hit_bool", "v_shape", "m0_shape", "meta",
    "strided", "empty_chunk", "fst_short", "p12_rows", "p123_rows",
    "planet", "mode", "p3_hit_missing"])
def test_chunk_rejects_bad_inputs(case):
    mode = gs.P123 if case in ("p123_rows", "p3_hit_missing") else gs.P12
    c = _carry(mode)
    s0, s1, err = 0, 5, ValueError
    if case == "float16":
        c.q, err = c.q.half(), TypeError
    elif case == "arr_float":
        c.arr, err = c.arr.double(), TypeError
    elif case == "hit_bool":
        c.hit, err = c.hit.bool(), TypeError
    elif case == "v_shape":
        c.v = c.v[:, :-1].contiguous()
    elif case == "m0_shape":
        c.m0 = c.m0[:1]
    elif case == "meta":
        c.v = torch.zeros(c.v.shape, dtype=c.v.dtype, device="meta")
    elif case == "strided":
        c.v = torch.zeros((*c.v.shape[:2], 6), dtype=c.v.dtype)[..., ::2]
    elif case == "empty_chunk":
        s1 = s0
    elif case == "fst_short":
        c.fst = c.fst[:5]
    elif case == "p12_rows":
        c.q, c.v = (torch.cat([x, x[:1]]) for x in (c.q, c.v))
        c.m0, c.m_half = (torch.cat([x, x[:1]]) for x in (c.m0, c.m_half))
    elif case == "p123_rows":
        c.q, c.v, c.m0, c.m_half = (x[:-1] for x in (c.q, c.v, c.m0,
                                                     c.m_half))
    elif case == "planet":
        c.planet = c.q.shape[1]
    elif case == "mode":
        mode = 3
    else:
        c.p3_hit = None
    q0 = c.q
    with pytest.raises(err):
        gs.graded_chunk(mode, c, s0, s1)
    assert c.q is q0


def test_kernel_wrappers_refuse_cpu_tensors_and_other_dtypes():
    """The kernel wrappers launch or raise: a CPU carry is refused (only
    graded_chunk sends it to the plain chunk), and each wrapper takes its
    own dtype; no launch is counted."""
    before = gs.graded_step_f64.launches, gs.graded_step_f32.launches
    with pytest.raises(ValueError, match="cuda"):
        gs.graded_step_f64(gs.P12, _carry(gs.P12), 0, 5)
    with pytest.raises(ValueError, match="cuda"):
        gs.graded_step_f32(gs.P12, _carry(gs.P12, torch.float32), 0, 5)
    with pytest.raises(TypeError):
        gs.graded_step_f32(gs.P12, _carry(gs.P12), 0, 5)
    with pytest.raises(TypeError):
        gs.graded_step_f64(gs.P12, _carry(gs.P12, torch.float32), 0, 5)
    assert (gs.graded_step_f64.launches, gs.graded_step_f32.launches) == \
        before


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_scene(_fuzz(5), SimConfig(n_steps=10), precision="f32",
                    device="cuda")


def test_source_digest_covers_every_source_and_header(tmp_path,
                                                      monkeypatch):
    """An edit to a shared header, or a new one, rebuilds the library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    digest = _build.source_digest()
    assert digest == _build.source_digest()
    header = csrc / "forces.cuh"
    header.write_text(header.read_text() + "\n")
    edited = _build.source_digest()
    assert edited != digest
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.source_digest() != edited


def test_every_source_is_compiled_and_every_header_exists():
    names = set(os.listdir(_build.CSRC))
    assert {n for n in names if n.endswith(".cu")} == set(_build.SOURCES)
    assert {"forces.cuh", "graded.cuh"} <= names


# --- on a card -----------------------------------------------------------

CARD_CASES = ["P1+P2", "P1+P2 after the P2 exit", "P3 mid-chunk arrivals",
              "fused n=20"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("precision", ["f64", "f32", "tf3", "f64-sqrt3"])
def test_step_kernel_bitwise_equal_to_plain_chunk_on_card(cuda, precision,
                                                          case):
    import chip_smoke

    precision, _, dist3 = precision.partition("-")
    mk = chip_smoke.graded_makers(precision, dist3 or "dsqrt")
    mode, make, chunks = {
        "P1+P2": (gs.P12, mk["p12"], [(0, 300)]),
        "P1+P2 after the P2 exit": (gs.P12, lambda d: mk["p12"](d, 1),
                                    [(0, 300)]),
        "P3 mid-chunk arrivals": (gs.P3, mk["p3"], [(0, 70), (70, 200)]),
        "fused n=20": (gs.P123, mk["p123"], [(0, 150), (150, 300)]),
    }[case]
    kernel = {"f64": gs.graded_step_f64, "f32": gs.graded_step_f32,
              "tf3": gs.graded_step_dd}[precision]
    before = kernel.launches
    rec = chip_smoke.check_step(case, mode, make, chunks)
    assert rec["bitwise_equal"]
    assert kernel.launches - before == sum(s1 - s0 + 1 for s0, s1 in chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("edges", ["narrow", "wide", "switch"])
def test_dd_step_kernel_bitwise_at_layout_edges_on_card(cuda, edges):
    """B4' in each of its two geometries at n one short of and one past a
    multiple of its rows a block and of its tile, and at the n where the
    geometry changes and 1000: P1+P2 at B=2 and B=1, Problem 3 and the
    fused driver with five rows each, bitwise equal to the plain dd
    chunk."""
    import chip_smoke

    before, launches = gs.graded_step_dd.launches, 0
    for n in chip_smoke.dd_edge_sizes()[edges]:
        for label, mode, make, chunks in chip_smoke.dd_edge_cases(n):
            rec = chip_smoke.check_step(label, mode, make, chunks)
            assert rec["bitwise_equal"], rec
            assert rec["n"] == n
            launches += sum(s1 - s0 + 1 for s0, s1 in chunks)
    assert gs.graded_step_dd.launches - before == launches


@pytest.mark.cuda
def test_launchers_refuse_bad_arguments_on_card(cuda):
    """The C entry points refuse an empty chunk, B = 0, a bad mode and
    n = 0 with cudaErrorInvalidValue (1) before launching; the fp64 ones
    also a dist3 form other than dsqrt (1) and sqrt3 (2)."""
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    for name, ints, reals in (("graded_chunk_f64_launch", (1,), 4),
                              ("graded_chunk_f32_launch", (), 4),
                              ("graded_chunk_dd_launch", (), 8)):
        fn = getattr(lib, name)
        for mode, B, n, s0, s1 in ((0, 1, 4, 5, 5), (0, 0, 4, 0, 1),
                                   (3, 1, 4, 0, 1), (0, 1, 0, 0, 1)):
            assert fn(*[None] * 16, mode, B, n, 0, 0, *ints,
                      *[1.0] * reals, s0, s1, stream) == 1
    assert lib.graded_chunk_f64_launch(*[None] * 16, 0, 1, 4, 0, 0, 0,
                                       *[1.0] * 4, 0, 1, stream) == 1
    z = torch.zeros((1, 4, 3), dtype=torch.float64, device="cuda")
    assert lib.accel_f64_launch(z.data_ptr(), z.data_ptr(), z.data_ptr(),
                                z.data_ptr(), 1, 4, 4, 1.0, 3, stream) == 1
    assert lib.fold_floor_f64_launch(None, None, None, 2048, 1, stream) == 1
