"""The port's mesh layer (nbody_tpu_torch/parallel/mesh.py, sharded.py),
the `--mesh`/`--tile` CLI, the entry points (graft_entry.py) and the cross
forms of kernels B1, B2 and B4, on the CPU.

  * the mesh spec and its refusals (a mesh must use every rank: a process
    group has no idle ranks), and the CLI's refusals;
  * the CLI over a mesh writes a `.out` byte-equal to the one-device
    CLI's: alone at world size 1 (f64, and f32 at the default tile 128),
    on 2x2 gloo ranks, and under `torchrun --standalone` on 3 ranks with
    a ragged n=20;
  * the plain versions' cross forms: rows in blocks, each against all the
    sources, concatenated, bitwise the self form (B1 in dsqrt and sqrt3,
    B4); B2's partials of 128-wide tiles added in ascending order bitwise
    its self form, and at tile 256 the same bits for 1, 2 and 4 row
    blocks;
  * `ring_pairwise_accel`, `make_sharded_step` and `simulate_sharded` on
    a 2x2 mesh of gloo ranks against the JAX package's on 4 virtual CPU
    devices: float32 within 1e-4 relative (the dry run's tolerance,
    __graft_entry__.py:153-154), float64 within 1e-12; the ordered ring
    at tile 128 bitwise kernel B2's plain self form;
  * `dryrun_multichip(4)` and `entry('cpu')`.
The cuda-marked tests hold the kernels' cross forms on a card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbody_tpu_torch.cli import main
from nbody_tpu_torch.io import write_input
from nbody_tpu_torch.ops import ddfloat as ddf
from nbody_tpu_torch.ops.accel_dd import accel_dd, accel_dd_ref
from nbody_tpu_torch.ops.accel_f32 import accel_f32, accel_f32_ref
from nbody_tpu_torch.ops.accel_f64 import accel_f64, accel_f64_ref
from nbody_tpu_torch.parallel.mesh import mesh_sizes, parse_mesh_spec
from nbody_tpu_torch.parallel.spawn import run_ranks
import torch_mesh_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, EPS, DT = 6.674e-11, 1e-3, 60.0
STEPS = 300
TIMEOUT = 120


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "n20.in")
    write_input(path, W.fuzz_scene(103, 20, 3))
    return path


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("spec,want", [
    ("scen=2,body=4", {"scen": 2, "body": 4}),
    ("body=-1", {"body": -1, "scen": 1}),
    ("scen=1", {"scen": 1, "body": 1}),
    (" scen = 2 , body=1", {"scen": 2, "body": 1}),
])
def test_parse_mesh_spec(spec, want):
    assert parse_mesh_spec(spec) == want


@pytest.mark.parametrize("spec", ["scen2", "rows=2", "scen=2,scen=1",
                                  "body=x"])
def test_parse_mesh_spec_refuses(spec):
    with pytest.raises(ValueError):
        parse_mesh_spec(spec)


@pytest.mark.parametrize("axes,world,want", [
    ({"scen": 2, "body": -1}, 8, (2, 4)),
    ({"scen": -1, "body": 3}, 6, (2, 3)),
    ({"body": 4}, 4, (1, 4)),
    ({"scen": 1, "body": 1}, 1, (1, 1)),
])
def test_mesh_sizes(axes, world, want):
    assert mesh_sizes(axes, world) == want


@pytest.mark.parametrize("axes,world,match", [
    ({"scen": 2, "body": 2}, 8, "every rank"),
    ({"scen": 2, "body": 2}, 2, "every rank"),
    ({"scen": -1, "body": -1}, 4, "at most one"),
    ({"scen": -1, "body": 3}, 4, "do not divide"),
    ({"rows": 2}, 2, "axes"),
])
def test_mesh_sizes_refuse(axes, world, match):
    with pytest.raises(ValueError, match=match):
        mesh_sizes(axes, world)


@pytest.mark.parametrize("extra,match", [
    (["--mesh", "scen=1,body=1", "--precision", "exact"], "exact"),
    (["--mesh", "scen=1,body=1", "--tile", "0"], "positive"),
    (["--tile", "8"], "--mesh"),
    (["--mesh", "scen2"], "axis=size"),
    (["--mesh", "scen=2,body=2"], "every rank"),
    (["--mesh", "body=1", "--tile", "4096", "--precision", "f32"],
     "pad the scene"),
])
def test_cli_refuses(scene_file, tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        main([scene_file, str(tmp_path / "o.out"), "--device", "cpu",
              *extra])


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_cli_alone_on_a_mesh_of_one(scene_file, tmp_path, precision):
    """World size 1 (a one-rank gloo group through a file store, opened
    and closed by the CLI): the .out byte-equal to the one-device CLI's."""
    import torch.distributed as dist

    args = [scene_file, "--device", "cpu", "--n-steps", str(STEPS),
            "--precision", precision]
    one, mesh = str(tmp_path / "one.out"), str(tmp_path / "mesh.out")
    assert main([args[0], one, *args[1:]]) == 0
    assert main([args[0], mesh, *args[1:], "--mesh", "scen=1,body=1"]) == 0
    assert _read(mesh) == _read(one)
    assert not dist.is_initialized()


def test_cli_on_2x2_gloo_ranks(scene_file, tmp_path):
    """Rank 0 alone writes the .out; f64 byte-equal to the one-device
    CLI's."""
    one, mesh = str(tmp_path / "one.out"), str(tmp_path / "mesh.out")
    assert main([scene_file, one, "--device", "cpu", "--n-steps",
                 str(STEPS)]) == 0
    rcs = run_ranks(W.cli_jobs, 4, ({"scen": 2, "body": 2},
                                    [[scene_file, mesh, "--n-steps",
                                      str(STEPS)]]),
                    workdir=str(tmp_path), timeout=TIMEOUT)
    assert rcs == [[0]] * 4
    assert _read(mesh) == _read(one)


def test_cli_under_torchrun_ragged(scene_file, tmp_path):
    """`torchrun --standalone --nproc-per-node 3 -m nbody_tpu_torch ...
    --mesh scen=1,body=3 --device cpu`: n=20 rows split 7, 7, 6; the .out
    byte-equal to the one-device CLI's, and only rank 0 prints stats."""
    one, mesh = str(tmp_path / "one.out"), str(tmp_path / "mesh.out")
    assert main([scene_file, one, "--device", "cpu", "--n-steps",
                 str(STEPS)]) == 0
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "3", "-m", "nbody_tpu_torch", scene_file, mesh,
         "--mesh", "scen=1,body=3", "--device", "cpu", "--n-steps",
         str(STEPS), "--stats"],
        capture_output=True, text=True, cwd=str(tmp_path), env=_env(),
        timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _read(mesh) == _read(one)
    stats = [line for line in r.stderr.splitlines()
             if line.startswith("{") and '"mesh"' in line]
    assert len(stats) == 1 and '"body": 3' in stats[0]


def _blocks(n, k):
    return [(b[0], b[-1] + 1) for b in np.array_split(np.arange(n), k)
            if b.size]


@pytest.mark.parametrize("dist3", ["dsqrt", "sqrt3"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_b1_plain_cross_form_rows_equal_self_form(k, dist3):
    rng = np.random.RandomState(k)
    q = torch.from_numpy(rng.randn(2, 20, 3) * 1e10)
    gm = torch.from_numpy(G * np.abs(rng.randn(2, 20)) * 1e24)
    whole = accel_f64_ref(q, q, gm, eps=EPS, dist3_mode=dist3)
    rows = torch.cat([accel_f64(q[:, a:b].contiguous(), q, gm, eps=EPS,
                                dist3_mode=dist3)
                      for a, b in _blocks(20, k)], dim=1)
    assert torch.equal(rows, whole)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_b4_plain_cross_form_rows_equal_self_form(k):
    rng = np.random.RandomState(10 + k)
    q = ddf.from_f64(rng.randn(2, 11, 3) * 1e10)
    q[..., 1] = q[..., 0] * torch.from_numpy(rng.uniform(-1, 1, (2, 11, 3))
                                             * 2.0 ** -54)
    gm = ddf.from_f64(G * np.abs(rng.randn(2, 11)) * 1e24)
    whole = accel_dd_ref(q, q, gm, eps=EPS)
    rows = torch.cat([accel_dd(q[:, a:b].contiguous(), q, gm, eps=EPS)
                      for a, b in _blocks(11, k)], dim=1)
    assert torch.equal(rows, whole)


def _ordered(qi, qj, gm, tile):
    """The ordered ring's sum for rows qi: one partial per tile of the
    sources, added from 0 in ascending order."""
    acc = torch.zeros_like(qi)
    for t in range(0, qj.shape[-2], tile):
        acc = acc + accel_f32(qi, qj[:, t:t + tile].contiguous(),
                              gm[:, t:t + tile].contiguous(), eps=EPS)
    return acc


def test_b2_plain_ordered_partials_at_tile_128_equal_self_form():
    """B2 folds each 128-wide tile from 0 and adds the tile sums from 0 in
    ascending order: its partials of 128-wide tiles, added in order, are
    its self form bit for bit, at a ragged n=300 (padded with zero mass
    to 384 as the mesh pads)."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 300, 3).astype(np.float32))
    gm = torch.from_numpy((G * np.abs(rng.randn(2, 300)) * 1e8)
                          .astype(np.float32))
    whole = accel_f32_ref(q, q, gm, eps=EPS)
    assert torch.equal(_ordered(q, q, gm, 128), whole)
    qp = torch.cat([q, torch.zeros(2, 84, 3)], dim=1)
    gp = torch.cat([gm, torch.zeros(2, 84)], dim=1)
    assert torch.equal(_ordered(qp, qp, gp, 128)[:, :300], whole)


def test_b2_plain_ordered_at_tile_256_same_for_every_row_split():
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(1, 512, 3).astype(np.float32))
    gm = torch.from_numpy((G * np.abs(rng.randn(1, 512)) * 1e8)
                          .astype(np.float32))
    got = [torch.cat([_ordered(q[:, a:b].contiguous(), q, gm, 256)
                      for a, b in _blocks(512, k)], dim=1)
           for k in (1, 2, 4)]
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])


@pytest.fixture(scope="module")
def ring_inputs():
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.plummer import plummer_scene
    from nbody_tpu_torch.physics import oscillation_table

    n = 256
    q, v, m = plummer_scene(n, seed=0)
    q2 = np.stack([q, q[::-1]])               # two batch rows, over 'scen'
    v2, m2 = np.stack([v, v[::-1]]), np.stack([m, m[::-1] * 2.0])
    mask = np.zeros(n)
    mask[2:4] = 1.0
    fst = oscillation_table(SimConfig(), 6)
    return q2, v2, m2, 0.5 * m * mask, fst


@pytest.fixture(scope="module")
def ring_runs(ring_inputs, tmp_path_factory):
    q, v, m, m_half, fst = ring_inputs
    return run_ranks(W.ring_jobs, 4, ({"scen": 2, "body": 2}, q, v, m, G,
                                      EPS, DT, m_half, fst),
                     workdir=str(tmp_path_factory.mktemp("ring")),
                     timeout=TIMEOUT)


@pytest.fixture(scope="module")
def jax_ring(ring_inputs):
    """The JAX package's ring functions on a 2x2 mesh of virtual CPU
    devices, the same inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from nbody_tpu.parallel import (make_mesh, make_sharded_step,
                                    ring_pairwise_accel, simulate_sharded)

    q, v, m, m_half, fst = ring_inputs
    mesh = make_mesh({"scen": 2, "body": 2})
    out = {}
    for dtype in (np.float32, np.float64):
        fn = jax.jit(jax.shard_map(
            lambda qq, gg: ring_pairwise_accel(qq, gg, axis_name="body",
                                               eps=EPS),
            mesh=mesh, in_specs=(P("body", None), P("body")),
            out_specs=P("body", None)))
        out[np.dtype(dtype).name] = np.asarray(fn(
            jnp.asarray(q[0], dtype), jnp.asarray(m[0] * G, dtype)))
    step = make_sharded_step(mesh, batch_axes=("scen",), G=G, eps=EPS,
                             dt=DT)
    q1, v1 = step(*(jnp.asarray(x, jnp.float32) for x in (q, v, m)))
    out["step_q"], out["step_v"] = np.asarray(q1), np.asarray(v1)
    qs, vs = simulate_sharded(
        *(jnp.asarray(x[0], jnp.float32) for x in (q, v, m)), 6, mesh,
        G=G, eps=EPS, dt=DT, m_half=jnp.asarray(m_half, jnp.float32),
        fst=fst.astype(np.float32), chunk=4)
    out["sim_q"], out["sim_v"] = np.asarray(qs), np.asarray(vs)
    return out


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("float64", 1e-12)])
def test_ring_pairwise_accel_against_jax(ring_runs, jax_ring, dtype, rtol):
    for r in ring_runs:
        _close(r[dtype], jax_ring[dtype], rtol)


def test_make_sharded_step_against_jax(ring_runs, jax_ring):
    """Each scen row's step, gathered over 'body', against JAX's batch row
    of the same index."""
    for r in ring_runs:
        si = r["rank"] // 2                      # rank = scen * 2 + body
        _close(r["step_q"], jax_ring["step_q"][si], 1e-4)
        _close(r["step_v"], jax_ring["step_v"][si], 1e-4)


def test_simulate_sharded_against_jax(ring_runs, jax_ring):
    for r in ring_runs:
        _close(r["sim_q"], jax_ring["sim_q"], 1e-4)
        _close(r["sim_v"], jax_ring["sim_v"], 1e-4)
    seen = {r["rank"]: r["seen"] for r in ring_runs}
    assert seen[0] == [(4, (256, 3)), (6, (256, 3))]
    assert all(not s for rank, s in seen.items() if rank)


def test_ring_accel_ordered_at_tile_128_is_b2(ring_runs, ring_inputs):
    """The ordered ring over two ranks of 128 bodies each, bitwise kernel
    B2's plain self form on the whole."""
    q, _, m, _, _ = ring_inputs
    qt = torch.from_numpy(q[0].astype(np.float32))
    gm = torch.from_numpy((m[0] * G).astype(np.float32))
    want = accel_f32_ref(qt, qt, gm, eps=EPS).numpy()
    for r in ring_runs:
        np.testing.assert_array_equal(r["ordered128"], want)


def test_dryrun_multichip():
    from nbody_tpu_torch.graft_entry import dryrun_multichip

    rec = dryrun_multichip(4, timeout=TIMEOUT)
    assert rec["f64"][1] != -2 and rec["f64"][2] != -1


def test_entry_on_the_cpu():
    from nbody_tpu_torch.graft_entry import entry

    step, args = entry("cpu")
    q, v = step(*args)
    assert q.shape == (1024, 3) and q.dtype == torch.float32
    assert bool(torch.isfinite(q).all() and torch.isfinite(v).all())


def test_entry_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nbody_tpu_torch.graft_entry import entry

    with pytest.raises(RuntimeError, match="cuda"):
        entry()


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(2, 1024), (5, 20)])
def test_b1_cross_form_rows_bitwise_self_form_on_card(cuda, B, n):
    rng = np.random.RandomState(n)
    q = torch.from_numpy(rng.randn(B, n, 3) * 1e10).to(cuda)
    gm = torch.from_numpy(G * np.abs(rng.randn(B, n)) * 1e24).to(cuda)
    for dist3 in ("dsqrt", "sqrt3"):
        whole = accel_f64(q, q, gm, eps=EPS, dist3_mode=dist3)
        for k in (2, 3, 4):
            rows = torch.cat([accel_f64(q[:, a:b].contiguous(), q, gm,
                                        eps=EPS, dist3_mode=dist3)
                              for a, b in _blocks(n, k)], dim=1)
            assert torch.equal(rows, whole)


@pytest.mark.cuda
def test_b4_cross_form_rows_bitwise_self_form_on_card(cuda):
    rng = np.random.RandomState(5)
    q = ddf.from_f64(rng.randn(2, 1024, 3) * 1e10).to(cuda)
    gm = ddf.from_f64(G * np.abs(rng.randn(2, 1024)) * 1e24).to(cuda)
    whole = accel_dd(q, q, gm, eps=EPS)
    for k in (2, 3, 4):
        rows = torch.cat([accel_dd(q[:, a:b].contiguous(), q, gm, eps=EPS)
                          for a, b in _blocks(1024, k)], dim=1)
        assert torch.equal(rows, whole)


@pytest.mark.cuda
def test_b2_ordered_partials_at_tile_128_bitwise_self_form_on_card(cuda):
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(2, 1024, 3).astype(np.float32)).to(cuda)
    gm = torch.from_numpy((G * np.abs(rng.randn(2, 1024)) * 1e8)
                          .astype(np.float32)).to(cuda)
    assert torch.equal(_ordered(q, q, gm, 128),
                       accel_f32(q, q, gm, eps=EPS))


@pytest.mark.cuda
def test_cross_launchers_refuse_empty_shapes_on_card(cuda):
    """B1's and B4's C entry points refuse B, ni or nj of 0 with
    cudaErrorInvalidValue (1) before launching."""
    from nbody_tpu_torch.ops import _build

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    z = torch.zeros((1, 4, 3, 2), dtype=torch.float64, device=cuda)
    p = z.data_ptr()
    for B, ni, nj in ((0, 4, 4), (1, 0, 4), (1, 4, 0)):
        assert lib.accel_f64_launch(p, p, p, p, B, ni, nj, 1.0, 1,
                                    stream) == 1
        assert lib.accel_dd_launch(p, p, p, p, B, ni, nj, 1.0, 0.0,
                                   stream) == 1
