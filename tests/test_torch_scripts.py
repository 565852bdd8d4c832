"""The port's measurement and scene tools (nbody_tpu_torch/scripts/) against
the JAX package's scripts, on the CPU.

  * `gen_scene` writes a file byte-equal to the root `scripts/gen_scene.py`
    for the same arguments;
  * `bench --device cpu` prints one JSON line with the root `bench.py`
    line's keys (less its TPU tile knobs), and its final state is within
    rtol 1e-5 of JAX `pallas_step` run in interpret mode on the same
    float32 state (measured: bitwise equal at n=256);
  * `bench_sharded` on 1, 2 and 3 gloo ranks: the ring's state within
    rtol 1e-4 of the unsharded step (`graft_entry`'s tolerance: the ring
    adds each block's partial as it arrives), and at one rank bitwise
    equal to it;
  * `run_golden` on a corpus of `gen_scene` scenes with goldens from
    `native/oracle ... dsqrt` at 300 steps: every `f64` `.out` byte-equal,
    and the records' keys those of the root `scripts/run_golden.py`, run
    on the same corpus; a case without its `.out` is an error;
  * `study_f32_horizon` at a short horizon: its float32 snapshots within
    rtol 1e-5 of JAX `simulate('f32')` (plain and Kahan), its truth within
    1e-9 of JAX `simulate('dd')` (the tolerances of
    tests/test_torch_simulate.py);
  * `utils/profiling.device_trace` with a directory and without one;
  * every tool raises without a card unless asked for the CPU.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nbody_tpu
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu.io import Scene as JaxScene
from nbody_tpu.simulate import simulate as jax_simulate
from nbody_tpu_torch.native import build
from nbody_tpu_torch.ops.accel_f32 import accel_f32
from nbody_tpu_torch.ops.integrate import scalar
from nbody_tpu_torch.scripts import bench, bench_sharded, gen_scene, \
    run_golden, study_f32_horizon
from nbody_tpu_torch.utils.profiling import device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_STEPS = 300


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions loop over small ops; torch's thread pool only
    slows them down on this host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _root_script(name: str):
    """The JAX package's `scripts/<name>.py` (or the root `<name>.py`),
    loaded as a module."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(REPO, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"root_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """gen_scene scenes at n=20 and n=64, each with its golden from
    native/oracle in dsqrt at GOLDEN_STEPS steps."""
    oracle = build("oracle")
    d = tmp_path_factory.mktemp("corpus")
    for case, n, seed in (("g20", 20, 3), ("g64", 64, 4)):
        gen_scene.main([str(d / f"{case}.in"), "--n", str(n), "--seed",
                        str(seed)])
        subprocess.run([oracle, str(d / f"{case}.in"), str(d / f"{case}.out"),
                        str(GOLDEN_STEPS), "dsqrt"], check=True)
    return d


@pytest.mark.parametrize("n,devices,black_holes,seed",
                         [(16, 2, 1, 0), (64, 3, 2, 7), (100, 5, 1, 11),
                          (257, 2, 3, 42)])
def test_gen_scene_byte_equal_to_root(tmp_path, monkeypatch, n, devices,
                                      black_holes, seed):
    args = ["--n", str(n), "--devices", str(devices), "--black-holes",
            str(black_holes), "--seed", str(seed)]
    monkeypatch.setattr(sys, "argv", ["gen_scene", str(tmp_path / "root.in"),
                                      *args])
    _root_script("gen_scene").main()
    assert gen_scene.main([str(tmp_path / "port.in"), *args]) == 0
    root = (tmp_path / "root.in").read_bytes()
    assert (tmp_path / "port.in").read_bytes() == root
    scene = gen_scene.make_scene(n, devices, black_holes, seed)
    assert scene.device_cnt == devices
    assert scene.types.count("black_hole") == black_holes


def test_bench_cpu_line_and_state_match_jax_pallas_step(monkeypatch,
                                                        capsys):
    import jax
    import jax.numpy as jnp
    from nbody_tpu.models.plummer import plummer_scene
    from nbody_tpu.ops.pallas_forces import pallas_step

    n, steps = 256, 3
    monkeypatch.setenv("BENCH_N", str(n))
    monkeypatch.setenv("BENCH_STEPS", str(steps))
    monkeypatch.setenv("BENCH_REPEATS", "1")
    _root_script("bench").main()
    root = json.loads(capsys.readouterr().out.strip().split("\n")[-1])
    for var in ("BENCH_N", "BENCH_STEPS", "BENCH_REPEATS"):
        monkeypatch.delenv(var)

    assert bench.main(["--n", str(n), "--steps", str(steps), "--device",
                       "cpu"]) == 0
    lines = capsys.readouterr().out.strip().split("\n")
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == set(root)
    assert set(root["extra"]) - {"tile_i", "tile_j"} <= set(rec["extra"])
    extra = rec["extra"]
    assert rec["metric"] == f"cpu_allpairs_fp32_n{n}_pairs_per_sec"
    assert (extra["n"], extra["steps"], extra["repeats"]) == (n, steps, 3)
    assert len(extra["repeat_s"]) == 3 and extra["elapsed_s"] == min(
        extra["repeat_s"])
    assert extra["launches"] == 0         # the plain version launches nothing
    assert (extra["graph_replays"], extra["graph_captures"]) == (0, 0)
    assert rec["value"] == pytest.approx(n * n * steps / extra["elapsed_s"])

    _, got = bench.bench(n, steps, 1, "cpu")
    q, v, m = plummer_scene(n, seed=0)
    with jax.enable_x64(False):
        qf, vf = jnp.asarray(q, jnp.float32), jnp.asarray(v, jnp.float32)
        gm = jnp.asarray(bench.G * m, jnp.float32)
        for _ in range(steps):
            qf, vf = pallas_step(qf, vf, gm, eps=bench.EPS, dt=bench.DT,
                                 tile_i=128, tile_j=128, interpret=True)
        qf, vf = np.asarray(qf), np.asarray(vf)
    np.testing.assert_allclose(got.q.numpy(), qf, rtol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), vf, rtol=1e-5)


def _unsharded(n: int, steps: int):
    """`steps` eager steps of plummer_scene(n, seed=0) in float32, the
    force kernel B2's cross form (its plain version on the CPU) on all n."""
    from nbody_tpu_torch.models.plummer import plummer_scene

    q, v, m = (torch.from_numpy(np.asarray(x, np.float32))
               for x in plummer_scene(n, seed=0))
    gm = m * scalar(bench_sharded.G, torch.float32)
    h = scalar(bench_sharded.DT, torch.float32)
    for _ in range(steps):
        a = accel_f32(q, q, gm, eps=bench_sharded.EPS)
        v = v + a * h
        q = q + v * h
    return q.numpy(), v.numpy()


@pytest.mark.parametrize("world", [1, 2, 3])
def test_bench_sharded_ring_matches_unsharded_step(tmp_path, world):
    from nbody_tpu_torch.parallel.spawn import run_ranks

    n, steps = 96, 3
    ranks = run_ranks(bench_sharded.rank_run, world, (n, steps),
                      workdir=str(tmp_path), timeout=240)
    q1, v1 = _unsharded(n, steps)
    for rank, (rec, (r0, r1), q, v) in enumerate(ranks):
        assert (r0, r1) == (rank * n // world, (rank + 1) * n // world)
        extra = rec["extra"]
        assert rec["metric"] == \
            f"sharded_ring_cpu_fp32_n{n}_dev{world}_pairs_per_sec"
        assert (extra["devices"], extra["backend"]) == (world, "gloo")
        if world == 1:          # no send: one cross-form force, bitwise
            assert np.array_equal(q, q1[r0:r1])
            assert np.array_equal(v, v1[r0:r1])
        np.testing.assert_allclose(q, q1[r0:r1], rtol=1e-4, atol=1e-30)
        np.testing.assert_allclose(v, v1[r0:r1], rtol=1e-4, atol=1e-30)


def test_bench_sharded_bodies_flag():
    """`--bodies` is `--n` under another name: torchrun's own parser takes
    `--n` for an abbreviation of its options and refuses it."""
    parse = bench_sharded.build_parser().parse_args
    assert parse(["--bodies", "1048576"]).n == parse(["--n", "1048576"]).n \
        == 1048576
    assert parse([]).n is None


def test_run_golden_f64_byte_equal_on_a_generated_corpus(corpus, tmp_path,
                                                        monkeypatch, capsys):
    out = tmp_path / "port.json"
    assert run_golden.main([
        "--precision", "f64", "--device", "cpu", "--testcases", str(corpus),
        "--cases", "g20,g64", "--n-steps", str(GOLDEN_STEPS), "--out",
        str(out)]) == 0
    lines = capsys.readouterr().out.strip().split("\n")
    assert lines[-1].startswith("SUMMARY ")
    port = json.loads(out.read_text())
    assert [r["case"] for r in port["results"]] == ["g20", "g64"]
    assert all(r["byte_equal"] and r["hit_step_match"] and r["p3_dev_match"]
               and r["min_dist_rel_err"] == 0.0 and r["wall_s"] > 0
               for r in port["results"]), port
    assert port["summary"]["byte_equal"] == 2
    assert [json.loads(x) for x in lines[:-1]] == port["results"]

    # the root harness on the same corpus and horizon, for its keys
    root_mod = _root_script("run_golden")
    monkeypatch.setattr(root_mod, "TESTCASE_DIR", str(corpus))
    monkeypatch.setattr(nbody_tpu, "SimConfig",
                        lambda: JaxSimConfig(n_steps=GOLDEN_STEPS))
    monkeypatch.setattr(sys, "argv", ["run_golden", "--precision", "f64",
                                      "--cases", "g20", "--out",
                                      str(tmp_path / "root.json")])
    root_mod.main()
    root = json.loads((tmp_path / "root.json").read_text())
    assert list(port["results"][0]) == list(root["results"][0])
    assert list(port["summary"]) == list(root["summary"])


def test_run_golden_case_without_golden_is_an_error(corpus, tmp_path):
    (tmp_path / "lone.in").write_bytes((corpus / "g20.in").read_bytes())
    with pytest.raises(FileNotFoundError, match="lone.out"):
        run_golden.main(["--device", "cpu", "--testcases", str(tmp_path),
                         "--cases", "lone", "--n-steps", "5"])


def test_study_f32_horizon_matches_jax_simulate(tmp_path):
    steps = 200
    scene = gen_scene.make_scene(20, seed=5)
    rec, snaps = study_f32_horizon.study(scene, steps, "cpu", "g20")
    chunk = steps // study_f32_horizon.LADDER
    assert [r["steps"] for r in rec["rows"]] == list(
        range(chunk, steps + 1, chunk))
    assert set(rec["wall_s"]) == {"dd", "f32_plain", "f32_kahan"}

    jscene = JaxScene(**{f.name: getattr(scene, f.name)
                         for f in dataclasses.fields(scene)})
    for name, (precision, compensated) in study_f32_horizon.RUNS.items():
        want = {}
        jax_simulate(jscene, JaxSimConfig(), n_steps=steps, chunk=chunk,
                     precision=precision, compensated=compensated,
                     platform="cpu", on_chunk=lambda st: want.__setitem__(
                         st.step, (st.q.copy(), st.v.copy())))
        assert sorted(want) == sorted(snaps[name])
        rtol = 1e-9 if precision == "dd" else 1e-5
        for h, (q, v) in want.items():
            np.testing.assert_allclose(snaps[name][h][0], q, rtol=rtol)
            np.testing.assert_allclose(snaps[name][h][1], v, rtol=rtol)


def test_study_main_writes_the_record(corpus, tmp_path, capsys):
    out = tmp_path / "study.json"
    assert study_f32_horizon.main([
        "--testcases", str(corpus), "--case", "g20", "--steps", "40",
        "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().split("\n")[-1])
    assert rec == json.loads(out.read_text())
    assert (rec["case"], rec["n"], rec["steps"]) == ("g20", 20, 40)
    assert len(rec["rows"]) == study_f32_horizon.LADDER
    assert all(np.isfinite([r["err_plain"], r["err_comp"]]).all()
               for r in rec["rows"])


@pytest.mark.parametrize("logdir", [True, False])
def test_device_trace(tmp_path, logdir):
    where = str(tmp_path / "trace") if logdir else None
    with device_trace(where):
        x = (torch.arange(16.0) * 2).sum()
    assert float(x) == 240.0
    if logdir:
        assert any(f.endswith(".pt.trace.json")
                   for f in os.listdir(where))
    else:
        assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("tool", ["bench", "bench_sharded", "run_golden",
                                  "study_f32_horizon"])
def test_tools_need_a_card_unless_asked_for_the_cpu(corpus, tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"bench": ["--n", "64", "--steps", "1"],
            "bench_sharded": ["--n", "64", "--steps", "1"],
            "run_golden": ["--testcases", str(corpus), "--cases", "g20",
                           "--n-steps", "5"],
            "study_f32_horizon": ["--in", str(corpus / "g20.in"),
                                  "--steps", "5"]}[tool]
    main = {"bench": bench.main, "bench_sharded": bench_sharded.main,
            "run_golden": run_golden.main,
            "study_f32_horizon": study_f32_horizon.main}[tool]
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
