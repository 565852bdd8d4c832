"""The port's CLI (`python -m nbody_tpu_torch`) and its import isolation."""

import json
import os
import subprocess
import sys

import pytest
import torch

from nbody_tpu import io as jio
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu.native import solve_exact
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.io import Scene, write_input
from test_fuzz_differential import N_STEPS, _fuzz_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _native_built():
    """Build the native core under the port's lock before the JAX
    package's binding (which builds unlocked) looks for it."""
    from nbody_tpu_torch.native import build
    build("libnbody_core.so")


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def _scene_file(tmp_path, seed):
    s = _fuzz_scene(seed)
    path = str(tmp_path / f"s{seed}.in")
    write_input(path, Scene(n=s.n, planet=s.planet, asteroid=s.asteroid,
                            q=s.q, v=s.v, m=s.m, types=s.types,
                            device_idx=s.device_idx))
    return s, path


def _native_text(scene, n_steps, mode):
    cfg = JaxSimConfig(n_steps=n_steps, dist3_mode=mode)
    return jio.format_output(*solve_exact(scene, cfg, dist3_mode=mode))


def test_cli_out_byte_equal_to_native(tmp_path):
    scene, inp = _scene_file(tmp_path, 79)      # a hit saved by a device
    out = str(tmp_path / "o.out")
    r = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", inp, out, "--device", "cpu",
         "--n-steps", str(N_STEPS), "--stats"],
        capture_output=True, text=True, cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        assert f.read() == _native_text(scene, N_STEPS, "dsqrt")
    stats = json.loads(r.stderr.strip().split("\n")[-1])
    assert stats["n"] == 16 and stats["n_steps"] == N_STEPS
    assert stats["device"] == "cpu" and stats["accel_f64_launches"] == 0
    assert "problems_fused" in stats["phases_s"]


def test_cli_exact_is_the_native_core(tmp_path):
    scene, inp = _scene_file(tmp_path, 91)
    out = str(tmp_path / "o.out")
    assert main([inp, out, "--precision", "exact", "--n-steps", "60"]) == 0
    with open(out) as f:
        assert f.read() == _native_text(scene, 60, "pow")


@pytest.mark.parametrize("args", [["--precision", "f16"],
                                  ["--device", "tpu"], []])
def test_cli_rejects_bad_arguments(tmp_path, args):
    with pytest.raises(SystemExit) as e:
        main(([] if not args else ["a.in", "b.out"]) + args)
    assert e.value.code == 2


@pytest.mark.parametrize("precision", ["dd", "ddp", "dd+"])
def test_cli_f64_aliases_byte_equal_to_native(tmp_path, precision):
    scene, inp = _scene_file(tmp_path, 79)
    out = str(tmp_path / "o.out")
    assert main([inp, out, "--device", "cpu", "--precision", precision,
                 "--n-steps", str(N_STEPS)]) == 0
    with open(out) as f:
        assert f.read() == _native_text(scene, N_STEPS, "dsqrt")


def test_cli_f32_writes_the_f32_answers(tmp_path, capsys):
    from nbody_tpu_torch import SimConfig, solve_scene
    from nbody_tpu_torch.io import format_output

    scene, inp = _scene_file(tmp_path, 91)
    out = str(tmp_path / "o.out")
    assert main([inp, out, "--device", "cpu", "--precision", "f32",
                 "--n-steps", str(N_STEPS), "--stats"]) == 0
    want = solve_scene(Scene(n=scene.n, planet=scene.planet,
                             asteroid=scene.asteroid, q=scene.q, v=scene.v,
                             m=scene.m, types=scene.types,
                             device_idx=scene.device_idx),
                       SimConfig(n_steps=N_STEPS), precision="f32",
                       device="cpu")
    with open(out) as f:
        assert f.read() == format_output(*want.as_tuple())
    stats = json.loads(capsys.readouterr().err.strip().split("\n")[-1])
    assert stats["precision"] == "f32"
    assert stats["accel_f32_launches"] == stats["accel_f64_launches"] == 0


def test_cli_tf3_writes_the_tf3_answers(tmp_path, capsys):
    from nbody_tpu_torch import SimConfig, solve_scene
    from nbody_tpu_torch.io import format_output

    scene, inp = _scene_file(tmp_path, 79)
    out = str(tmp_path / "o.out")
    assert main([inp, out, "--device", "cpu", "--precision", "tf3",
                 "--n-steps", "60", "--stats"]) == 0
    want = solve_scene(Scene(n=scene.n, planet=scene.planet,
                             asteroid=scene.asteroid, q=scene.q, v=scene.v,
                             m=scene.m, types=scene.types,
                             device_idx=scene.device_idx),
                       SimConfig(n_steps=60), precision="tf3", device="cpu")
    with open(out) as f:
        assert f.read() == format_output(*want.as_tuple())
    stats = json.loads(capsys.readouterr().err.strip().split("\n")[-1])
    assert stats["precision"] == "tf3"
    assert stats["accel_dd_launches"] == stats["graded_step_dd_launches"] \
        == 0


def test_cli_cuda_without_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, inp = _scene_file(tmp_path, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        main([inp, str(tmp_path / "o.out"), "--n-steps", "5"])


def test_profile_cli_needs_a_card(tmp_path):
    """The profiler measures the card or fails; it never profiles a CPU
    run in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nbody_tpu_torch.scripts.profile_cli import main as profile_main

    _, inp = _scene_file(tmp_path, 0)
    with pytest.raises(SystemExit, match="CUDA card"):
        profile_main(["--", inp, str(tmp_path / "o.out"), "--device", "cpu",
                      "--n-steps", "5"])


def test_port_imports_neither_jax_nor_nbody_tpu(tmp_path):
    """Every module of the port imports, and a CPU solve runs, with neither
    `jax` nor `nbody_tpu` ever entering sys.modules."""
    _, inp = _scene_file(tmp_path, 5)
    code = (
        "import importlib, pkgutil, sys\n"
        "import nbody_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nbody_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from nbody_tpu_torch.cli import main\n"
        f"main([{inp!r}, {str(tmp_path / 'o.out')!r}, '--device', 'cpu',"
        " '--n-steps', '20'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nbody_tpu'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "isolated"
