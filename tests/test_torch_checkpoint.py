"""Checkpoint/resume of the graded solve (`checkpoint_path`, `--checkpoint`).

The JAX package's contract (nbody_tpu/models/direct_sum.py:538-623,
748-800, 912-986): every driver saves its whole carry after each chunk and
resumes from the file; a resumed run is bitwise equal to one that never
stopped. Runs are stopped two ways: truncated (a run to half the horizon
leaves its checkpoint, and the full horizon resumes from it, the
preemption pattern the fingerprint's omission of n_steps is for) and
interrupted (a chunk raises mid-run, as a kill would). Each case in f64,
f32 (the rescaled scene) and tf3 (double-double), on the plain chunks;
chip_smoke.py repeats it through the step kernels on a card. The phased
drivers run at n=16 here (the engine's fused limit patched to 0), where
they take a second; the fingerprint, not n, tells the drivers apart.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from nbody_tpu_torch import Scene, SimConfig, engine, solve_scene
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.io import format_output, write_input
from nbody_tpu_torch.models import direct_sum as ds
from nbody_tpu_torch.ops import graded_step as gs
from nbody_tpu_torch.physics import oscillation_table
from nbody_tpu_torch.utils.checkpoint import load_checkpoint
from test_fuzz_differential import _fuzz_scene

STEPS, CHUNK = 240, 16
CFG = SimConfig(n_steps=STEPS, chunk_steps=CHUNK)
PRECISIONS = ["f64", "f32", "tf3"]
CPU = torch.device("cpu")
ONE = ds.OneDevice(CPU)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def phased(monkeypatch):
    """The phased drivers at any n."""
    monkeypatch.setattr(engine, "FUSED_MAX_N", 0)


def _port(s) -> Scene:
    return Scene(**{f.name: getattr(s, f.name) for f in dataclasses.fields(s)})


def _bits(ans):
    md, hs, dev, cost = ans.as_tuple()
    return np.float64(md).tobytes(), hs, dev, np.float64(cost).tobytes()


def _solve(scene, n_steps=STEPS, precision="f64", **kw):
    return solve_scene(scene, dataclasses.replace(CFG, n_steps=n_steps),
                       precision=precision, device="cpu", **kw)


class _Interrupt(Exception):
    pass


def _interrupting(monkeypatch, mode, after):
    """graded_chunk in the drivers raises on the (after+1)-th chunk of
    `mode`; returns the counts of chunks run by mode."""
    calls = {gs.P12: 0, gs.P3: 0, gs.P123: 0}
    orig = gs.graded_chunk

    def chunk(m, c, s0, s1):
        if m == mode and after is not None and calls[m] >= after:
            raise _Interrupt(f"stopped before chunk {s0}..{s1}")
        calls[m] += 1
        orig(m, c, s0, s1)

    monkeypatch.setattr(ds, "graded_chunk", chunk)
    return calls


@pytest.mark.parametrize("stop", [96, 192], ids=["before_exit", "after_exit"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_p12_truncated_then_resumed(phased, tmp_path, precision, stop):
    """Seed 5 hits at step 148: a stop at 96 saves two rows (phase 'p12'),
    one at 192 the devices-off row alone (phase 'p1', after the P2 early
    exit at the chunk from 160); the resumed run carries on from there and
    runs Problem 3."""
    scene = _port(_fuzz_scene(5))
    want = _solve(scene, precision=precision)
    ck = str(tmp_path / "run.ck")
    _solve(scene, stop, precision, checkpoint_path=ck)
    step, q, _, extra, meta = load_checkpoint(ck)
    assert step == stop and meta["n_steps"] == stop
    assert meta["phase"] == ("p12" if stop < 148 else "p1")
    assert q.shape[0] == (2 if stop < 148 else 1)
    assert q.shape[-1] == (2 if precision == "tf3" else 3)
    assert set(extra) == {"min_d2", "hit", "arr", "q_snap", "v_snap"}
    got = _solve(scene, precision=precision, checkpoint_path=ck)
    assert _bits(got) == _bits(want)
    assert load_checkpoint(ck)[0] == STEPS


def test_p12_resume_runs_only_the_steps_left(phased, tmp_path, monkeypatch):
    scene = _port(_fuzz_scene(5))
    ck = str(tmp_path / "run.ck")
    _solve(scene, 96, checkpoint_path=ck)
    calls = _interrupting(monkeypatch, None, None)
    fst = oscillation_table(CFG)
    resumed = ds.run_problems_12(scene, fst, CFG, layout=ONE,
                                 checkpoint_path=ck)
    assert calls[gs.P12] == (STEPS - 96) // CHUNK
    whole = ds.run_problems_12(scene, fst, CFG, layout=ONE)
    assert resumed.min_dist == whole.min_dist
    assert resumed.hit_time_step == whole.hit_time_step
    np.testing.assert_array_equal(resumed.arrivals, whole.arrivals)
    for a, b in ((resumed.q_snaps, whole.q_snaps),
                 (resumed.v_snaps, whole.v_snaps)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_p12_interrupted_then_resumed(phased, tmp_path, monkeypatch,
                                      precision):
    scene = _port(_fuzz_scene(79))
    want = _solve(scene, precision=precision)
    ck = str(tmp_path / "run.ck")
    _interrupting(monkeypatch, gs.P12, 5)
    with pytest.raises(_Interrupt):
        _solve(scene, precision=precision, checkpoint_path=ck)
    assert load_checkpoint(ck)[0] == 5 * CHUNK
    calls = _interrupting(monkeypatch, None, None)
    assert _bits(_solve(scene, precision=precision,
                        checkpoint_path=ck)) == _bits(want)
    assert calls[gs.P12] == STEPS // CHUNK - 5


@pytest.mark.parametrize("precision", PRECISIONS)
def test_p3_batched_interrupted_then_resumed(phased, tmp_path, monkeypatch,
                                             precision):
    """Seed 91: device 2 saves the planet, so its Problem-3 row runs to the
    horizon; the run stops after three Problem-3 chunks and the rerun takes
    Problem 1+2 from its finished checkpoint and Problem 3 from the
    sidecar."""
    scene = _port(_fuzz_scene(91))
    calls = _interrupting(monkeypatch, None, None)
    want = _solve(scene, precision=precision)
    p3_chunks = calls[gs.P3]
    assert want.gravity_device_id != -1 and p3_chunks > 3
    ck = str(tmp_path / "run.ck")
    _interrupting(monkeypatch, gs.P3, 3)
    with pytest.raises(_Interrupt):
        _solve(scene, precision=precision, checkpoint_path=ck)
    assert os.path.exists(ck + ".p3.npz")
    calls = _interrupting(monkeypatch, None, None)
    assert _bits(_solve(scene, precision=precision,
                        checkpoint_path=ck)) == _bits(want)
    assert calls == {gs.P12: 0, gs.P3: p3_chunks - 3, gs.P123: 0}


@pytest.mark.parametrize("precision", PRECISIONS)
def test_p3_sequential_progress_file(phased, tmp_path, monkeypatch,
                                     precision):
    """Seed 5, sequential: device slot 1 (arrival 10) is hit and recorded
    in the progress file; the run stops inside slot 0's scenario, whose
    state file the rerun resumes."""
    monkeypatch.setattr(engine, "run_problem_3", functools.partial(
        ds.run_problem_3, strategy="sequential"))
    scene = _port(_fuzz_scene(5))
    calls = _interrupting(monkeypatch, None, None)
    want = _solve(scene, precision=precision)
    total = calls[gs.P3]
    ck = str(tmp_path / "run.ck")
    calls = _interrupting(monkeypatch, gs.P3, total - 2)
    with pytest.raises(_Interrupt):
        _solve(scene, precision=precision, checkpoint_path=ck)
    with open(ck + ".p3progress.json") as f:
        rec = json.load(f)
    assert rec["results"] == {"1": False} and rec["n_steps"] == STEPS
    assert load_checkpoint(ck + ".p3.npz")[4]["idx"] == [0]
    calls = _interrupting(monkeypatch, None, None)
    assert _bits(_solve(scene, precision=precision,
                        checkpoint_path=ck)) == _bits(want)
    assert calls[gs.P3] == 2 and calls[gs.P12] == 0
    assert not os.path.exists(ck + ".p3.npz")


def test_p3_sequential_saviour_of_a_shorter_horizon_runs_again(
        phased, tmp_path, monkeypatch):
    """A scenario never hit up to a truncated horizon is not decided for a
    longer one: the full run computes it again (a hit would be final)."""
    monkeypatch.setattr(engine, "run_problem_3", functools.partial(
        ds.run_problem_3, strategy="sequential"))
    scene = _port(_fuzz_scene(91))
    want = _solve(scene)
    ck = str(tmp_path / "run.ck")
    _solve(scene, 120, checkpoint_path=ck)
    with open(ck + ".p3progress.json") as f:
        assert json.load(f) ["results"] == {"0": True}
    assert _bits(_solve(scene, checkpoint_path=ck)) == _bits(want)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_truncated_then_resumed(tmp_path, precision):
    scene = _port(_fuzz_scene(79))
    want = _solve(scene, precision=precision)
    ck = str(tmp_path / "fused.ck")
    _solve(scene, STEPS // 2, precision, checkpoint_path=ck)
    meta = load_checkpoint(ck)[4]
    assert meta["phase"] == "p123" and meta["fingerprint"].endswith(":p123")
    assert _bits(_solve(scene, precision=precision,
                        checkpoint_path=ck)) == _bits(want)


def test_fused_refuses_a_phased_checkpoint_and_back(tmp_path, monkeypatch):
    scene = _port(_fuzz_scene(1))
    ck = str(tmp_path / "phased.ck")
    monkeypatch.setattr(engine, "FUSED_MAX_N", 0)
    _solve(scene, STEPS // 2, checkpoint_path=ck)
    monkeypatch.setattr(engine, "FUSED_MAX_N", 128)
    with pytest.raises(ValueError, match="refusing to resume"):
        _solve(scene, checkpoint_path=ck)
    fused = str(tmp_path / "fused.ck")
    _solve(scene, STEPS // 2, checkpoint_path=fused)
    monkeypatch.setattr(engine, "FUSED_MAX_N", 0)
    with pytest.raises(ValueError, match="refusing to resume"):
        _solve(scene, checkpoint_path=fused)


@pytest.mark.parametrize("change", ["scene", "precision", "config"])
def test_refuses_another_runs_checkpoint(tmp_path, change):
    scene = _port(_fuzz_scene(79))
    ck = str(tmp_path / "run.ck")
    _solve(scene, 64, checkpoint_path=ck)
    kw = {"precision": "f64"}
    if change == "scene":
        scene = dataclasses.replace(scene, v=scene.v * 2)
    elif change == "precision":
        kw["precision"] = "tf3"
    with pytest.raises(ValueError, match="refusing to resume"):
        if change == "config":
            solve_scene(scene, dataclasses.replace(CFG, dt=30.0),
                        device="cpu", checkpoint_path=ck)
        else:
            _solve(scene, checkpoint_path=ck, **kw)


def test_refuses_a_checkpoint_beyond_the_horizon(phased, tmp_path):
    scene = _port(_fuzz_scene(0))
    ck = str(tmp_path / "run.ck")
    _solve(scene, checkpoint_path=ck)
    with pytest.raises(ValueError, match="beyond"):
        _solve(scene, STEPS // 2, checkpoint_path=ck)


def test_fingerprints_name_each_representation():
    """f64, f32 and double-double fingerprints differ, and none is the
    JAX package's 'tf3' one, so a triple-float32 carry is refused, not
    misread; the f64 one is the JAX package's own."""
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.models.direct_sum import _solver_fingerprint

    s = _fuzz_scene(3)
    cfg = SimConfig(dist3_mode="dsqrt")
    jcfg = dataclasses.replace(JaxSimConfig(), dist3_mode="dsqrt")
    prints = {d: ds._fingerprint(_port(s), cfg, d)
              for d in (torch.float64, torch.float32, ds.DD)}
    assert len(set(prints.values())) == 3
    assert prints[torch.float64] == _solver_fingerprint(s, jcfg, np.float64,
                                                        False)
    assert prints[torch.float32] == _solver_fingerprint(s, jcfg, np.float32,
                                                        True)
    assert _solver_fingerprint(s, jcfg, "tf3", False) not in prints.values()


def test_jax_layout_both_ways(tmp_path):
    """The port's P1+P2 checkpoint holds the JAX package's keys, shapes and
    meta, and loads with its reader; a checkpoint the JAX package wrote
    (f64 on the CPU) is accepted by the port, which resumes it to the
    horizon within the JAX f64 tolerance of its own run."""
    from nbody_tpu import SimConfig as JaxSimConfig
    from nbody_tpu.models.direct_sum import run_problems_12 as jax_p12
    from nbody_tpu.physics import oscillation_table as jax_fst
    from nbody_tpu.utils.checkpoint import load_checkpoint as jax_load

    s = _fuzz_scene(5)
    cfg = SimConfig(n_steps=48, chunk_steps=CHUNK, dist3_mode="dsqrt")
    jcfg = dataclasses.replace(JaxSimConfig(), n_steps=48,
                               dist3_mode="dsqrt")
    mine, theirs = str(tmp_path / "port.ck"), str(tmp_path / "jax.ck")
    ds.run_problems_12(_port(s), oscillation_table(cfg), cfg, layout=ONE,
                       checkpoint_path=mine)
    jax_p12(s, jax_fst(jcfg), jcfg, host_chunk=CHUNK, checkpoint_path=theirs)
    a, b = jax_load(mine), jax_load(theirs)
    assert a[0] == b[0] == 48
    assert a[1].shape == b[1].shape and a[1].dtype == b[1].dtype
    assert set(a[3]) == set(b[3])
    for k in a[3]:
        assert a[3][k].shape == b[3][k].shape, k
    assert a[4] == b[4]                  # n_steps, fingerprint, phase
    full = dataclasses.replace(cfg, n_steps=96)
    fst = oscillation_table(full)
    resumed = ds.run_problems_12(_port(s), fst, full, layout=ONE,
                                 checkpoint_path=theirs)
    own = ds.run_problems_12(_port(s), fst, full, layout=ONE)
    assert resumed.min_dist == pytest.approx(own.min_dist, rel=1e-9)
    np.testing.assert_array_equal(resumed.arrivals, own.arrivals)


@pytest.mark.parametrize("precision", ["f64", "tf3"])
def test_cli_checkpoint(tmp_path, precision):
    s = _fuzz_scene(91)
    inp = str(tmp_path / "s.in")
    write_input(inp, _port(s))
    ck, out = str(tmp_path / "run.ck"), str(tmp_path / "o.out")
    args = [inp, out, "--device", "cpu", "--precision", precision,
            "--checkpoint", ck]
    assert main(args + ["--n-steps", str(STEPS // 2)]) == 0
    assert load_checkpoint(ck)[0] == STEPS // 2
    assert main(args + ["--n-steps", str(STEPS)]) == 0
    whole = solve_scene(_port(s), SimConfig(n_steps=STEPS),
                        precision=precision, device="cpu")
    with open(out) as f:
        assert f.read() == format_output(*whole.as_tuple())
    if precision == "f64":
        from nbody_tpu import SimConfig as JaxSimConfig
        from nbody_tpu.native import solve_exact
        want = solve_exact(s, dataclasses.replace(
            JaxSimConfig(), n_steps=STEPS, dist3_mode="dsqrt"),
            dist3_mode="dsqrt")
        assert format_output(*whole.as_tuple()) == format_output(*want)
