"""The yardstick on the CPU: scenes, references, work counts, controls."""

import json
import os
import sys

import bench_fuzz
import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference import hw5, plummer, scenes

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

PHYS = {"n_steps": 300, "dt": 60.0, "eps": 1e-3, "G": 6.674e-11,
        "planet_radius": 1e7, "missile_speed": 1e6, "cost_base": 1e5,
        "cost_per_t": 1e3, "mass_period": 6000.0}


def _cell_template(cell: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "workloads",
                           cell + ".json")) as f:
        return json.load(f)["traffic"]["template"]


@pytest.mark.parametrize("cell", ["hw5-b1024-f64", "hw5-b20-f64"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 98765432123])
def test_cell_template_bodies_as_given_and_stars_far(cell, seed):
    t = _cell_template(cell)
    sc = scenes.graded_scene(t, seed)
    assert len(sc["m"]) == t["n"] and len(sc["types"]) == t["n"]
    for b in t["bodies"]:
        i = b["index"]
        assert sc["types"][i] == b["type"]
        assert sc["q"][i].tolist() == b["q"] and sc["v"][i].tolist() == b["v"]
        assert sc["m"][i] == b["m"]
    stars = [i for i, k in enumerate(sc["types"]) if k == "star"]
    assert len(stars) == t["n"] - len(t["bodies"])
    r = np.linalg.norm(sc["q"][stars], axis=1)
    lo, hi = t["background"]["radius"]
    assert (r >= lo * (1 - 1e-12)).all() and (r <= hi * (1 + 1e-12)).all()
    assert len(sc["devices"]) == 3
    again = scenes.graded_scene(t, seed)
    assert all((again[k] == sc[k]).all() for k in ("q", "v", "m"))


@pytest.mark.parametrize("n,seed", [(1000, 0), (4096, 2 ** 31 + 7)])
def test_plummer_scene_is_the_ports(n, seed):
    from nbody_tpu_torch.models.plummer import plummer_scene

    want = plummer_scene(n, seed=seed % 2 ** 32)
    got = scenes.plummer_scene(n, seed=seed)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_background_is_drawn_from_the_seed():
    t = _cell_template("hw5-b20-f64")
    a, b = scenes.graded_scene(t, 5), scenes.graded_scene(t, 6)
    own = [x["index"] for x in t["bodies"]]
    stars = np.setdiff1d(np.arange(t["n"]), own)
    for key in ("q", "v", "m"):
        assert (a[key][own] == b[key][own]).all()
        assert not (a[key][stars] == b[key][stars]).any()


def _solve_native(sc: dict, n_steps: int):
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.io import Scene
    from nbody_tpu_torch.native import solve_exact

    scene = Scene(n=len(sc["m"]), planet=sc["planet"],
                  asteroid=sc["asteroid"], q=sc["q"], v=sc["v"], m=sc["m"],
                  types=sc["types"], device_idx=sc["devices"])
    return solve_exact(scene, SimConfig(n_steps=n_steps), dist3_mode="dsqrt")


@pytest.mark.parametrize("strategy", ["batched", "sequential"])
@pytest.mark.parametrize("template,seed", [
    ((103, 20, 3), None), ((103, 20, 3), 98765432123), ((1, 64, 3), 7),
    ((2, 32, 4), None)])
def test_reference_is_the_native_core_bitwise(template, seed, strategy):
    """The plain reference's `.out` is byte-equal to the native serial
    core's in dsqrt mode (the spec program), whichever order Problem 3's
    scenarios run in."""
    sc = bench_fuzz.fuzz_scene(*template) if seed is None \
        else scenes.graded_scene(bench_fuzz.template(*template), seed)
    ref = hw5.solve(sc, PHYS, chunk=64, strategy=strategy)
    assert ref.text() == "%.16e\n%d\n%d %.16e\n" % _solve_native(
        sc, PHYS["n_steps"])


@pytest.mark.parametrize("cell,keep,want", [
    ("hw5-b20-f64", None, (138784, -1)),
    ("hw5-b1024-f64", 40, (148198, 1022))])
def test_cell_template_gives_the_assignments_answers(cell, keep, want):
    """Over the full horizon the template's encounter gives the recorded
    answers of the assignment's testcase of its size (hit step, winning
    device) on two seeds; b1024's own bodies are kept with the first of
    its stars only, as the native core is serial."""
    t = _cell_template(cell)
    for seed in (11, 2 ** 31 + 5):
        sc = scenes.graded_scene(t, seed)
        if keep is not None:
            own = sorted(b["index"] for b in t["bodies"])
            idx = sorted(own + [i for i in range(t["n"]) if i not in own]
                         [:keep - len(own)])
            where = {old: new for new, old in enumerate(idx)}
            sc = {"q": sc["q"][idx], "v": sc["v"][idx], "m": sc["m"][idx],
                  "types": [sc["types"][i] for i in idx],
                  "planet": where[sc["planet"]],
                  "asteroid": where[sc["asteroid"]],
                  "devices": np.asarray([where[d] for d in sc["devices"]])}
        _, hit, dev, _ = _solve_native(sc, 200000)
        if keep is not None and dev != -1:
            dev = idx[dev]
        assert (hit, dev) == want


def test_work_counts_by_hand():
    """A short scene over 300 steps: P1 300 row-steps, P2 up to its hit at
    90, P3 from the first arrival (device 2 at 4, then 4 at 17 and 3 at
    38) to the horizon, as device 2 saves and no later one can be
    cheaper."""
    sc = bench_fuzz.fuzz_scene(103, 20, 3)
    for strategy in ("batched", "sequential"):
        ref = hw5.solve(sc, PHYS, strategy=strategy)
        assert (ref.hit_step, ref.device_id) == (90, 2)
        assert (ref.p1_steps, ref.p2_steps, ref.p3_steps) == (300, 90, [296])
        assert ref.row_steps == 300 + 90 + 296
    pairs = 20 * 20 * ref.row_steps
    ctx = {"trace": {"kernel_s": pairs * 20 / 34e12}, "work": {
        "pairs": pairs, "precision": "f64"}}
    assert roofline.kernel_share(ctx) == pytest.approx(100.0)
    ctx["trace"]["kernel_s"] *= 4
    assert roofline.kernel_share(ctx) == pytest.approx(25.0)
    assert roofline.OPS_PER_PAIR == 20
    assert roofline.PEAK_FLOPS == {"f32": 67e12, "f64": 34e12}


def test_readers_return_nothing_without_a_trace():
    assert roofline.kernel_share({"trace": None, "work": None}) is None
    assert roofline.idle_share({"trace": None}) is None
    t = {"busy_s": 0.0, "window_s": 1.0, "kernel_s": 0.0}
    assert roofline.idle_share({"trace": t}) is None
    t = {"busy_s": 0.75, "window_s": 1.0, "kernel_s": 0.5}
    assert roofline.idle_share({"trace": t}) == pytest.approx(25.0)


def test_hw5_control_fails():
    """The control, the reference in float32, fails the limit 0 of the
    graded cells (here at 300 steps of a short scene)."""
    sc = bench_fuzz.fuzz_scene(103, 20, 3)
    ref = hw5.solve(sc, PHYS)
    low = hw5.solve(sc, PHYS, dtype=torch.float32)
    got = hw5.compare([low.text()], ref)
    assert got["outs_unequal"] == 1 and got["min_dist_rel_gap"] > 0
    same = hw5.compare([ref.text(), ref.text()], ref)
    assert not any(same.values())
    bad = hw5.compare([None, "garbage"], ref)
    assert bad["outs_unequal"] == 2 and bad["min_dist_rel_gap"] == np.inf


def test_plummer_force_against_the_pairwise_sum():
    q, v, m = scenes.plummer_scene(700, seed=3)
    qt, gm = torch.tensor(q), torch.tensor(m) * 6.674e-11
    a = plummer.accel(qt, gm, 1e-3, block=256)
    dq = qt[None, :, :] - qt[:, None, :]
    w = gm[None, :] / ((dq * dq).sum(-1) + 1e-6) ** 1.5
    w.fill_diagonal_(0)
    want = (w[..., None] * dq).sum(1)
    assert ((a - want).norm(dim=1) / want.norm(dim=1)).max() < 1e-10


def test_plummer_control_fails():
    """The bfloat16 control reads far above the float32 cell's limits;
    the float64 reference against itself reads 0."""
    q, v, m = scenes.plummer_scene(256, seed=4)
    kw = {"n_steps": 20, "G": 6.674e-11, "eps": 1e-3, "dt": 60.0,
          "device": "cpu"}
    ref = plummer.march(q, v, m, **kw)
    low = plummer.march(q, v, m, dtype=torch.bfloat16, **kw)
    assert min(plummer.gaps([low], ref, q, v).values()) > 0.1
    assert max(plummer.gaps([ref], ref, q, v).values()) == 0.0
    bad = plummer.gaps([(q * np.nan, v)], ref, q, v)
    assert set(bad.values()) == {np.inf}
