"""The harness on the CPU: a run end to end at a tiny size (the program's
plain versions), cells and metrics added by files alone, the refusals,
and `correct` coming out false with the timed path broken underneath."""

import json
import os
import shutil

import bench_fuzz
import pytest
import torch

from benchmark import run
from benchmark.cells import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 12345          # more than 32 signed bits hold

TINY = {
    # cell: (config, changes to it, traffic, limits)
    "tiny-graded": ("hw5-graded-f64", {"constants.n_steps": 300},
                    {"name": "t-fuzz103-n20", "kind": "graded_solves",
                     "template": bench_fuzz.template(103, 20, 3)},
                    "hw5-b20-f64"),
    "tiny-plummer": ("plummer-f32", {},
                     {"name": "t-calls-n256", "kind": "simulate_calls",
                      "n": 256, "n_steps": 40, "chunk": 10},
                     "plummer-n65536-f32"),
}

DUMMY_METRIC = '''"""dummy.requests: the requests the window completed."""


def read(ctx):
    return float(ctx["requests"])
'''

# a metric without a `workloads` key: read in every cell that reports the
# end-to-end metric it moves
DUMMY_EVERYWHERE = '''"""dummy.window_s: the window's length."""


def read(ctx):
    return ctx["window_s"]
'''


@pytest.fixture
def root(tmp_path):
    """A checkout's benchmark with two tiny cells and a dummy metric, each
    added as files and entries of BENCHMARK.json alone."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    bdir = tmp_path / "benchmark"
    for cell, (config, changes, traffic, like) in TINY.items():
        with open(bdir / "configs" / f"{config}.json") as f:
            cfg = json.load(f)
        for key, value in changes.items():
            cfg["constants"][key.split(".")[1]] = value
        cfg["name"] = cell + "-config"
        (bdir / "configs" / f"{cell}-config.json").write_text(
            json.dumps(cfg))
        with open(bdir / "workloads" / f"{like}.json") as f:
            limits = json.load(f)["limits"]
        body = {"name": cell, "config": cell + "-config", "chips": 1,
                "traffic": traffic, "limits": limits, "why": "a test"}
        (bdir / "workloads" / f"{cell}.json").write_text(json.dumps(body))
        spec["workloads"].append({"name": cell, "config": cell + "-config",
                                  "traffic": traffic["name"], "chips": 1,
                                  "why": "a test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (bdir / "metrics" / "dummy.requests.py").write_text(DUMMY_METRIC)
    (bdir / "metrics" / "dummy.window_s.py").write_text(DUMMY_EVERYWHERE)
    spec["per_layer"].append({
        "name": "dummy.requests", "unit": "1", "better": "higher",
        "source": "host_clock", "layer": "harness", "moves": "setup_s",
        "workloads": list(TINY)})
    spec["per_layer"].append({
        "name": "dummy.window_s", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "harness", "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(tmp_path)


@pytest.mark.parametrize("name,trace", [
    ("tiny-graded", False), ("tiny-graded", True), ("tiny-plummer", False),
    ("tiny-plummer", True)])
def test_run_end_to_end_on_cpu(root, name, trace):
    r = run.run_cell(Bench(root), name, SEED, 0.5, trace, device="cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    e2e = "graded_solve_s" if "graded" in name else "sim_pairs_per_s"
    if trace:
        assert r["metrics"]["dummy.requests"]["value"] == r["attempted"]
        assert r["metrics"]["dummy.window_s"]["value"] > 0
        assert e2e not in r["metrics"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        if "graded" in name:
            assert r["metrics"]["graded.capture_s"]["value"] == 0.0
    else:
        assert set(r["metrics"]) == {e2e, "setup_s"}
        assert r["metrics"][e2e]["value"] > 0
    json.dumps(r)


def test_a_new_cell_and_metric_are_files_alone(root):
    b = Bench(root)
    assert [m["name"] for m in b.per_layer("tiny-graded")][-2:] == \
        ["dummy.requests", "dummy.window_s"]
    # without a `workloads` key a metric is read in every cell, those of
    # BENCHMARK.json as they stand too
    for cell in ("hw5-b20-f64", "plummer-n65536-f32"):
        names = [m["name"] for m in b.per_layer(cell)]
        assert "dummy.window_s" in names and "dummy.requests" not in names
    assert b.reader("dummy.requests").read({"requests": 3}) == 3.0
    assert b.cell("tiny-plummer")[1]["name"] == "tiny-plummer-config"
    real = Bench(ROOT)
    for cell in ("tiny-graded", "tiny-plummer"):
        with pytest.raises(ValueError):
            real.cell(cell)


@pytest.mark.parametrize("names,found", [
    (["nbody_tpu_torch", "nbody_tpu_torch.cli", "torch", "jaxtyping",
      "flaxen", "benchmark.run"], []),
    (["nbody_tpu", "nbody_tpu.ops", "nbody_tpu_torch"],
     ["nbody_tpu", "nbody_tpu.ops"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"])])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert run.forbidden_modules(names) == found


def test_a_run_that_loads_jax_prints_nothing(root, monkeypatch, capsys):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nbody_tpu", types.ModuleType("x"))
    with pytest.raises(run.ForbiddenModules, match="nbody_tpu"):
        run.run_cell(Bench(root), "tiny-plummer", SEED, 0.1, False,
                     device="cpu")
    assert capsys.readouterr().out == ""


def test_no_card_no_result(capsys):
    """Without the card a cell asks for, a run refuses and prints no
    result: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    for cell in ("hw5-b20-f64", "plummer-n65536-f32"):
        rc = run.main(["--workload", cell, "--seed", str(SEED),
                       "--seconds", "1", "--trace", "0"])
        assert rc == 2
        assert capsys.readouterr().out == ""


def _simulate_module():
    """The module nbody_tpu_torch.simulate (the package's attribute of that
    name is the function)."""
    import importlib

    return importlib.import_module("nbody_tpu_torch.simulate")


def _unchanged_step(monkeypatch, kind):
    if kind == "graded":
        monkeypatch.setattr("nbody_tpu_torch.models.direct_sum.graded_chunk",
                            lambda *a, **k: None)
    else:
        monkeypatch.setattr(_simulate_module(), "sim_chunk_f32",
                            lambda *a, **k: None)


def _half_the_sources(monkeypatch, kind):
    """The force folds the first half of the bodies and leaves out the
    rest."""
    mod, name = ("nbody_tpu_torch.ops.accel_f64", "accel_f64_ref") \
        if kind == "graded" else ("nbody_tpu_torch.ops.sim_step",
                                  "accel_f32_ref")
    import importlib

    orig = getattr(importlib.import_module(mod), name)

    def half(qi, qj, gm, **kw):
        h = qj.shape[-2] // 2
        return orig(qi, qj[..., :h, :].contiguous(),
                    gm[..., :h].contiguous(), **kw)

    monkeypatch.setattr(f"{mod}.{name}", half)


def _altered_answer(monkeypatch, kind):
    if kind == "graded":
        import nbody_tpu_torch.io as pio

        orig = pio.write_output

        def write(path, min_dist, *rest):
            orig(path, min_dist * (1 + 2 ** -50), *rest)

        monkeypatch.setattr(pio, "write_output", write)
    else:
        ps = _simulate_module()
        orig = ps._march

        def march(*a, **k):
            st = orig(*a, **k)
            st.q[0] *= 1.01
            return st

        monkeypatch.setattr(ps, "_march", march)


@pytest.mark.parametrize("kind", ["graded", "plummer"])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_the_sources,
                                   _altered_answer],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, kind, fault):
    fault(monkeypatch, kind)
    r = run.run_cell(Bench(root), f"tiny-{kind}", SEED, 0.2, False,
                     device="cpu")
    assert r["correct"] is False
    assert any(not (isinstance(c["value"], (int, float))
                    and c["value"] <= c["limit"])
               for c in r["checks"].values())
