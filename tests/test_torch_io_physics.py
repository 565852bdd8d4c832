"""nbody_tpu_torch io, physics and config against nbody_tpu's.

The framework-free layer of the port must parse, format and tabulate
exactly as the JAX package does: scenes equal bit for bit, `.out` text
byte-equal, the oscillation table bit-equal (host libm on both sides).
"""

import dataclasses
import math

import numpy as np
import pytest

from nbody_tpu import config as jconfig
from nbody_tpu import io as jio
from nbody_tpu import physics as jphys
from nbody_tpu_torch import config as tconfig
from nbody_tpu_torch import io as tio
from nbody_tpu_torch import physics as tphys
from test_fuzz_differential import _fuzz_scene


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _port_scene(s):
    return tio.Scene(**{f.name: getattr(s, f.name)
                        for f in dataclasses.fields(s)})


@pytest.mark.parametrize("seed", [0, 79])
def test_written_scene_reads_back_identically_in_both(tmp_path, seed):
    scene = _port_scene(_fuzz_scene(seed))
    path = str(tmp_path / "s.in")
    tio.write_input(path, scene)
    ours, ref = tio.read_input(path), jio.read_input(path)
    for got in (ours, ref):
        assert (got.n, got.planet, got.asteroid) == \
            (scene.n, scene.planet, scene.asteroid)
        for name in ("q", "v", "m"):
            np.testing.assert_array_equal(_bits(getattr(got, name)),
                                          _bits(getattr(scene, name)))
        assert got.types == scene.types
        np.testing.assert_array_equal(got.device_idx, scene.device_idx)
        np.testing.assert_array_equal(got.device_mask(), scene.device_mask())
    assert ours.device_cnt == ref.device_cnt == 2


@pytest.mark.parametrize("text", [
    "",
    "2 0 1\n0 0 0 0 0 0 1 planet\n",
    "0 0 0\n",
    "1 0 3\n0 0 0 0 0 0 1 planet\n",
    "1 0 0\n0 0 nan 0 0 0 1 planet\n",
    "1 0 0\n0 0 0 0 0 0 -1 planet\n",
])
def test_malformed_input_rejected_by_both(tmp_path, text):
    path = str(tmp_path / "bad.in")
    with open(path, "w") as f:
        f.write(text)
    with pytest.raises(tio.SceneFormatError):
        tio.read_input(path)
    with pytest.raises(jio.SceneFormatError):
        jio.read_input(path)


def test_format_and_parse_output_byte_equal():
    rng = np.random.RandomState(3)
    cases = [(0.0, -2, -1, 0.0), (1e-300, 0, 7, 1e5), (math.pi, 199999, 2,
                                                       1.2e10)]
    cases += [(abs(rng.randn()) * 10.0 ** rng.randint(-20, 20),
               int(rng.randint(-2, 200001)), int(rng.randint(-1, 1024)),
               1e5 + 1e3 * 60.0 * rng.randint(1, 200001))
              for _ in range(50)]
    for c in cases:
        text = tio.format_output(*c)
        assert text == jio.format_output(*c)
        assert tio.parse_output(text) == jio.parse_output(text)
    with pytest.raises(tio.SceneFormatError):
        tio.parse_output("1.0\n2\n")


def test_write_output_matches(tmp_path):
    a, b = str(tmp_path / "a.out"), str(tmp_path / "b.out")
    tio.write_output(a, 2.5e7, 17, 3, 1.06e6)
    jio.write_output(b, 2.5e7, 17, 3, 1.06e6)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("dt,period", [(60.0, 6000.0), (37.5, 1234.5)])
def test_oscillation_table_bit_equal(dt, period):
    tcfg = tconfig.SimConfig(n_steps=20000, dt=dt, device_mass_period=period)
    jcfg = jconfig.SimConfig(n_steps=20000, dt=dt, device_mass_period=period)
    np.testing.assert_array_equal(_bits(tphys.oscillation_table(tcfg)),
                                  _bits(jphys.oscillation_table(jcfg)))
    np.testing.assert_array_equal(
        _bits(tphys.oscillation_table(tcfg, n_steps=7)),
        _bits(jphys.oscillation_table(jcfg, n_steps=7)))


def test_missile_cost_and_distance_bit_equal():
    tcfg, jcfg = tconfig.SimConfig(), jconfig.SimConfig()
    steps = np.arange(0, 200001, 997)
    np.testing.assert_array_equal(
        _bits(tphys.missile_cost_for_arrival(tcfg, steps)),
        _bits(jphys.missile_cost_for_arrival(jcfg, steps)))
    np.testing.assert_array_equal(
        _bits(tphys.missile_travel_distance(tcfg, steps)),
        _bits(jphys.missile_travel_distance(jcfg, steps)))


def test_config_physics_defaults_match():
    """Every field of the port's SimConfig exists in the JAX one with the
    same default; the TPU tile knobs are all that is dropped."""
    ours = {f.name: f.default for f in dataclasses.fields(tconfig.SimConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jconfig.SimConfig)}
    assert set(ref) - set(ours) == {"tile_i", "tile_j"}
    for name, value in ours.items():
        assert ref[name] == value, name
    for precision in ("exact", "f64"):
        assert tconfig.SimConfig().resolved_dist3(precision) == \
            jconfig.SimConfig().resolved_dist3(precision)
