"""The port's host helpers against the JAX package's: rescale exponents,
Plummer arrays, the checkpoint format (both directions) and the
conserved-quantity diagnostics (float64, rtol 1e-12)."""

import dataclasses

import numpy as np
import pytest
import torch

from nbody_tpu.io import Scene as JaxScene
from nbody_tpu.models import plummer as jplummer
from nbody_tpu.utils import checkpoint as jckpt
from nbody_tpu.utils import diagnostics as jdiag
from nbody_tpu.utils import rescale as jrescale
from nbody_tpu_torch import SimConfig
from nbody_tpu_torch.io import Scene
from nbody_tpu_torch.models import plummer as tplummer
from nbody_tpu_torch.utils import checkpoint as tckpt
from nbody_tpu_torch.utils import diagnostics as tdiag
from nbody_tpu_torch.utils import rescale as trescale
from test_fuzz_differential import _fuzz_scene

G, EPS = 6.674e-11, 1e-3


def _port(scene) -> Scene:
    return Scene(**{f.name: getattr(scene, f.name)
                    for f in dataclasses.fields(scene)})


def _scene(q, v, m) -> JaxScene:
    n = len(m)
    return JaxScene(n=n, planet=0, asteroid=min(1, n - 1), q=q, v=v, m=m,
                    types=["star"] * n, device_idx=np.zeros(0, np.int64))


def _bits(a):
    return np.asarray(a, np.float64).view(np.uint64)


RESCALE_SCENES = {
    **{f"fuzz{s}": (lambda s=s: _fuzz_scene(s)) for s in (0, 5, 17, 64)},
    "plummer": lambda: _scene(*jplummer.plummer_scene(300, seed=2)),
    "zero_mass": lambda: _scene(np.ones((3, 3)), np.zeros((3, 3)),
                                np.zeros(3)),
    "at_origin": lambda: _scene(np.zeros((2, 3)), np.ones((2, 3)),
                                np.ones(2)),
}


@pytest.mark.parametrize("anchor", [False, True])
@pytest.mark.parametrize("name", list(RESCALE_SCENES))
def test_compute_rescale_same_exponents(name, anchor):
    scene = RESCALE_SCENES[name]()
    want = jrescale.compute_rescale(scene, eps=EPS, anchor_accel=anchor, G=G)
    got = trescale.compute_rescale(_port(scene), eps=EPS,
                                   anchor_accel=anchor, G=G)
    assert (got.qe, got.me) == (want.qe, want.me)


def test_rescale_applies_like_jax():
    scene = _fuzz_scene(9)
    rs = trescale.compute_rescale(_port(scene))
    jrs = jrescale.Rescale(qe=rs.qe, me=rs.me)
    got, want = rs.apply_scene(_port(scene)), jrs.apply_scene(scene)
    for f in ("q", "v", "m"):
        np.testing.assert_array_equal(_bits(getattr(got, f)),
                                      _bits(getattr(want, f)))
    from nbody_tpu import SimConfig as JaxSimConfig
    gc, wc = rs.apply_cfg(SimConfig()), jrs.apply_cfg(JaxSimConfig())
    for f in ("G", "eps", "planet_radius", "missile_speed", "dt"):
        assert _bits(getattr(gc, f)) == _bits(getattr(wc, f))
    assert rs.unscale_length(3.0) == jrs.unscale_length(3.0)


def test_rescale_empty_window_raises_in_both():
    scene = _scene(np.full((2, 3), 1e60), np.zeros((2, 3)), np.ones(2))
    with pytest.raises(ValueError):
        jrescale.compute_rescale(scene, eps=EPS)
    with pytest.raises(ValueError, match="dynamic range"):
        trescale.compute_rescale(_port(scene), eps=EPS)


@pytest.mark.parametrize("n,seed,kw", [
    (1, 0, {}), (64, 3, {}), (1000, 7, {}),
    (128, 1, {"total_mass": 2e30, "scale_radius": 3e9, "G": 1.0})])
def test_plummer_bit_equal(n, seed, kw):
    got = tplummer.plummer_scene(n, seed=seed, **kw)
    want = jplummer.plummer_scene(n, seed=seed, **kw)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _state(seed):
    rs = np.random.RandomState(seed)
    return rs.randn(16, 3), rs.randn(16, 3), {"snap": rs.randn(2, 16, 3),
                                              "arrivals": np.arange(4)}


@pytest.mark.parametrize("writer,reader", [(jckpt, tckpt), (tckpt, jckpt),
                                           (tckpt, tckpt)])
def test_checkpoint_cross_loads(tmp_path, writer, reader):
    q, v, extra = _state(1)
    path = str(tmp_path / "ck.npz")
    writer.save_checkpoint(path, step=1234, q=q, v=v, extra=extra,
                           meta={"scene": "fuzz", "precision": "f32"})
    step, q2, v2, extra2, meta = reader.load_checkpoint(path)
    assert step == 1234 and meta == {"scene": "fuzz", "precision": "f32"}
    np.testing.assert_array_equal(q2, q)
    np.testing.assert_array_equal(v2, v)
    assert sorted(extra2) == sorted(extra)
    for k in extra:
        np.testing.assert_array_equal(extra2[k], extra[k])


def test_checkpoint_files_are_byte_equal(tmp_path):
    q, v, extra = _state(2)
    paths = [str(tmp_path / f"{i}.npz") for i in range(2)]
    for mod, path in zip((jckpt, tckpt), paths):
        mod.save_checkpoint(path, step=7, q=q, v=v, extra=extra)
    assert tckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION == 1
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_checkpoint_rejects_other_versions(tmp_path):
    path = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(path, step=1, q=np.zeros(3), v=np.zeros(3))
    with np.load(path) as z:
        payload = dict(z)
    payload["_meta"] = np.frombuffer(
        b'{"version": 2, "step": 1, "meta": {}, "extra_keys": []}', np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **payload)
    with pytest.raises(ValueError, match="version 2"):
        tckpt.load_checkpoint(path)


def test_checkpoint_policy_saves_on_multiples(tmp_path):
    policy = tckpt.CheckpointPolicy(str(tmp_path / "ck{step}.npz"),
                                    every_steps=10)
    q, v, _ = _state(3)
    assert policy.maybe_save(0, q, v) is None
    assert policy.maybe_save(15, q, v) is None
    path = policy.maybe_save(20, q, v, meta={"k": 1})
    assert path == str(tmp_path / "ck20.npz")
    step, q2, _, _, meta = jckpt.load_checkpoint(path)
    assert step == 20 and meta == {"k": 1}
    np.testing.assert_array_equal(q2, q)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_diagnostics_match_jax(batch):
    rs = np.random.RandomState(4)
    q = rs.randn(*batch, 24, 3) * 1e10
    v = rs.randn(*batch, 24, 3) * 1e3
    m = np.abs(rs.randn(*batch, 24)) * 1e24
    tq, tv, tm = (torch.from_numpy(x) for x in (q, v, m))
    pairs = [
        (tdiag.kinetic_energy(tv, tm), jdiag.kinetic_energy(v, m)),
        (tdiag.potential_energy(tq, tm, G=G, eps=EPS),
         jdiag.potential_energy(q, m, G=G, eps=EPS)),
        (tdiag.total_energy(tq, tv, tm, G=G, eps=EPS),
         jdiag.total_energy(q, v, m, G=G, eps=EPS)),
        (tdiag.total_momentum(tv, tm), jdiag.total_momentum(v, m)),
        (tdiag.total_angular_momentum(tq, tv, tm),
         jdiag.total_angular_momentum(q, v, m)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
