"""`simulate(mesh=)` on a 1x4 mesh of gloo ranks on the CPU, on a small
Plummer sphere: the four-card benchmark cell's path
(`plummer-n262144-f32-mesh4`) at n = 256, 60 steps in chunks of 20, in
float32 with Kahan updates at the default tile 128.

  * every rank's final state is bitwise the one-device run;
  * it is within the limits below of the plain binary64 reference
    (benchmark/reference/plummer.py `march`, `gaps`), and float32 without
    compensation, on the same mesh, fails at least one of them.

The limits, read on this sphere over three seeds (this test's among
them): float32 with Kahan updates reads `q_gap` 1.6e-4 to 2.6e-4 and
`v_med_gap` 6.3e-5 to 7.0e-5 (the force's float32 rounding, carried over
60 steps); without compensation each float32 add of a step's increment
to the state loses some 17 bits, and it reads 8.1e-3 to 8.2e-3 and 2.5e-3
to 2.9e-3. Each limit lies between the two, some 7x over the first and 4
to 5x under the second: `q_gap` 2e-3, `v_med_gap` 5e-4.
"""

import numpy as np
import pytest

from benchmark.reference import plummer, scenes
from nbody_tpu_torch import SimConfig, simulate
from nbody_tpu_torch.io import Scene
from nbody_tpu_torch.parallel.spawn import run_ranks
import torch_mesh_workers as W

N, STEPS, CHUNK = 256, 60, 20
SEED = 2 ** 31 + 7
LIMITS = {"q_gap": 2e-3, "v_med_gap": 5e-4}
CFG = SimConfig()


def _sphere():
    q, v, m = scenes.plummer_scene(N, seed=SEED)
    return Scene(n=N, planet=0, asteroid=1, q=q, v=v, m=m,
                 types=["star"] * N, device_idx=np.zeros(0, np.int64))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    s = _sphere()
    jobs = [(label, s, dict(n_steps=STEPS, chunk=CHUNK, precision="f32",
                            compensated=label == "kahan"))
            for label in ("kahan", "plain")]
    return run_ranks(W.simulate_jobs, 4, ({"scen": 1, "body": 4}, jobs),
                     workdir=str(tmp_path_factory.mktemp("mesh4")),
                     timeout=240)


@pytest.fixture(scope="module")
def reference():
    s = _sphere()
    return plummer.march(s.q, s.v, s.m, n_steps=STEPS, G=CFG.G, eps=CFG.eps,
                         dt=CFG.dt, device="cpu")


def _gaps(final, ref):
    s = _sphere()
    return plummer.gaps([final[:2]], ref, s.q, s.v)


def test_bitwise_the_one_device_run(runs):
    one = simulate(_sphere(), CFG, n_steps=STEPS, chunk=CHUNK,
                   precision="f32", device="cpu")
    for rank in runs:
        np.testing.assert_array_equal(rank["kahan"][0], one.q)
        np.testing.assert_array_equal(rank["kahan"][1], one.v)


def test_within_limits_of_the_binary64_reference(runs, reference):
    got = _gaps(runs[0]["kahan"], reference)
    assert all(got[k] <= LIMITS[k] for k in LIMITS), got


def test_uncompensated_float32_fails_a_limit(runs, reference):
    got = _gaps(runs[0]["plain"], reference)
    assert any(got[k] > LIMITS[k] for k in LIMITS), got
