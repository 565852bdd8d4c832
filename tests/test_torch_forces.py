"""The port's fp64 force (kernel B1's wrapper and plain twin) against the
JAX package's Pallas e64 kernel and against host binary64.

The twin `accel_f64_ref` carries the kernel's exact op order, so on the CPU
it must reproduce, bit for bit, the TPU kernel's correctly rounded softfloat
(run in interpret mode, as tests/test_pallas_e64.py runs it) and the serial
spec in host f64. On a card, kernel B1 is held bitwise against the twin.

The JAX package is imported inside the tests that use it, so the card's
tests run where no JAX is installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_forces.py
"""

import math

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops.accel_f64 import accel_f64, accel_f64_ref
from nbody_tpu_torch.ops.forces import _sqrt_rn, sq_dist
from nbody_tpu_torch.ops.integrate import symplectic_euler_step

G, EPS = 6.674e-11, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, B, n):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, n, 3) * 1e10
    gm = G * (np.abs(rng.randn(B, n)) * 1e12)
    return q, gm


def _self(q, gm):
    """The self form's arguments (q, q, gm) as CPU tensors."""
    q = torch.from_numpy(q)
    return q, q, torch.from_numpy(gm)


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def test_twin_bit_equal_to_pallas_e64_interpret():
    from nbody_tpu.ops import f64emu as fe
    from nbody_tpu.ops.pallas_forces_e64 import pallas_accel_e64

    q, gm = _inputs(2, 3, 128)
    got = accel_f64_ref(*_self(q, gm), eps=EPS)
    ref = pallas_accel_e64(fe.e64_from_f64_tree(q), fe.e64_from_f64_tree(gm),
                           eps=EPS, rows_i=1, tile_j=32, interpret=True)
    want = fe.e64_to_f64(ref)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n", [16, 20])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_twin_bit_equal_to_host_f64(n, B):
    from test_pallas_e64 import _host_f64_accel

    q, gm = _inputs(100 * n + B, B, n)
    got = accel_f64_ref(*_self(q, gm), eps=EPS)
    for b in range(B):
        np.testing.assert_array_equal(_bits(got[b].numpy()),
                                      _bits(_host_f64_accel(q[b], gm[b], EPS)))


def test_sqrt_rn_is_correctly_rounded():
    rng = np.random.RandomState(5)
    x = np.abs(rng.randn(10000)) * 10.0 ** rng.uniform(-300, 300, 10000)
    got = _sqrt_rn(torch.from_numpy(x)).numpy()
    want = np.asarray([math.sqrt(v) for v in x])
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_sq_dist_serial_order():
    rng = np.random.RandomState(6)
    a, b = rng.randn(50, 3) * 1e11, rng.randn(50, 3) * 1e11
    got = sq_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    d = a - b
    want = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_wrapper_on_cpu_runs_twin_and_counts_no_launch():
    q, gm = _inputs(7, 2, 20)
    qt, gmt = torch.from_numpy(q), torch.from_numpy(gm)
    before = accel_f64.launches
    got = accel_f64(qt, qt, gmt, eps=EPS)
    assert accel_f64.launches == before
    assert torch.equal(got, accel_f64_ref(qt, qt, gmt, eps=EPS))


@pytest.mark.parametrize("case", ["float32", "rank", "gm_shape", "strided",
                                  "empty"])
def test_wrapper_rejects_bad_inputs(case):
    q = torch.zeros((2, 8, 3), dtype=torch.float64)
    gm = torch.zeros((2, 8), dtype=torch.float64)
    if case == "float32":
        q, err = q.float(), TypeError
    elif case == "rank":
        q, err = q[0], ValueError
    elif case == "gm_shape":
        gm, err = gm[:, :4], ValueError
    elif case == "strided":
        q, err = torch.zeros((2, 8, 6), dtype=torch.float64)[..., ::2], \
            ValueError
    else:
        q, gm, err = q[:, :0], gm[:, :0], ValueError
    with pytest.raises(err):
        accel_f64(q, q, gm, eps=EPS)


def test_symplectic_euler_step_matches_host():
    from test_pallas_e64 import _host_f64_accel

    q, _ = _inputs(8, 2, 20)
    rng = np.random.RandomState(9)
    v = rng.randn(2, 20, 3) * 1e3
    m = np.abs(rng.randn(2, 20)) * 1e24
    q2, v2 = symplectic_euler_step(torch.from_numpy(q), torch.from_numpy(v),
                                   torch.from_numpy(m), G=G, eps=EPS, dt=60.0)
    for b in range(2):
        a = _host_f64_accel(q[b], m[b] * G, EPS)
        vw = v[b] + a * 60.0
        qw = q[b] + vw * 60.0
        np.testing.assert_array_equal(_bits(v2[b].numpy()), _bits(vw))
        np.testing.assert_array_equal(_bits(q2[b].numpy()), _bits(qw))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(2, 1024), (5, 20)])
def test_kernel_bit_equal_to_twin_on_card(cuda, B, n):
    q, gm = _inputs(11, B, n)
    qc, gmc = (torch.from_numpy(x).to(cuda) for x in (q, gm))
    before = accel_f64.launches
    got = accel_f64(qc, qc, gmc, eps=EPS)
    torch.cuda.synchronize()
    assert accel_f64.launches == before + 1
    assert torch.equal(got, accel_f64_ref(qc, qc, gmc, eps=EPS))
    assert torch.equal(got.cpu(), accel_f64_ref(*_self(q, gm), eps=EPS))
