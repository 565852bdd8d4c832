"""Kernel B4's plain version (ops/accel_dd.accel_dd_ref), the double-double
force of precision 'tf3', against the JAX package's triple-float32 force
and an exact reference.

  * Against `nbody_tpu.ops.forces.pairwise_accel_tf3` on the CPU, on the
    scene the JAX package's tf3 path computes on (rescaled, accelerations
    anchored): within JAX_TOL = 1e-20 of the peak |a|. triple-float32 keeps
    about 2^-64 of a pair term after its gauges (5e-20); the two measured
    9.3e-23 apart on fuzz scene 0. The port's binary64 force is 2e-16 away
    from the same JAX result, so the test also holds the port's 'tf3' at
    least 100x closer to JAX 'tf3' than its 'f64' is.
  * Against `decimal` at 60 digits at n=4 (and n=7): within DEC_TOL = 1e-29
    of the peak, a few hundred double-double roundings of 2^-104 (5e-32).
  * Batched: rows of a scenario batch never mix, so the batch equals one
    call per row bit for bit.
On a card the kernel is held bitwise against this plain version:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_accel_dd.py
"""

import decimal

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import ddfloat as ddf
from nbody_tpu_torch.ops.accel_dd import accel_dd, accel_dd_ref, eps2_dd
from nbody_tpu_torch.ops.accel_f64 import accel_f64_ref

G, EPS = 6.674e-11, 1e-3
JAX_TOL = 1e-20
DEC_TOL = 1e-29


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tf3_to_dd(a) -> ddf.DD:
    """A triple-float32 value as double-double: hi + mid exactly (two_sum),
    then lo added within 2^-104."""
    w = [torch.from_numpy(np.asarray(x, np.float64))
         for x in (a.hi, a.mid, a.lo)]
    return ddf.add(ddf.two_sum(w[0], w[1]),
                   ddf.DD(w[2], torch.zeros_like(w[2])))


def _gm(m: np.ndarray, g: float) -> torch.Tensor:
    md = ddf.from_f64(m)
    return ddf.join(ddf.mul(ddf.split(md), ddf.const(g)))


def _err(got: ddf.DD, ref: ddf.DD) -> float:
    """max |got - ref| over the peak |ref|, the difference in double-double."""
    d = ddf.to_f64(ddf.join(ddf.sub(got, ref))).abs().max()
    return float(d) / float(ref.hi.abs().max())


@pytest.mark.parametrize("seed", [0, 79])
def test_plain_version_against_jax_tf3(seed):
    from nbody_tpu.ops import tfloat
    from nbody_tpu.ops.forces import pairwise_accel_tf3
    from nbody_tpu.utils.rescale import compute_rescale
    from test_fuzz_differential import _fuzz_scene

    scene = _fuzz_scene(seed)
    rs = compute_rescale(scene, eps=EPS, anchor_accel=True, G=G)
    s = rs.apply_scene(scene)
    g, eps = G * 2.0 ** (3 * rs.qe - rs.me), EPS * 2.0 ** rs.qe
    want = _tf3_to_dd(pairwise_accel_tf3(tfloat.from_f64(s.q),
                                         tfloat.from_f64(s.m), G=g, eps=eps))
    qd, q64 = ddf.from_f64(s.q)[None], torch.from_numpy(s.q)[None]
    got = ddf.split(accel_dd_ref(qd, qd, _gm(s.m, g)[None], eps=eps)[0])
    f64 = accel_f64_ref(q64, q64, torch.from_numpy(s.m * g)[None],
                        eps=eps)[0]
    e_dd = _err(got, want)
    e_f64 = _err(ddf.split(ddf.from_f64(f64)), want)
    assert e_dd <= JAX_TOL
    assert e_f64 >= 100 * e_dd


def _decimal_accel(q: np.ndarray, gm: list, eps: float):
    D = decimal.Decimal
    e2 = D(eps) * D(eps)
    n = q.shape[0]
    out = []
    for i in range(n):
        acc = [D(0)] * 3
        for j in range(n):
            d = [D(q[j, c]) - D(q[i, c]) for c in range(3)]
            d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + e2
            w = gm[j] / (d2 * d2.sqrt())
            acc = [acc[c] + w * d[c] for c in range(3)]
        out.append(acc)
    return out


@pytest.mark.parametrize("n,seed", [(4, 0), (7, 1)])
def test_plain_version_against_decimal(n, seed):
    decimal.getcontext().prec = 60
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 3) * 1e10
    m = np.abs(rng.randn(n)) * 1e24
    gm = _gm(m, G)
    qd = ddf.from_f64(q)[None]
    got = ddf.split(accel_dd_ref(qd, qd, gm[None], eps=EPS)[0])
    D = decimal.Decimal
    gmd = [D(float(gm[j, 0])) + D(float(gm[j, 1])) for j in range(n)]
    want = _decimal_accel(q, gmd, EPS)
    peak = max(abs(x) for row in want for x in row)
    worst = max(abs(D(float(got.hi[i, c])) + D(float(got.lo[i, c]))
                    - want[i][c]) for i in range(n) for c in range(3))
    assert worst / peak <= D(DEC_TOL)


def test_batch_equals_one_call_per_row():
    rng = np.random.RandomState(2)
    q = ddf.from_f64(rng.randn(3, 19, 3) * 1e10)
    q[..., 1] = q[..., 0] * torch.from_numpy(rng.uniform(-1, 1, (3, 19, 3))
                                             * 2.0 ** -54)
    gm = ddf.from_f64(np.abs(rng.randn(3, 19)) * 1e13)
    got = accel_dd(q, q, gm, eps=EPS)
    rows = torch.stack([accel_dd(q[b:b + 1], q[b:b + 1], gm[b:b + 1],
                                 eps=EPS)[0] for b in range(3)])
    assert torch.equal(got, rows)
    assert torch.isfinite(got).all()


def test_eps2_is_the_exact_square():
    hi, lo = eps2_dd(EPS)
    from fractions import Fraction
    assert Fraction(hi) + Fraction(lo) == Fraction(EPS) ** 2


@pytest.mark.parametrize("case", ["float32", "shape", "gm_shape", "empty",
                                  "strided"])
def test_wrapper_refuses_bad_inputs(case):
    q = ddf.from_f64(np.zeros((1, 4, 3)))
    gm = ddf.from_f64(np.ones((1, 4)))
    err = ValueError
    if case == "float32":
        q, err = q.float(), TypeError
    elif case == "shape":
        q = q[..., 0]
    elif case == "gm_shape":
        gm = gm[:, :3]
    elif case == "empty":
        q, gm = q[:, :0], gm[:, :0]
    else:
        q = torch.zeros((1, 4, 3, 4), dtype=torch.float64)[..., ::2]
    before = accel_dd.launches
    with pytest.raises(err):
        accel_dd(q, q, gm, eps=EPS)
    assert accel_dd.launches == before


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    q = ddf.from_f64(np.random.RandomState(3).randn(1, 6, 3))
    gm = ddf.from_f64(np.ones((1, 6)))
    before = accel_dd.launches
    assert torch.equal(accel_dd(q, q, gm, eps=EPS),
                       accel_dd_ref(q, q, gm, eps=EPS))
    assert accel_dd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(2, 1024), (1, 37), (3, 200), (1, 1),
                                 (1, 5), (2, 63), (1, 65)])
def test_kernel_bitwise_equal_to_plain_version_on_card(cuda, B, n):
    rng = np.random.RandomState(n)
    q = ddf.from_f64(rng.randn(B, n, 3) * 1e10)
    q[..., 1] = q[..., 0] * torch.from_numpy(rng.uniform(-1, 1, (B, n, 3))
                                             * 2.0 ** -54)
    gm = ddf.from_f64(G * np.abs(rng.randn(B, n)) * 1e24)
    qc, gc = q.to(cuda), gm.to(cuda)
    before = accel_dd.launches
    got = accel_dd(qc, qc, gc, eps=EPS)
    torch.cuda.synchronize()
    assert accel_dd.launches == before + 1
    assert torch.equal(got, accel_dd_ref(qc, qc, gc, eps=EPS))
    if n <= 256:
        assert torch.equal(got.cpu(), accel_dd_ref(q, q, gm, eps=EPS))
