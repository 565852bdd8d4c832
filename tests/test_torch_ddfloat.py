"""The double-double arithmetic of precision 'tf3' (ops/ddfloat, the twin of
csrc/dd.cuh) against exact references.

Each result is compared with the exact value of its operands, as a
`fractions.Fraction` (add, sub, mul, div) or a `decimal` at 60 digits
(sqrt), relative to that value, in units of 2^-104. The bounds stated
below hold the measured worst case (about 0.31 for add and sub, 0.70 for
mul, 0.49 for div, 0.57 for sqrt over 2000 random pairs with and without
cancellation) with room, and are the published ones of these algorithms
(2u^2, 4u^2 and a few u^2, u = 2^-53): a missing error term costs about
2^51 of them. two_sum, fast_two_sum and two_prod must be exact.
"""

import decimal
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nbody_tpu_torch.ops import ddfloat as ddf

U104 = Fraction(1, 2 ** 104)
# bounds in units of 2^-104 of the exact result
TOL = {"add": 1, "sub": 1, "mul": 2, "div": 4, "sqrt": 2}
N = 400


def _rand(rng, n, lo=-30, hi=30):
    """n normalised double-double values: a binary64 value spread over
    decades, and a second word below half its ulp."""
    a = rng.randn(n) * 10.0 ** rng.uniform(lo, hi, n)
    b = a * rng.uniform(-1, 1, n) * 2.0 ** -53
    return ddf.two_sum(torch.from_numpy(a), torch.from_numpy(b))


def _frac(x: ddf.DD, i=None) -> Fraction:
    hi, lo = (x.hi, x.lo) if i is None else (x.hi[i], x.lo[i])
    return Fraction(float(hi)) + Fraction(float(lo))


def _rel(got: Fraction, want: Fraction) -> Fraction:
    return abs(got - want) / abs(want) / U104


def _operands(seed: int, cancel: bool):
    rng = np.random.RandomState(seed)
    a = _rand(rng, N)
    if not cancel:
        return a, _rand(rng, N)
    # b close to -a: the sums cancel 40 bits
    wobble = torch.from_numpy(1 + 2.0 ** -40 * rng.uniform(-1, 1, N))
    return a, ddf.DD(-a.hi * wobble,
                     a.lo * torch.from_numpy(rng.uniform(-1, 1, N)))


OPS = {"add": (ddf.add, lambda x, y: x + y),
       "sub": (ddf.sub, lambda x, y: x - y),
       "mul": (ddf.mul, lambda x, y: x * y),
       "div": (ddf.div, lambda x, y: x / y)}


@pytest.mark.parametrize("cancel", [False, True])
@pytest.mark.parametrize("op", list(OPS))
def test_op_against_fraction(op, cancel):
    fn, exact = OPS[op]
    a, b = _operands(3, cancel)
    got = fn(a, b)
    for i in range(N):
        want = exact(_frac(a, i), _frac(b, i))
        if want != 0:
            assert _rel(_frac(got, i), want) <= TOL[op], (op, i)


def test_sqrt_against_decimal():
    decimal.getcontext().prec = 60
    a = _rand(np.random.RandomState(4), N)
    a = ddf.DD(a.hi.abs(), a.lo * torch.sign(a.hi))
    got = ddf.sqrt(a)
    for i in range(N):
        x = decimal.Decimal(float(a.hi[i])) + decimal.Decimal(float(a.lo[i]))
        want = x.sqrt()
        g = (decimal.Decimal(float(got.hi[i]))
             + decimal.Decimal(float(got.lo[i])))
        assert abs((g - want) / want) <= TOL["sqrt"] * \
            decimal.Decimal(2) ** -104, i


def test_error_free_transforms_are_exact():
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(N) * 10.0 ** rng.uniform(-100, 100, N))
    b = torch.from_numpy(rng.randn(N) * 10.0 ** rng.uniform(-100, 100, N))
    big = torch.where(a.abs() >= b.abs(), a, b)
    small = torch.where(a.abs() >= b.abs(), b, a)
    for fn, x, y, exact in ((ddf.two_sum, a, b, lambda p, q: p + q),
                            (ddf.fast_two_sum, big, small,
                             lambda p, q: p + q),
                            (ddf.two_prod, a, b, lambda p, q: p * q)):
        r = fn(x, y)
        for i in range(N):
            assert _frac(r, i) == exact(Fraction(float(x[i])),
                                        Fraction(float(y[i]))), (fn, i)
            assert float(r.hi[i]) == float(exact(x[i], y[i]))


def test_two_prod_equals_the_fused_error_term():
    """Dekker's splitting gives the exact error a fused multiply-add gives:
    p + e == a*b exactly and e is a binary64 value, so e is unique."""
    rng = np.random.RandomState(6)
    a = rng.randn(N) * 1e10
    b = rng.randn(N) * 1e-13
    r = ddf.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    for i in range(N):
        e = Fraction(float(a[i])) * Fraction(float(b[i])) - \
            Fraction(float(r.hi[i]))
        assert Fraction(float(r.lo[i])) == e


def test_compare_and_minimum():
    rng = np.random.RandomState(7)
    a = _rand(rng, N)
    # equal his, differing los, and equal values
    b = ddf.DD(torch.cat([a.hi[:N // 2],
                          torch.from_numpy(rng.randn(N - N // 2) * 1e5)]),
               torch.cat([a.lo[:N // 4], -a.lo[N // 4:N // 2],
                          torch.zeros(N - N // 2, dtype=torch.float64)]))
    lt = ddf.lt(a, b)
    for i in range(N):
        assert bool(lt[i]) == (_frac(a, i) < _frac(b, i)), i
    m = ddf.minimum(a, b)
    for i in range(N):
        assert _frac(m, i) == min(_frac(a, i), _frac(b, i))
    nan = ddf.DD(torch.tensor(float("nan"), dtype=torch.float64),
                 torch.tensor(0.0, dtype=torch.float64))
    assert torch.isnan(ddf.minimum(nan, ddf.DD(a.hi[0], a.lo[0])).hi)


def test_stacked_form_round_trips():
    x = torch.from_numpy(np.random.RandomState(8).randn(4, 3))
    d = ddf.from_f64(x)
    assert d.shape == (4, 3, 2) and torch.equal(d[..., 1], torch.zeros(4, 3))
    assert torch.equal(ddf.to_f64(d), x)
    assert torch.equal(ddf.join(ddf.split(d)), d)
    s = ddf.join(ddf.add(ddf.split(d), ddf.split(ddf.from_f64(x * 2.0 **
                                                             -60))))
    assert torch.equal(ddf.to_f64(s), x)          # the los fall below
    assert not torch.equal(s[..., 1], torch.zeros(4, 3))


def test_fold_keeps_what_binary64_drops():
    """The force kernels' fold of 1 + many tiny terms keeps their sum,
    which a binary64 fold loses entirely."""
    terms = ddf.from_f64(torch.tensor([1.0] + [2.0 ** -60] * 1000,
                                      dtype=torch.float64))
    acc = ddf.DD(torch.tensor(0.0, dtype=torch.float64),
                 torch.tensor(0.0, dtype=torch.float64))
    for t in range(terms.shape[0]):
        acc = ddf.fold_add(acc, ddf.split(terms[t]))
    assert _frac(ddf.fold_end(acc)) == 1 + Fraction(1000, 2 ** 60)


_finite = st.floats(min_value=-1e100, max_value=1e100, allow_nan=False,
                    allow_infinity=False).filter(lambda x: abs(x) > 1e-100)
_frac_lo = st.floats(min_value=-1.0, max_value=1.0)


def _dd(h, f):
    return ddf.two_sum(torch.tensor(h, dtype=torch.float64),
                       torch.tensor(h * f * 2.0 ** -53, dtype=torch.float64))


@settings(max_examples=150, deadline=None, database=None)
@given(_finite, _frac_lo, _finite, _frac_lo, st.sampled_from(list(OPS)))
def test_op_hypothesis(ah, af, bh, bf, op):
    a, b = _dd(ah, af), _dd(bh, bf)
    fn, exact = OPS[op]
    want = exact(_frac(a), _frac(b))
    if want != 0:
        assert _rel(_frac(fn(a, b)), want) <= TOL[op]


@settings(max_examples=150, deadline=None, database=None)
@given(st.floats(min_value=1e-200, max_value=1e200), _frac_lo)
def test_sqrt_hypothesis(h, f):
    decimal.getcontext().prec = 60
    a = _dd(h, f)
    got = ddf.sqrt(a)
    x = decimal.Decimal(float(a.hi)) + decimal.Decimal(float(a.lo))
    g = decimal.Decimal(float(got.hi)) + decimal.Decimal(float(got.lo))
    want = x.sqrt()
    assert abs((g - want) / want) <= TOL["sqrt"] * decimal.Decimal(2) ** -104
