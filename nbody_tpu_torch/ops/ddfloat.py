"""Double-double binary64 arithmetic on PyTorch tensors: the twin of
csrc/dd.cuh.

A double-double value is the unevaluated sum hi + lo of two binary64
numbers with |lo| <= ulp(hi) / 2: about 106 bits of significand and
binary64's exponent range. It is the port's precision beyond binary64
('tf3'), where the JAX package, on a chip without binary64, uses
triple-float32 (nbody_tpu/ops/tfloat.py) behind dynamic exponent gauges.

Tensors hold a double-double array as float64 with a trailing axis of 2,
(hi, lo); `split` and `join` convert to and from the `DD` pair that the
operations take. Every operation runs the same sequence of correctly
rounded binary64 operations as its counterpart in csrc/dd.cuh, so the
kernels and this module give the same bits. The kernels form the exact
product error of `two_prod` with one fused multiply-add; here Dekker's
splitting computes the same exact value. `sqrt` starts from a correctly
rounded square root (`forces._sqrt_rn`; CPU `torch.sqrt` is not). Each
line below is one PyTorch op, so nothing fuses or reassociates.

Bounds, with u = 2^-53 (exact results for two_sum, fast_two_sum and
two_prod barring overflow and underflow): `add` and `sub` are within about
2u^2 of |a + b|; `mul` about 4u^2 of |a b|; `div` and `sqrt` a few u^2
(tests/test_torch_ddfloat.py states each against an exact reference).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .forces import _sqrt_rn

# the representation's name where a dtype's would stand (checkpoint
# fingerprints, the drivers' `dtype` argument)
NAME = "double-double"
_SPLIT = 134217729.0     # 2^27 + 1: Veltkamp's splitting constant


class DD(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def split(x: torch.Tensor) -> DD:
    """Views of a (..., 2) float64 tensor as a DD pair."""
    return DD(x[..., 0], x[..., 1])


def join(a: DD) -> torch.Tensor:
    """A DD pair as one (..., 2) float64 tensor."""
    return torch.stack(torch.broadcast_tensors(a.hi, a.lo), dim=-1)


def from_f64(x) -> torch.Tensor:
    """A float64 tensor or array as double-double (lo = 0), shape (..., 2)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    return torch.stack([x, torch.zeros_like(x)], dim=-1)


def to_f64(x: torch.Tensor) -> torch.Tensor:
    """hi + lo rounded to binary64."""
    return x[..., 0] + x[..., 1]


def const(x: float) -> DD:
    """A binary64 constant as a DD pair of Python floats (lo = 0). Python
    float arithmetic is binary64, correctly rounded, so an operation with
    it gives the bits of one with a 0-d float64 tensor, without a
    host-to-device copy on every call."""
    return DD(float(x), 0.0)


def two_sum(a, b) -> DD:
    """s + e == a + b exactly, s = fl(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return DD(s, e)


def fast_two_sum(a, b) -> DD:
    """s + e == a + b exactly when |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return DD(s, e)


def _veltkamp(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> DD:
    """p + e == a * b exactly, p = fl(a * b). The kernels take e from one
    fused multiply-add, fma(a, b, -p); Dekker's product of the halves gives
    the same exact value without one."""
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl
    return DD(p, e)


def neg(a: DD) -> DD:
    return DD(-a.hi, -a.lo)


def add(a: DD, b: DD) -> DD:
    """a + b, the accurate sum (both halves' errors kept)."""
    s = two_sum(a.hi, b.hi)
    t = two_sum(a.lo, b.lo)
    s = fast_two_sum(s.hi, s.lo + t.hi)
    return fast_two_sum(s.hi, s.lo + t.lo)


def sub(a: DD, b: DD) -> DD:
    return add(a, neg(b))


def mul(a: DD, b: DD) -> DD:
    p = two_prod(a.hi, b.hi)
    return fast_two_sum(p.hi, p.lo + (a.hi * b.lo + a.lo * b.hi))


def mul_d(a: DD, b) -> DD:
    """a times a binary64 value b."""
    p = two_prod(a.hi, b)
    return fast_two_sum(p.hi, p.lo + a.lo * b)


def div(a: DD, b: DD) -> DD:
    """a / b from three binary64 quotients, each of the remainder left."""
    q1 = a.hi / b.hi
    r = sub(a, mul_d(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_d(b, q2))
    q3 = r.hi / b.hi
    q = fast_two_sum(q1, q2)
    return add(q, DD(q3, torch.zeros_like(q3)))


def sqrt(a: DD) -> DD:
    """sqrt(a) for a > 0: a correctly rounded binary64 root and one Newton
    correction from the exact residual (a.hi - s*s is exact)."""
    s = _sqrt_rn(a.hi)
    p = two_prod(s, s)
    r = ((a.hi - p.hi) - p.lo) + a.lo
    return fast_two_sum(s, r / (s + s))


def lt(a: DD, b: DD) -> torch.Tensor:
    """a < b for normalised pairs."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def isnan(a: DD) -> torch.Tensor:
    return (a.hi != a.hi) | (a.lo != a.lo)


def where(pred: torch.Tensor, a: DD, b: DD) -> DD:
    return DD(torch.where(pred, a.hi, b.hi), torch.where(pred, a.lo, b.lo))


def minimum(a: DD, b: DD) -> DD:
    """torch.minimum's rule: a NaN in a wins."""
    return where(lt(a, b) | isnan(a), a, b)


def fold_add(acc: DD, t: DD) -> DD:
    """One term of the force kernels' fold over j: the his summed with
    error-free two_sum, the errors and the terms' los summed apart (one
    rounding each). Only the hi chain is carried from term to term, so the
    fold's latency is one binary64 add a term (four for `add`); its error
    stays of the order n u^2 of the sum of |terms|. `fold_end` joins the
    two sums."""
    s = two_sum(acc.hi, t.hi)
    return DD(s.hi, acc.lo + (s.lo + t.lo))


def fold_end(acc: DD) -> DD:
    return fast_two_sum(acc.hi, acc.lo)


def sq_dist(qa: DD, qb: DD) -> DD:
    """|qa - qb|^2 over the last axis (size 3): ((dx*dx + dy*dy) + dz*dz),
    the serial spec's order, in double-double."""
    d = sub(qa, qb)
    dx, dy, dz = (DD(d.hi[..., k], d.lo[..., k]) for k in range(3))
    return add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz))
