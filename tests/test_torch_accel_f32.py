"""The port's fp32 force (kernel B2's wrapper and plain version) against the
JAX package's Pallas fp32 kernel and against host binary64.

`accel_f32_ref` sums each j-tile and adds the tile sums in ascending order,
as `nbody_tpu.ops.pallas_forces._accel_kernel` does, but reduces inside a
tile with `torch.sum` where the TPU kernel reduces with `jnp.sum`, so the
two agree to float32 rounding: the tolerance of
tests/test_pallas_interpret.py, rtol 2e-5 and atol 1e-6 of the peak. The
same tolerance holds the scenario batch (B, n, 3) against the JAX package's
XLA fp32 force `pairwise_accel_fast`, which the graded f32 solve runs; each
batch row must equal the unbatched call bit for bit. On a card, kernel B2 is
held against the plain version run in float64 on the same inputs:
max|a - a_ref| <= 1e-5 * max|a_ref|, and a batched launch against one
launch per row, bit for bit.

The JAX package is imported inside the tests that use it, so the card's
tests run where no JAX is installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_accel_f32.py
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import accel_f32 as mod
from nbody_tpu_torch.ops.accel_f32 import (accel_f32, accel_f32_ref,
                                           accel_f32_self)

G, EPS = 6.674e-11, 1e-3
# kernel B2 against its plain version in float64, relative to the peak
# |a_ref|: float32 rounding of the two-level sum and rsqrtf's 2 ulp
CARD_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, n):
    rs = np.random.RandomState(seed)
    q = rs.randn(n, 3).astype(np.float32)
    gm = (G * (np.abs(rs.randn(n)) * 1e8)).astype(np.float32)
    return q, gm


def _pallas(qi, qj, gmj, tile_i, tile_j):
    """The JAX package's B2 (`pallas_accel_cross`) in interpret mode."""
    import jax.numpy as jnp

    from nbody_tpu.ops.pallas_forces import pallas_accel_cross

    return np.asarray(pallas_accel_cross(
        jnp.asarray(qi), jnp.asarray(qj), jnp.asarray(gmj), eps=EPS,
        tile_i=tile_i, tile_j=tile_j, interpret=True))


def _host_f64(qi, qj, gmj, eps):
    qi, qj, gmj = (np.asarray(x, np.float64) for x in (qi, qj, gmj))
    dq = qj[None, :, :] - qi[:, None, :]
    d2 = (dq * dq).sum(-1) + np.float32(eps * eps)
    return ((gmj[None, :] / (d2 * np.sqrt(d2)))[:, :, None] * dq).sum(1)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                               atol=float(np.abs(want).max()) * 1e-6)


@pytest.mark.parametrize("tile_i,tile_j", [(32, 64), (64, 32), (128, 128)])
def test_plain_matches_pallas_interpret(tile_i, tile_j):
    q, gm = _inputs(0, 128)
    got = accel_f32_ref(torch.from_numpy(q), torch.from_numpy(q),
                        torch.from_numpy(gm), eps=EPS, tile_j=tile_j)
    _close(got.numpy(), _pallas(q, q, gm, tile_i, tile_j))


@pytest.mark.parametrize("ni,nj", [(64, 128), (128, 32)])
def test_cross_form_matches_pallas_interpret(ni, nj):
    qi, _ = _inputs(1, ni)
    qj, gmj = _inputs(2, nj)
    got = accel_f32(torch.from_numpy(qi), torch.from_numpy(qj),
                    torch.from_numpy(gmj), eps=EPS)
    _close(got.numpy(), _pallas(qi, qj, gmj, 32, 32))


def test_self_form_is_the_cross_form_of_q_with_itself():
    q, gm = _inputs(3, 96)
    qt, gmt = torch.from_numpy(q), torch.from_numpy(gm)
    assert torch.equal(accel_f32_self(qt, gmt, eps=EPS),
                       accel_f32(qt, qt, gmt, eps=EPS))


def test_zero_mass_bodies_add_nothing():
    """Whole tiles of zero-mass bodies, coincident at the origin as the JAX
    package pads, leave every row bit-equal."""
    q, gm = _inputs(4, 64)
    q[32:], gm[32:] = 0.0, 0.0
    full = accel_f32_ref(torch.from_numpy(q), torch.from_numpy(q),
                         torch.from_numpy(gm), eps=EPS, tile_j=32)
    half = accel_f32_ref(torch.from_numpy(q[:32]), torch.from_numpy(q[:32]),
                         torch.from_numpy(gm[:32]), eps=EPS, tile_j=32)
    assert torch.isfinite(full).all()
    np.testing.assert_array_equal(full[:32].numpy(), half.numpy())


@pytest.mark.parametrize("n,tile_j", [(100, 32), (77, 2048), (1, 16)])
def test_ragged_n_unpadded(n, tile_j):
    """Any n, no padding: the last tile is short. Held against host f64 and
    against the Pallas kernel on the zero-mass-padded scene."""
    q, gm = _inputs(5, n)
    got = accel_f32_ref(torch.from_numpy(q), torch.from_numpy(q),
                        torch.from_numpy(gm), eps=EPS, tile_j=tile_j).numpy()
    _close(got, _host_f64(q, q, gm, EPS))
    pad = -n % 32
    qp = np.concatenate([q, np.zeros((pad, 3), np.float32)])
    gp = np.concatenate([gm, np.zeros(pad, np.float32)])
    _close(got, _pallas(qp, qp, gp, 32, 32)[:n])


def test_plain_version_in_float64_is_host_f64():
    q, gm = _inputs(6, 200)
    got = accel_f32_ref(*(torch.from_numpy(x.astype(np.float64))
                          for x in (q, q, gm)), eps=EPS, tile_j=64)
    np.testing.assert_allclose(got.numpy(), _host_f64(q, q, gm, EPS),
                               rtol=1e-12, atol=0)


def test_eps2_is_rounded_to_float32():
    assert mod.eps2_f32(1e-3) == float(np.float32(1e-6))
    assert mod.eps2_f32(1e-3) != 1e-3 * 1e-3


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    q, gm = _inputs(7, 50)
    qt, gmt = torch.from_numpy(q), torch.from_numpy(gm)
    before = accel_f32.launches
    got = accel_f32(qt, qt, gmt, eps=EPS)
    assert accel_f32.launches == before
    assert torch.equal(got, accel_f32_ref(qt, qt, gmt, eps=EPS))


@pytest.mark.parametrize("case", ["float64", "rank", "width", "gm_shape",
                                  "strided", "empty_i", "empty_j", "meta"])
def test_wrapper_rejects_bad_inputs(case):
    qi = torch.zeros((8, 3))
    qj = torch.zeros((4, 3))
    gm = torch.zeros(4)
    err = ValueError
    if case == "float64":
        qi, err = qi.double(), TypeError
    elif case == "rank":
        qi = qi[None]
    elif case == "width":
        qj = torch.zeros((4, 4))
    elif case == "gm_shape":
        gm = torch.zeros(5)
    elif case == "strided":
        qj = torch.zeros((4, 6))[:, ::2]
    elif case == "empty_i":
        qi = qi[:0]
    elif case == "empty_j":
        qj, gm = qj[:0], gm[:0]
    else:
        qi = torch.zeros((8, 3), device="meta")
    before = accel_f32.launches
    with pytest.raises(err):
        accel_f32(qi, qj, gm, eps=EPS)
    assert accel_f32.launches == before


@pytest.mark.parametrize("B,n,tile_j", [(2, 100, 32), (5, 20, 2048),
                                        (3, 300, 128), (1, 77, 32)])
def test_batch_rows_equal_unbatched_calls_bitwise(B, n, tile_j):
    rs = np.random.RandomState(20 + B)
    q = torch.from_numpy(rs.randn(B, n, 3).astype(np.float32))
    gm = torch.from_numpy((G * np.abs(rs.randn(B, n)) * 1e8)
                          .astype(np.float32))
    a = accel_f32_ref(q, q, gm, eps=EPS, tile_j=tile_j)
    assert a.shape == (B, n, 3)
    for b in range(B):
        assert torch.equal(a[b], accel_f32_ref(q[b], q[b], gm[b], eps=EPS,
                                               tile_j=tile_j))
    assert torch.equal(accel_f32_self(q, gm, eps=EPS),
                       accel_f32_ref(q, q, gm, eps=EPS))


@pytest.mark.parametrize("B,n", [(2, 16), (5, 64), (3, 128)])
def test_batch_matches_pairwise_accel_fast(B, n):
    """The graded f32 solve's force: JAX's XLA `pairwise_accel_fast` over a
    scenario batch, gm = fl32(G) * m_eff."""
    import jax.numpy as jnp

    from nbody_tpu.ops.forces import pairwise_accel_fast

    rs = np.random.RandomState(30 + B)
    q = rs.randn(B, n, 3).astype(np.float32)
    m = (np.abs(rs.randn(B, n)) * 1e8).astype(np.float32)
    want = np.asarray(pairwise_accel_fast(jnp.asarray(q), jnp.asarray(m),
                                          G=G, eps=EPS))
    got = accel_f32(torch.from_numpy(q), torch.from_numpy(q),
                    torch.from_numpy(m) * float(np.float32(G)), eps=EPS)
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", ["batch_rank", "batch_size", "gm_batch",
                                  "batch_too_large"])
def test_wrapper_rejects_bad_batches(case):
    qi, qj, gm = torch.zeros((2, 8, 3)), torch.zeros((2, 4, 3)), \
        torch.zeros((2, 4))
    if case == "batch_rank":
        qj = qj[0]
    elif case == "batch_size":
        qj = torch.zeros((3, 4, 3))
    elif case == "gm_batch":
        gm = torch.zeros((3, 4))
    else:
        qi, qj, gm = (x.expand(65536, *x.shape[1:]) for x in
                      (qi[:1], qj[:1], gm[:1]))
    before = accel_f32.launches
    with pytest.raises(ValueError):
        accel_f32(qi, qj, gm, eps=EPS)
    assert accel_f32.launches == before


# kernel B2's two shapes (csrc/accel_f32.cu): rows a thread R, lanes of a
# warp on one tile LR, warps a block W; and its tile width
B2_SHAPES = {"large": (4, 32, 4), "small": (2, 8, 2)}
B2_TJ = 128


def _pair_terms(qi, qj, gmj):
    """Every term w*dx of kernel B2, (ni, nj, 3) float32, op for op."""
    f = np.float32
    d = qj[None, :, :] - qi[:, None, :]
    d2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
          + d[..., 2] * d[..., 2]) + f(EPS * EPS)
    inv = f(1) / np.sqrt(d2)
    return (gmj[None, :] * ((inv * inv) * inv))[..., None] * d


def _serial_tile_fold(t):
    """B2's sum with one row a thread, as the fp32 graded step's plain
    chunk specifies it: each 128-wide tile folded from 0 in ascending j,
    the tile sums added from 0 in ascending order."""
    acc = np.zeros((t.shape[0], 3), np.float32)
    for j0 in range(0, t.shape[1], B2_TJ):
        p = np.zeros_like(acc)
        for j in range(j0, min(j0 + B2_TJ, t.shape[1])):
            p += t[:, j]
        acc += p
    return acc


def _kernel_order(t, R, LR, W):
    """The sum in the order kernel B2's threads take it: blocks of R*LR
    rows; rounds of W*32/LR tiles; in a round, the thread of lane l in warp
    w folds tile w*LT + l//LR for its rows i0 + r*LR + l%LR into shared
    memory; the owners of (row, component) then add the round's tile sums
    in ascending order."""
    ni, nj = t.shape[:2]
    LT = 32 // LR
    RB, TPR = R * LR, W * LT
    span = TPR * B2_TJ
    lane = np.arange(32 * W) % 32
    lr, tt = lane % LR, (np.arange(32 * W) // 32) * LT + lane // LR
    a = np.zeros((ni, 3), np.float32)
    for i0 in range(0, ni, RB):
        acc = np.zeros((3, RB), np.float32)
        for rd in range((nj - 1) // span + 1):
            part = np.zeros((TPR, 3, RB), np.float32)
            j0 = (rd * TPR + tt) * B2_TJ           # each thread's tile
            live = j0 < nj
            cols = np.where(live, np.minimum(B2_TJ, nj - j0), 0)
            for r in range(R):
                rows = i0 + r * LR + lr
                ok = live & (rows < ni)
                p = np.zeros((32 * W, 3), np.float32)
                for jj in range(B2_TJ):
                    on = ok & (jj < cols)
                    p[on] += t[rows[on], j0[on] + jj]
                part[tt[live], :, (r * LR + lr)[live]] = p[live]
            for k in range(TPR):
                if (rd * TPR + k) * B2_TJ < nj:
                    acc += part[k]
        rows = np.arange(i0, min(i0 + RB, ni))
        a[rows] = acc[:, :len(rows)].T
    return a


@pytest.mark.parametrize("shape", ["large", "small"])
@pytest.mark.parametrize("B,n", [(1, 1000), (1, 1025), (1, 20), (2, 300)])
def test_kernel_order_equals_serial_tile_fold_bitwise(shape, B, n):
    """The new kernel's order (R rows a thread, tiles split across warps,
    tile sums through shared memory added in ascending order) gives the
    serial per-tile fold's bits, in each batch row, at ragged n: what lets
    kernel B2 and the fp32 graded step kernel agree bit for bit."""
    rs = np.random.RandomState(50 + n)
    q = rs.randn(B, n, 3).astype(np.float32)
    gm = (G * np.abs(rs.randn(B, n)) * 1e8).astype(np.float32)
    for b in range(B):
        t = _pair_terms(q[b], q[b], gm[b])
        np.testing.assert_array_equal(
            _kernel_order(t, *B2_SHAPES[shape]), _serial_tile_fold(t))


def test_kernel_order_cross_form_bitwise():
    """Rows and sources apart (ni != nj, several rounds of the small
    shape)."""
    rs = np.random.RandomState(60)
    qi, qj = (rs.randn(k, 3).astype(np.float32) for k in (40, 2100))
    gm = (G * np.abs(rs.randn(2100)) * 1e8).astype(np.float32)
    t = _pair_terms(qi, qj, gm)
    for shape in B2_SHAPES.values():
        np.testing.assert_array_equal(_kernel_order(t, *shape),
                                      _serial_tile_fold(t))


@pytest.mark.cuda
def test_rsqrt_approx_equals_rsqrtf_on_card(cuda):
    """rsqrt.approx.ftz, which kernels B2 and B3 issue, gives rsqrtf's
    bits on normal floats from eps^2 / 2 up."""
    from nbody_tpu_torch.ops import _build

    lib = _build.load()
    rs = np.random.RandomState(8)
    x = (2.0 ** rs.uniform(np.log2(5e-7), 127, 1 << 20)).astype(np.float32)
    xc = torch.from_numpy(x).to(cuda)
    want, got = torch.empty_like(xc), torch.empty_like(xc)
    assert lib.rsqrt_probe_launch(xc.data_ptr(), want.data_ptr(),
                                  got.data_ptr(), xc.numel(),
                                  torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(want.view(torch.int32), got.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(2, 1024), (5, 20), (3, 129), (3, 11264)])
def test_batched_kernel_equals_per_row_launches_on_card(cuda, B, n):
    rs = np.random.RandomState(40 + B)
    q = torch.from_numpy(rs.randn(B, n, 3).astype(np.float32)).to(cuda)
    gm = torch.from_numpy((G * np.abs(rs.randn(B, n)) * 1e8)
                          .astype(np.float32)).to(cuda)
    before = accel_f32.launches
    got = accel_f32(q, q, gm, eps=EPS)
    rows = [accel_f32(q[b], q[b], gm[b], eps=EPS) for b in range(B)]
    torch.cuda.synchronize()
    assert accel_f32.launches == before + 1 + B
    assert torch.equal(got, torch.stack(rows))
    ref = accel_f32_ref(q.double(), q.double(), gm.double(), eps=EPS)
    err = float((got.double() - ref).abs().max())
    assert err <= CARD_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ni,nj", [(1000, 1000), (4096, 4096), (3000, 5192),
                                   (1, 129)])
def test_kernel_matches_plain_on_card(cuda, ni, nj):
    qi, _ = _inputs(11, ni)
    qj, gmj = _inputs(12, nj)
    if ni == nj:
        qi = qj
    args = [torch.from_numpy(x).to(cuda) for x in (qi, qj, gmj)]
    before = accel_f32.launches
    got = accel_f32(*args, eps=EPS)
    again = accel_f32(*args, eps=EPS)
    torch.cuda.synchronize()
    assert accel_f32.launches == before + 2
    assert torch.equal(got, again)                 # bitwise repeatable
    ref = accel_f32_ref(*(x.double() for x in args), eps=EPS)
    err = float((got.double() - ref).abs().max())
    assert err <= CARD_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_launcher_error_path_on_card(cuda, monkeypatch):
    """The C launcher refuses empty shapes and a batch beyond the grid's y
    limit with cudaErrorInvalidValue (1), and the wrapper raises on any
    nonzero return, counting no launch."""
    from nbody_tpu_torch.ops import _build

    lib = _build.load()
    z = torch.zeros((4, 3), device=cuda)
    g = torch.zeros(4, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for B, ni, nj in ((1, 0, 4), (1, 4, 0), (1, -1, 4), (0, 4, 4),
                      (65536, 4, 4)):
        assert lib.accel_f32_launch(z.data_ptr(), z.data_ptr(), g.data_ptr(),
                                    z.data_ptr(), B, ni, nj, 1e-6,
                                    stream) == 1

    class Refusing:
        @staticmethod
        def accel_f32_launch(*args):
            return 1

    monkeypatch.setattr(_build, "load", lambda: Refusing)
    before = accel_f32.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        accel_f32(z, z, g, eps=EPS)
    assert accel_f32.launches == before
