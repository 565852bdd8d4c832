"""The port's Gram-form force (kernel B3's wrapper and plain version) against
the JAX package's Pallas Gram kernel and against an independent numpy
version of its bf16 variants.

On the CPU, `accel_mxu_ref` at highest:highest is held against
`pallas_accel_mxu(..., interpret=True)` at tests/test_pallas_interpret.py's
tolerance for that kernel, atol 1e-4 of the peak (the Gram d2 cancels for
near pairs, and the two sum in other orders). XLA:CPU computes the TPU's
DEFAULT precision in float32, so the bf16 variants are held against a numpy
version that rounds the same product inputs to bfloat16 and sums each tile
in float32: within 1e-5 of the peak, float32 summation order (the two
orders differ by under 2e-6 of the peak on these scenes).

On a card, kernel B3 is held against its plain version in float32 on the
same inputs, within CARD_TOL of the peak. The JAX package is imported inside
the tests that use it, so the card's tests run where no JAX is installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_accel_mxu.py
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import accel_mxu as mod
from nbody_tpu_torch.ops.accel_mxu import (accel_mxu, accel_mxu_ref, bf16_rn,
                                           step_mxu)

G, EPS = 6.674e-11, 1e-3
VARIANTS = [("highest", "highest"), ("default", "highest"),
            ("highest", "default"), ("default", "default")]
# kernel B3 against its plain version in float32, relative to the peak
# |a_ref|: the JAX package's tolerance for the Gram kernel, far above the
# float32 summation-order differences (under 2e-6 of the peak) and far below
# a semantic fault (a bf16 product where a float32 one belongs moves the
# result by 1e-2 of the peak, the self pair left in by more than the peak)
CARD_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, n):
    """test_pallas_interpret.py's Gram-kernel inputs: randn positions,
    |randn| * 1e8 masses, gm = fl32(G) * m in float32."""
    rs = np.random.RandomState(seed)
    q = rs.randn(n, 3).astype(np.float32)
    m = (np.abs(rs.randn(n)) * 1e8).astype(np.float32)
    return q, m * np.float32(G)


def _pallas(q, gm, tile_i, tile_j):
    import jax.numpy as jnp

    from nbody_tpu.ops.pallas_forces import pallas_accel_mxu

    return np.asarray(pallas_accel_mxu(jnp.asarray(q), jnp.asarray(gm),
                                       eps=EPS, tile_i=tile_i, tile_j=tile_j,
                                       interpret=True))


def _ref(q, gm, **kw):
    return accel_mxu_ref(torch.from_numpy(q), torch.from_numpy(gm), eps=EPS,
                         **kw).numpy()


def _bf16_np(x):
    """bfloat16 rounding, to nearest with ties to even, on the float32 bits."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _numpy_gram(q, gm, gram, accum, tile=128):
    """An independent float32 numpy version of the Gram form: the whole
    (n, n) pair matrix, products rounded as each variant says."""
    f = np.float32
    eps2 = f(EPS * EPS)
    nrm2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    gq = _bf16_np(q) if gram == "default" else q
    aq = _bf16_np(q) if accum == "default" else q
    g = ((gq[:, None, 0] * gq[None, :, 0] + gq[:, None, 1] * gq[None, :, 1])
         + gq[:, None, 2] * gq[None, :, 2])
    d2 = (nrm2[:, None] + (nrm2[None, :] + eps2)) - f(2) * g
    d2 = np.maximum(d2, f(0.5) * eps2)
    inv = f(1) / np.sqrt(d2)
    w = gm[None, :] * ((inv * inv) * inv)
    np.fill_diagonal(w, f(0))
    if accum == "default":
        w = _bf16_np(w)
    acc = np.zeros((q.shape[0], 4), np.float32)
    for j0 in range(0, q.shape[0], tile):
        wt, st = w[:, j0:j0 + tile], aq[j0:j0 + tile]
        acc += np.stack([(wt * st[None, :, 0]).sum(1),
                         (wt * st[None, :, 1]).sum(1),
                         (wt * st[None, :, 2]).sum(1), wt.sum(1)], axis=1)
    return acc[:, :3] - acc[:, 3:] * q


def _tf32_np(x):
    """tf32 rounding as cvt.rn.tf32.f32 does it, on the float32 bits: to
    nearest with ties to even, 10 fraction bits kept."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def _to_f32(x, rounding):
    """float64 sums rounded to float32 to nearest ('rn') or toward zero
    ('rz'): the two ends of what an mma may do with its sum."""
    r = x.astype(np.float32)
    if rounding == "rz":
        over = np.abs(r.astype(np.float64)) > np.abs(x)
        r = np.where(over, np.nextafter(r, np.float32(0)), r)
    return r


def _numpy_mma(q, gm, gram, accum, rounding, tile=128):
    """Kernel B3's arithmetic as csrc/accel_mxu.cu arranges it, in numpy:
    the Gram, d2 and w op for op in float32 (rsqrt as the plain version
    takes it); the self pair masked on the diagonal tiles only; the
    accumulation W x [qj | 1] as the kernel takes it for the variant: on
    the tensor cores, one mma per chunk of sources from 0 (16 for a bf16
    pass of rounded w and qj; 8 for split tf32: w_lo, then w_hi, against
    [qj_hi, 1 | qj_lo, 0], two mma each rounding its exact sum, w_lo cut to
    tf32 by truncation, the rest by cvt.rn, column c + 4 added to column c
    at the tile's end), each chunk's
    sum added in float32 to its tile's sum; for default:highest on the CUDA
    cores, each lane t of a quad folding the tile's sources s = t mod 4 in
    ascending order with FMAs, then (L0 + L1) + (L2 + L3); the tile sums
    added in ascending order; then the epilogue."""
    f = np.float32
    n = q.shape[0]
    eps2 = f(EPS * EPS)
    nrm2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    gq = _bf16_np(q) if gram == "default" else q
    g = ((gq[:, None, 0] * gq[None, :, 0] + gq[:, None, 1] * gq[None, :, 1])
         + gq[:, None, 2] * gq[None, :, 2])
    d2 = np.maximum((nrm2[:, None] + (nrm2[None, :] + eps2)) - f(2) * g,
                    f(0.5) * eps2)
    inv = torch.rsqrt(torch.from_numpy(d2)).numpy()
    w = gm[None, :] * ((inv * inv) * inv)
    for b in range(0, n, tile):
        np.fill_diagonal(w[b:b + tile, b:b + tile], f(0))
    pad = -n % tile   # sources of gm = 0 at the origin: w = 0
    w = np.pad(w, ((0, 0), (0, pad)))
    s = np.pad(np.concatenate([q, np.ones((n, 1), np.float32)], 1),
               ((0, pad), (0, 0)))

    def mma(a, b, c=0.0):   # a (n, chunks, k), b (chunks, k, columns)
        return _to_f32(np.einsum("ick,ckd->icd", a.astype(np.float64),
                                 b.astype(np.float64)) + c, rounding)

    if gram == "default" and accum == "highest":
        f64 = np.float64
        wl = w.reshape(n, -1, tile // 4, 4).astype(f64)       # [.., c, t]
        sl = s.reshape(-1, tile // 4, 4, 4).astype(f64)        # [k, c, t, col]
        lanes = np.zeros((n, wl.shape[1], 4, 4), np.float32)  # [.., t, col]
        for c in range(tile // 4):
            prod = wl[:, :, c, :, None] * sl[None, :, c]
            prod[..., 3] = wl[:, :, c, :]
            lanes = (prod + lanes).astype(np.float32)   # fma: one rounding
        tile_sums = ((lanes[:, :, 0] + lanes[:, :, 1])
                     + (lanes[:, :, 2] + lanes[:, :, 3]))
        acc = np.zeros((n, 4), np.float32)
        for t in range(tile_sums.shape[1]):
            acc += tile_sums[:, t]
        return acc[:, :3] - acc[:, 3:] * q
    if accum == "default":
        k = 16
        chunks = mma(_bf16_np(w).reshape(n, -1, k),
                     _bf16_np(s).reshape(-1, k, 4))
    else:
        k = 8
        wh, sh = _tf32_np(w), _tf32_np(s)
        # the mma reads the top 11 bits of the unrounded w_lo
        wl = ((w - wh).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        s8 = np.concatenate([sh, _tf32_np(s - sh)], 1)   # [qj_hi, 1 | qj_lo, 0]
        wh, wl = (x.reshape(n, -1, k) for x in (wh, wl))
        s8 = s8.reshape(-1, k, 8)
        chunks = mma(wh, s8, mma(wl, s8))
    chunks = chunks.reshape(n, -1, tile // k, chunks.shape[-1])
    tile_sums = np.zeros(chunks.shape[:2] + chunks.shape[-1:], np.float32)
    for c in range(tile // k):
        tile_sums += chunks[:, :, c]
    if tile_sums.shape[-1] == 8:   # column c + 4 added to column c
        tile_sums = tile_sums[..., :4] + tile_sums[..., 4:]
    acc = np.zeros((n, 4), np.float32)
    for t in range(tile_sums.shape[1]):
        acc += tile_sums[:, t]
    return acc[:, :3] - acc[:, 3:] * q


def _raw_plummer(n, seed):
    """The bench path's scene: raw Plummer positions and gm = fl32(G*m)."""
    from nbody_tpu_torch.models.plummer import plummer_scene

    q, _, m = plummer_scene(n, seed=seed)
    return q.astype(np.float32), (G * m).astype(np.float32)


def test_tf32_rounding_on_hand_made_values():
    """cvt.rn: to nearest at tf32's 11 significant bits, ties to even (ties
    away from zero would take 1 + 2^-11 to 1 + 2^-10)."""
    one = 1.0
    x = np.asarray([one, one + 2 ** -11, -(one + 2 ** -11),
                    one + 2 ** -11 + 2 ** -23, one + 3 * 2 ** -11, 3.0,
                    2.0 ** -130], np.float32)
    want = np.asarray([one, one, -one, one + 2 ** -10, one + 2 ** -9, 3.0,
                       2.0 ** -130], np.float32)
    np.testing.assert_array_equal(_tf32_np(x), want)


@pytest.mark.parametrize("rounding", ["rn", "rz"])
@pytest.mark.parametrize("gram,accum", VARIANTS)
@pytest.mark.parametrize("scene", ["randn128", "randn96", "plummer2048"])
def test_kernel_emulation_within_card_tol(scene, gram, accum, rounding):
    """The emulation of kernel B3's accumulation against the plain version,
    as chip_smoke.py phase 7 holds the kernel: relative to the larger of
    the row's peak and the peak of highest:highest on the scene for the
    bf16-Gram variants, to the peak otherwise. On these scenes the
    emulation stays under 1.2e-5 with either rounding of the mma's sums, a
    margin of 8x on CARD_TOL. (The FMA fold of default:highest rounds no
    mma sum; it runs under both ids.)"""
    q, gm = (_inputs(7, int(scene[5:])) if scene.startswith("randn")
             else _raw_plummer(2048, 2))
    ref = _ref(q, gm, gram=gram, accum=accum)
    floor = float(np.abs(ref).max())
    if gram == "default":
        floor = float(np.abs(_ref(q, gm)).max())
    scale = np.maximum(np.abs(ref).max(1, keepdims=True), floor)
    err = float((np.abs(_numpy_mma(q, gm, gram, accum, rounding) - ref)
                 / scale).max())
    assert err <= CARD_TOL / 4


@pytest.mark.parametrize("n,tile_i,tile_j", [(128, 32, 64), (128, 64, 32),
                                             (128, 128, 128), (96, 32, 48)])
def test_plain_matches_pallas_interpret(n, tile_i, tile_j):
    q, gm = _inputs(0, n)
    want = _pallas(q, gm, tile_i, tile_j)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(_ref(q, gm), want, rtol=0, atol=1e-4 * peak)


def test_zero_mass_padding_adds_nothing():
    """A whole tile of zero-mass bodies stacked on body 0, as the JAX
    package pads, leaves every real row bit-equal."""
    q, gm = _inputs(1, 64)
    q[32:], gm[32:] = q[0], 0.0
    full = _ref(q, gm, tile_j=32)
    half = _ref(q[:32], gm[:32], tile_j=32)
    assert np.isfinite(full).all()
    np.testing.assert_array_equal(full[:32], half)


def test_diagonal_mask_is_live(monkeypatch):
    """Leaving the self pair in (w_ii ~ gm/eps^3 in both sums) breaks the
    agreement with the Pallas kernel: the mask is what keeps it."""
    q, gm = _inputs(0, 128)
    want = _pallas(q, gm, 32, 64)
    peak = float(np.abs(want).max())
    assert np.abs(_ref(q, gm) - want).max() <= 1e-4 * peak
    monkeypatch.setattr(mod, "_mask_self", lambda w, j0: w)
    assert np.abs(_ref(q, gm) - want).max() > 1e-2 * peak


@pytest.mark.parametrize("gram,accum", VARIANTS)
@pytest.mark.parametrize("n", [128, 96, 300])
def test_variants_match_numpy_version(gram, accum, n):
    q, gm = _inputs(2, n)
    want = _numpy_gram(q, gm, gram, accum)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(_ref(q, gm, gram=gram, accum=accum), want,
                               rtol=0, atol=1e-5 * peak)


def test_bf16_rounding_on_hand_made_values():
    """Round to nearest, ties to even, at bfloat16's 8 significant bits."""
    one = 1.0
    x = np.asarray([one, one + 2 ** -8, one + 3 * 2 ** -8,
                    one + 2 ** -8 + 2 ** -20, -(one + 2 ** -8), 3.0,
                    0.1, 2.0 ** -130], np.float32)
    want = np.asarray([one, one, one + 2 ** -6, one + 2 ** -7, -one, 3.0,
                       0.10009765625, 2.0 ** -130], np.float32)
    got = bf16_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_bf16_np(x), want)


def test_default_variants_are_not_highest():
    """Each bf16 pass changes the result by far more than float32 rounding:
    the variants reach different products."""
    q, gm = _inputs(3, 128)
    ref = _ref(q, gm)
    peak = float(np.abs(ref).max())
    for gram, accum in VARIANTS[1:]:
        assert np.abs(_ref(q, gm, gram=gram, accum=accum)
                      - ref).max() > 1e-3 * peak


def test_step_matches_pallas_step_interpret():
    import jax.numpy as jnp

    from nbody_tpu.ops.pallas_forces import pallas_step_mxu

    q, gm = _inputs(4, 128)
    v = np.random.RandomState(5).randn(128, 3).astype(np.float32)
    dt = 0.01
    qj, vj = (np.asarray(x) for x in pallas_step_mxu(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(gm), eps=EPS, dt=dt,
        tile_i=32, tile_j=64, interpret=True))
    qt, vt = step_mxu(torch.from_numpy(q), torch.from_numpy(v),
                      torch.from_numpy(gm), eps=EPS, dt=dt)
    a_peak = float(np.abs(_ref(q, gm)).max())
    atol_v = 1e-4 * a_peak * dt + 1e-6 * float(np.abs(v).max())
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=atol_v)
    np.testing.assert_allclose(qt.numpy(), qj, rtol=0,
                               atol=atol_v * dt + 1e-6 * float(
                                   np.abs(q).max()))


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    q, gm = _inputs(6, 50)
    qt, gmt = torch.from_numpy(q), torch.from_numpy(gm)
    before = accel_mxu.launches
    for gram, accum in VARIANTS:
        got = accel_mxu(qt, gmt, eps=EPS, gram=gram, accum=accum)
        assert torch.equal(got, accel_mxu_ref(qt, gmt, eps=EPS, gram=gram,
                                              accum=accum))
    assert accel_mxu.launches == before


@pytest.mark.parametrize("case", ["float64", "rank", "width", "gm_shape",
                                  "strided", "empty", "meta", "gram",
                                  "accum"])
def test_wrapper_rejects_bad_inputs(case):
    q, gm = torch.zeros((8, 3)), torch.zeros(8)
    kw, err = {}, ValueError
    if case == "float64":
        q, err = q.double(), TypeError
    elif case == "rank":
        q = q[None]
    elif case == "width":
        q = torch.zeros((8, 4))
    elif case == "gm_shape":
        gm = torch.zeros(7)
    elif case == "strided":
        q = torch.zeros((8, 6))[:, ::2]
    elif case == "empty":
        q, gm = q[:0], gm[:0]
    elif case == "meta":
        q = torch.zeros((8, 3), device="meta")
    else:
        kw[case] = "high"
    before = accel_mxu.launches
    with pytest.raises(err):
        accel_mxu(q, gm, eps=EPS, **kw)
    assert accel_mxu.launches == before


def test_bench_runs_on_cpu_and_prints_its_json():
    from nbody_tpu_torch.scripts.bench_mxu import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--device", "cpu", "--n", "64", "--steps", "2"]) == 0
    rec = json.loads(out.getvalue().strip().split("\n")[-1])
    assert (rec["n"], rec["steps"], rec["device"]) == (64, 2, "cpu")
    res = rec["results"]
    assert set(res) == {"b2_dq"} | {f"mxu_{g}:{a}" for g, a in VARIANTS}
    assert res["b2_dq"]["pairs_per_sec"] > 0
    for g, a in VARIANTS:
        r = res[f"mxu_{g}:{a}"]
        assert set(r) == {"pairs_per_sec", "elapsed_s", "finite_after_steps",
                          "err_max_over_rms", "err_rms_over_rms"}
        assert r["pairs_per_sec"] > 0 and r["err_rms_over_rms"] >= 0
    # against B2 the float32 Gram form loses its cancellation, not more
    assert res["mxu_highest:highest"]["err_max_over_rms"] < 1e-3
    assert res["mxu_highest:highest"]["finite_after_steps"]


@pytest.mark.parametrize("args", [["--variants", "highest"],
                                  ["--variants", "high:highest"],
                                  ["--device", "tpu"]])
def test_bench_rejects_bad_arguments(args):
    from nbody_tpu_torch.scripts.bench_mxu import main

    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stderr(io.StringIO()):
        main(args)
    assert e.value.code == 2


@pytest.mark.cuda
@pytest.mark.parametrize("gram,accum", VARIANTS)
@pytest.mark.parametrize("n", [128, 96, 1000])
def test_kernel_matches_plain_on_card(cuda, gram, accum, n):
    q, gm = (torch.from_numpy(x).to(cuda) for x in _inputs(7, n))
    before = accel_mxu.launches
    got = accel_mxu(q, gm, eps=EPS, gram=gram, accum=accum)
    again = accel_mxu(q, gm, eps=EPS, gram=gram, accum=accum)
    torch.cuda.synchronize()
    assert accel_mxu.launches == before + 2
    assert torch.equal(got, again)                 # bitwise repeatable
    ref = accel_mxu_ref(q, gm, eps=EPS, gram=gram, accum=accum)
    err = float((got - ref).abs().max())
    assert err <= CARD_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("gram,accum", VARIANTS)
@pytest.mark.parametrize("n", [2048, 1000])
def test_kernel_matches_plain_on_raw_plummer_on_card(cuda, gram, accum, n):
    """The bench path's kind of scene, ragged at n=1000, where the Gram's
    cancellation clamps close pairs: each row relative to the larger of its
    own peak and highest:highest's peak, as chip_smoke.py phase 7 holds
    it."""
    q, gm = (torch.from_numpy(x).to(cuda) for x in _raw_plummer(n, 2))
    got = accel_mxu(q, gm, eps=EPS, gram=gram, accum=accum)
    again = accel_mxu(q, gm, eps=EPS, gram=gram, accum=accum)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = accel_mxu_ref(q, gm, eps=EPS, gram=gram, accum=accum)
    floor = float(accel_mxu_ref(q, gm, eps=EPS).abs().max())
    scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=floor)
    assert float(((got - ref).abs() / scale).max()) <= CARD_TOL


@pytest.mark.cuda
def test_launcher_refuses_empty_on_card(cuda):
    from nbody_tpu_torch.ops import _build

    lib = _build.load()
    z = torch.zeros((4, 3), device=cuda)
    g = torch.zeros(4, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for n in (0, -1):
        assert lib.accel_mxu_launch(z.data_ptr(), g.data_ptr(), z.data_ptr(),
                                    n, 1e-6, 0, 0, stream) == 1
