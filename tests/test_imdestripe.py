"""Destriping tests: adjoint identity, parameter model, stripe recovery.

Mirrors the reference test strategy (tests/pyimcom/test_imdestripe.py and
test_integratedimdestripe.py): the dot-product adjoint test is the gate for
the interpolation operators, and a synthetic multi-exposure run must
recover injected stripes end to end.
"""

import numpy as np
import pytest

from pyimcom_tpu.imdestripe import (
    DestripeProblem,
    Sca_img,
    bilinear_gather,
    bilinear_scatter_adjoint,
    conjugate_gradient,
    forward_par,
    n_params,
    transpose_par,
)
from pyimcom_tpu.wcsutil import WCS

SIZE = 100


def make_wcs(offset=False, size=SIZE):
    dx = 4e-5 * 0.25 if offset else 0.0  # quarter-ish pixel + integer shifts
    shift = 10 * 4e-5 if offset else 0.0
    return WCS(ctype=("RA---TAN", "DEC--TAN"), crval=(150.0, 2.0),
               crpix=((size - 1) / 2 + (10 if offset else 0), (size - 1) / 2),
               cd=np.array([[-4e-5, 0], [0, 4e-5]]), lonpole=180.0)


def test_bilinear_identity():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(SIZE, SIZE))
    xx, yy = np.meshgrid(np.arange(SIZE, dtype=float), np.arange(SIZE, dtype=float))
    out = bilinear_gather(img, xx, yy)
    np.testing.assert_allclose(out[:-1, :-1], img[:-1, :-1], atol=1e-12)


def test_adjoint_identity():
    """<I(x), y> == <x, I^T(y)> exactly (reference test_imdestripe.py:258)."""
    rng = np.random.default_rng(1)
    imgB = rng.normal(size=(SIZE, SIZE))
    imgA = rng.normal(size=(SIZE, SIZE))
    # irregular mapping with rotation + offset
    th = 0.1
    xx, yy = np.meshgrid(np.arange(SIZE, dtype=float), np.arange(SIZE, dtype=float))
    xf = np.cos(th) * (xx - 50) - np.sin(th) * (yy - 50) + 45.3
    yf = np.sin(th) * (xx - 50) + np.cos(th) * (yy - 50) + 52.7
    fwd = bilinear_gather(imgB, xf, yf)
    adj = bilinear_scatter_adjoint(imgA.ravel(), xf.ravel(), yf.ravel(), imgB.shape)
    lhs = np.sum(fwd * imgA)
    rhs = np.sum(imgB * adj)
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_forward_transpose_par_adjoint():
    rng = np.random.default_rng(2)
    shape = (32, 48)
    p = rng.normal(size=n_params(shape, amp_cols=16))

    class C:
        amp_cols = 16

    img = rng.normal(size=shape)
    lhs = np.sum(forward_par(p, shape, 16) * img)
    rhs = np.sum(p * transpose_par(img, C()))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def _make_problem(stripes):
    """Three offset exposures of the same smooth sky, with injected stripes."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    wcs_list = []
    scas = []
    for k, (dx, dy) in enumerate([(0, 0), (11, 4), (5, 13)]):
        w = WCS(ctype=("RA---TAN", "DEC--TAN"), crval=(150.0, 2.0),
                crpix=((SIZE - 1) / 2 + dx, (SIZE - 1) / 2 + dy),
                cd=np.array([[-4e-5, 0], [0, 4e-5]]), lonpole=180.0)
        wcs_list.append(w)
    # common sky evaluated through each WCS (smooth function of ra, dec)
    for k, w in enumerate(wcs_list):
        ra, dec = w.pix2world(xx.ravel().astype(float), yy.ravel().astype(float))
        sky = (np.sin(ra * 2000) + np.cos(dec * 3000)).reshape(SIZE, SIZE)
        img = sky + stripes[k][:, None]
        scas.append(Sca_img(img, w, name=f"sca{k}"))
    neighbors = {0: [1, 2], 1: [0, 2], 2: [0, 1]}
    return DestripeProblem(scas, neighbors)


def test_gradient_matches_finite_difference():
    rng = np.random.default_rng(4)
    stripes = [rng.normal(scale=0.1, size=SIZE) for _ in range(3)]
    prob = _make_problem(stripes)
    p = rng.normal(scale=0.01, size=prob.offsets[-1])
    g = prob.gradient(p)
    for idx in [3, 57, 150, 222]:
        h = 1e-6
        dp = np.zeros_like(p)
        dp[idx] = h
        fd = (prob.cost(p + dp) - prob.cost(p - dp)) / (2 * h)
        assert abs(fd - g[idx]) < 1e-4 * max(1.0, abs(fd)), (idx, fd, g[idx])


def test_stripe_recovery_end_to_end():
    """CG recovers injected stripes (up to a global offset per row-mode)."""
    rng = np.random.default_rng(5)
    stripes = [rng.normal(scale=0.2, size=SIZE) for _ in range(3)]
    prob = _make_problem(stripes)
    params, history = conjugate_gradient(prob, maxiter=25, log=lambda *a: None)
    c_end = prob.cost(params)
    c0 = prob.cost(np.zeros_like(params))
    assert c_end < 1e-6 * c0  # stripe differences eliminated

    # The row model has a gauge freedom: a common row-function (shifted per
    # exposure by its dither) is indistinguishable from sky structure, so
    # only *aligned differences* of stripes are physical.  Check those.
    ps = prob.split(params)
    resid = [stripes[k] - ps[k][:SIZE] for k in range(3)]  # = f(r+dy_k)+c_k
    dys = [0, 4, 13]
    for a, b in [(0, 1), (0, 2), (1, 2)]:
        best = np.inf
        for sign in (+1, -1):
            sh = sign * (dys[b] - dys[a])
            lo, hi = max(0, sh), min(SIZE, SIZE + sh)
            d = resid[a][lo - sh:hi - sh] - resid[b][lo:hi]
            best = min(best, np.std(d - np.mean(d)))
        base = np.std(stripes[a] - np.mean(stripes[a]))
        assert best < 0.05 * base, (a, b, best, base)


def test_cg_restart(tmp_path):
    rng = np.random.default_rng(6)
    stripes = [rng.normal(scale=0.2, size=SIZE) for _ in range(3)]
    prob = _make_problem(stripes)
    rfile = str(tmp_path / "cg_restart.pkl")
    p1, h1 = conjugate_gradient(prob, maxiter=3, restart_file=rfile,
                                log=lambda *a: None)
    p2, h2 = conjugate_gradient(prob, maxiter=6, restart_file=rfile,
                                log=lambda *a: None)
    assert h2[0]["iteration"] >= 3  # resumed, not restarted
    assert prob.cost(p2) <= prob.cost(p1) + 1e-9


def test_device_bilinear_matches_numpy():
    """Device gather/scatter twins (ops.bilinear) match the numpy reference
    and remain an exact adjoint pair."""
    import jax.numpy as jnp

    from pyimcom_tpu.imdestripe import bilinear_gather, bilinear_scatter_adjoint
    from pyimcom_tpu.ops.bilinear import (
        bilinear_gather_device,
        bilinear_gather_weighted_device,
        bilinear_scatter_adjoint_device,
    )

    rng = np.random.default_rng(11)
    img = rng.normal(size=(40, 40))
    g = rng.uniform(0.5, 2.0, (40, 40))
    xf = rng.uniform(-3, 42, 500)
    yf = rng.uniform(-3, 42, 500)

    np.testing.assert_allclose(
        np.asarray(bilinear_gather_device(jnp.asarray(img), jnp.asarray(xf),
                                          jnp.asarray(yf))),
        bilinear_gather(img, xf, yf), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(bilinear_gather_weighted_device(
            jnp.asarray(img), jnp.asarray(xf), jnp.asarray(yf),
            jnp.asarray(g))),
        bilinear_gather(img, xf, yf, g_eff=g), atol=1e-12)

    v = rng.normal(size=500)
    np.testing.assert_allclose(
        np.asarray(bilinear_scatter_adjoint_device(
            jnp.asarray(v), jnp.asarray(xf), jnp.asarray(yf), (40, 40))),
        bilinear_scatter_adjoint(v, xf, yf, (40, 40)), atol=1e-12)

    # dot-product adjointness on device
    u = rng.normal(size=(40, 40))
    lhs = np.sum(np.asarray(bilinear_gather_device(
        jnp.asarray(u), jnp.asarray(xf), jnp.asarray(yf))) * v)
    rhs = np.sum(u * np.asarray(bilinear_scatter_adjoint_device(
        jnp.asarray(v), jnp.asarray(xf), jnp.asarray(yf), (40, 40))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_object_mask_thresholding():
    from pyimcom_tpu.imdestripe import apply_object_mask

    rng = np.random.default_rng(11)
    # sky-subtracted background ~0 (the reference 'fits' threshold
    # m*median + c assumes this; defaults m=0, c=0.3)
    img = rng.normal(scale=0.01, size=(60, 60))
    img[30, 30] = 50.0  # bright object
    out, m = apply_object_mask(img, threshold_m=0.0, threshold_c=0.3)
    assert m[30, 30]
    # 5x5 dilation around the object
    assert m[28:33, 28:33].all()
    assert not m[0, 0]
    assert out[30, 30] == 0.0 and out[0, 0] == img[0, 0]
    # pre-supplied mask is honored
    pre = np.zeros_like(m)
    pre[5, 5] = True
    out2, m2 = apply_object_mask(img, mask=pre)
    assert m2 is pre and out2[5, 5] == 0.0


def test_g_eff_from_wcs_jacobian():
    from pyimcom_tpu.imdestripe import compute_g_eff

    w = make_wcs()
    g = compute_g_eff(w, (20, 20))
    # TAN projection near the pole-free region: g_eff ~ 1/pixel solid angle,
    # smooth and positive, |det CD| = (4e-5)^2
    assert np.all(g > 0)
    want = 1.0 / (4e-5) ** 2
    assert abs(np.median(g) / want - 1) < 0.05
    assert np.std(g) / np.median(g) < 1e-3


def test_boundary_continuity_penalty():
    from pyimcom_tpu.imdestripe import compute_boundary_continuity_penalty

    img = np.zeros((100, 64))
    img[:, 32:] = 1.0  # unit jump across the block boundary
    mask = np.ones_like(img, dtype=bool)
    pen = compute_boundary_continuity_penalty(img, mask, amp_cols=32,
                                              col_boundary_const=2.0,
                                              chunk_width=16, chunk_height=100)
    np.testing.assert_allclose(pen, 2.0 * 1.0, rtol=1e-12)
    assert compute_boundary_continuity_penalty(img, mask, None, 2.0) == 0.0
    assert compute_boundary_continuity_penalty(img, mask, 32, 0.0) == 0.0


def test_boundary_penalty_gradient_finite_difference():
    """Analytic image-space gradient of the boundary penalty matches a
    central finite difference (COLBOUNDARY must steer CG)."""
    from pyimcom_tpu.imdestripe import (
        boundary_continuity_penalty_grad_image,
        compute_boundary_continuity_penalty)

    rng = np.random.default_rng(7)
    img = rng.normal(size=(100, 64))
    mask = rng.random((100, 64)) > 0.2
    kw = dict(amp_cols=32, col_boundary_const=1.7,
              chunk_width=16, chunk_height=40)
    g = boundary_continuity_penalty_grad_image(img, mask, **kw)
    h = 1e-6
    for (r, c) in [(3, 20), (50, 31), (10, 40), (97, 47), (5, 5)]:
        d = np.zeros_like(img)
        d[r, c] = h
        fd = (compute_boundary_continuity_penalty(img + d, mask, **kw)
              - compute_boundary_continuity_penalty(img - d, mask, **kw)) / (2 * h)
        assert abs(fd - g[r, c]) < 1e-6 * max(1.0, abs(fd)), (r, c, fd, g[r, c])


def test_cost_gradient_consistent_with_boundary_penalty():
    """End-to-end: DestripeProblem.gradient matches finite differences of
    cost() when the boundary penalty is active."""
    rng = np.random.default_rng(11)
    stripes = [rng.normal(scale=0.1, size=SIZE) for _ in range(3)]
    base = _make_problem(stripes)
    prob = DestripeProblem(base.scas, base.neighbors,
                           amp_cols=SIZE // 2, col_boundary_const=5.0)
    p = rng.normal(scale=0.01, size=prob.offsets[-1])
    g = prob.gradient(p)
    for idx in [3, 57, 150]:
        h = 1e-6
        dp = np.zeros_like(p)
        dp[idx] = h
        fd = (prob.cost(p + dp) - prob.cost(p - dp)) / (2 * h)
        assert abs(fd - g[idx]) < 1e-4 * max(1.0, abs(fd)), (idx, fd, g[idx])


@pytest.mark.parametrize("beta_model", ["FR", "PR", "HS", "DY"])
def test_stripe_recovery_all_beta_models(beta_model):
    """All four CG direction updates (reference imdestripe.py:2147-2162)
    recover the injected stripes."""
    rng = np.random.default_rng(7)
    stripes = [rng.normal(scale=0.2, size=SIZE) for _ in range(3)]
    prob = _make_problem(stripes)
    params, _ = conjugate_gradient(prob, maxiter=25, beta_model=beta_model,
                                   log=lambda *a: None)
    assert prob.cost(params) < 1e-5 * prob.cost(np.zeros_like(params))


def test_huber_cost_general_line_search():
    """Non-quadratic cost path (bisection+secant line search) also reduces
    the stripe cost substantially."""
    rng = np.random.default_rng(8)
    stripes = [rng.normal(scale=0.2, size=SIZE) for _ in range(3)]
    scas_prob = _make_problem(stripes)
    prob = DestripeProblem(scas_prob.scas, scas_prob.neighbors,
                           cost_model="huber_loss", hub_thresh=0.5)
    params, _ = conjugate_gradient(prob, maxiter=10, log=lambda *a: None)
    assert prob.cost(params) < 0.05 * prob.cost(np.zeros_like(params))


def test_csv_iteration_log(tmp_path):
    import csv

    from pyimcom_tpu.imdestripe import _CSV_HEADER

    rng = np.random.default_rng(9)
    stripes = [rng.normal(scale=0.2, size=SIZE) for _ in range(3)]
    prob = _make_problem(stripes)
    logf = str(tmp_path / "cg_log.csv")
    conjugate_gradient(prob, maxiter=4, csv_file=logf, log=lambda *a: None)
    with open(logf) as f:
        rows = list(csv.reader(f))
    assert rows[0] == _CSV_HEADER
    assert len(rows) >= 4
    assert float(rows[-1][6]) <= float(rows[1][6])  # cost decreases


# ---------------------------------------------------------------------------
# device-resident cost/gradient (ops.destripe_device), worker pool, memmaps
# ---------------------------------------------------------------------------

def test_device_problem_matches_host(monkeypatch):
    """The whole-problem device evaluator (jax.value_and_grad over the
    stacked pair scan) reproduces the host cost and gradient exactly for
    uniform gain."""
    rng = np.random.default_rng(21)
    stripes = [rng.normal(scale=0.1, size=SIZE) for _ in range(3)]
    host = _make_problem(stripes)
    dev = DestripeProblem(host.scas, host.neighbors, use_device=True)
    p = rng.normal(scale=0.01, size=host.offsets[-1])
    np.testing.assert_allclose(dev.cost(p), host.cost(p), rtol=1e-12)
    np.testing.assert_allclose(dev.gradient(p), host.gradient(p),
                               rtol=1e-9, atol=1e-12)


def test_device_gradient_exact_through_gain(monkeypatch):
    """With non-uniform g_eff the device gradient is the EXACT derivative
    of the cost (AD through the gain-weighted gather); check against
    central finite differences of the device cost."""
    rng = np.random.default_rng(22)
    stripes = [rng.normal(scale=0.1, size=SIZE) for _ in range(3)]
    base = _make_problem(stripes)
    scas = [Sca_img(s.image, s.w, g_eff=rng.uniform(0.5, 2.0, s.image.shape),
                    name=s.name) for s in base.scas]
    prob = DestripeProblem(scas, base.neighbors, use_device=True)
    p = rng.normal(scale=0.01, size=prob.offsets[-1])
    g = prob.gradient(p)
    for idx in [3, 57, 150, 222]:
        h = 1e-6
        dp = np.zeros_like(p)
        dp[idx] = h
        fd = (prob.cost(p + dp) - prob.cost(p - dp)) / (2 * h)
        assert abs(fd - g[idx]) < 1e-4 * max(1.0, abs(fd)), (idx, fd, g[idx])


def test_device_stripe_recovery_end_to_end():
    """CG on the device path recovers injected stripes (the device half of
    the both-paths e2e)."""
    rng = np.random.default_rng(23)
    stripes = [rng.normal(scale=0.2, size=SIZE) for _ in range(3)]
    base = _make_problem(stripes)
    prob = DestripeProblem(base.scas, base.neighbors, use_device=True)
    params, _ = conjugate_gradient(prob, maxiter=25, log=lambda *a: None)
    assert prob.cost(params) < 1e-6 * prob.cost(np.zeros_like(params))


def test_device_problem_with_boundary_penalty():
    """Device cost includes the amplifier boundary penalty; its AD
    gradient matches finite differences."""
    rng = np.random.default_rng(24)
    stripes = [rng.normal(scale=0.1, size=SIZE) for _ in range(3)]
    base = _make_problem(stripes)
    mask = [rng.random((SIZE, SIZE)) > 0.1 for _ in range(3)]
    host = DestripeProblem(base.scas, base.neighbors, amp_cols=SIZE // 2,
                           col_boundary_const=5.0, mask=mask)
    dev = DestripeProblem(base.scas, base.neighbors, amp_cols=SIZE // 2,
                          col_boundary_const=5.0, mask=mask, use_device=True)
    p = rng.normal(scale=0.01, size=host.offsets[-1])
    np.testing.assert_allclose(dev.cost(p), host.cost(p), rtol=1e-12)
    g = dev.gradient(p)
    for idx in [3, 57, SIZE + 1]:
        h = 1e-6
        dp = np.zeros_like(p)
        dp[idx] = h
        fd = (dev.cost(p + dp) - dev.cost(p - dp)) / (2 * h)
        assert abs(fd - g[idx]) < 1e-4 * max(1.0, abs(fd)), (idx, fd, g[idx])


def test_worker_pool_matches_serial():
    """PYIMCOM_DESTRIPE_WORKERS fan-out returns identical cost/gradient
    (reference pool fan-out, imdestripe.py:1288-1307)."""
    rng = np.random.default_rng(25)
    stripes = [rng.normal(scale=0.1, size=SIZE) for _ in range(3)]
    serial = _make_problem(stripes)
    pooled = DestripeProblem(serial.scas, serial.neighbors, workers=2,
                             use_device=False)
    p = rng.normal(scale=0.01, size=serial.offsets[-1])
    try:
        np.testing.assert_allclose(pooled.cost(p), serial.cost(p), rtol=1e-14)
        np.testing.assert_allclose(pooled.gradient(p), serial.gradient(p),
                                   rtol=1e-12, atol=1e-15)
    finally:
        pooled.close()


def test_map_dtype_and_memmap(monkeypatch, tmp_path):
    """f32 map storage + disk-backed memmaps (reference psi memmaps,
    imdestripe.py:1627-1633) keep the gradient consistent with cost."""
    monkeypatch.setenv("PYIMCOM_DESTRIPE_MAP_DTYPE", "f32")
    monkeypatch.setenv("PYIMCOM_DESTRIPE_MEMMAP", "1")
    rng = np.random.default_rng(26)
    stripes = [rng.normal(scale=0.1, size=SIZE) for _ in range(3)]
    prob = _make_problem(stripes)
    xf, yf, _ = next(iter(prob._maps.values()))
    assert isinstance(xf, np.memmap) and xf.dtype == np.float32
    p = rng.normal(scale=0.01, size=prob.offsets[-1])
    g = prob.gradient(p)
    for idx in [3, 150]:
        h = 1e-5
        dp = np.zeros_like(p)
        dp[idx] = h
        fd = (prob.cost(p + dp) - prob.cost(p - dp)) / (2 * h)
        assert abs(fd - g[idx]) < 1e-3 * max(1.0, abs(fd)), (idx, fd, g[idx])
