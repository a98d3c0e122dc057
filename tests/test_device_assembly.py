"""
Device-resident system-matrix assembly: kernel unit tests plus an
end-to-end equivalence check of the device group path against the host
assembly path (same block, same survey; reference contract is the host
path, itself pinned by tests/test_e2e.py against the reference acceptance
criteria, reference tests/pyimcom/test_pyimcom.py:922-1010).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pyimcom_tpu.ops import assemble


def test_scatter_pool_and_pool_to_A_match_numpy():
    rng = np.random.default_rng(0)
    n1, n2 = 37, 53
    sub = rng.standard_normal((n1, n2))
    base = 11
    pool = np.zeros(base + n1 * n2)

    # scatter the submatrix in as two image-run rects, chunked
    CH = 64
    pool_dev = jnp.zeros(base + n1 * n2)
    rects = [(0, 0, n1, 30), (0, 30, n1, n2 - 30)]  # (s1, s2, w1, w2)
    rows = []
    for (s1, s2, w1, w2) in rects:
        vals_rect = sub[s1:s1 + w1, s2:s2 + w2].ravel()
        nq = w1 * w2
        for off in range(0, nq, CH):
            nval = min(CH, nq - off)
            rows.append(((base + s1 * n2 + s2, w2, n2, off, nval),
                         vals_rect[off:off + nval]))
    R = 8
    for i0 in range(0, len(rows), R):
        chunk = rows[i0:i0 + R]
        meta = np.zeros((R, 5), np.int32)
        vals = np.zeros((R, CH))
        for j, (mrow, v) in enumerate(chunk):
            meta[j] = mrow
            vals[j, :len(v)] = v
        pool_dev = assemble.scatter_pool(pool_dev, jnp.asarray(vals),
                                         jnp.asarray(meta), CH)
    pool = np.asarray(pool_dev)
    np.testing.assert_allclose(pool[base:].reshape(n1, n2), sub,
                               rtol=0, atol=1e-14)

    # constant addend over the first rect
    meta = np.zeros((R, 5), np.int32)
    consts = np.zeros(R)
    meta[0] = (base, 30, n2, 0, n1 * 30)
    consts[0] = 0.25
    pool_dev = assemble.scatter_pool_constant(
        pool_dev, jnp.asarray(consts), jnp.asarray(meta), n1 * 30)
    sub[:, :30] += 0.25
    np.testing.assert_allclose(np.asarray(pool_dev)[base:].reshape(n1, n2),
                               sub, rtol=0, atol=1e-14)

    # pool -> A with selections (rows: every other pixel; cols: last 20)
    n_pad = 64
    sel1 = np.full(n1, -1, np.int32)
    sel1[::2] = np.arange((n1 + 1) // 2)
    sel2 = np.full(n2, -1, np.int32)
    sel2[-20:] = 10 + np.arange(20)
    selmap = jnp.asarray(np.concatenate([sel1, sel2]))
    A = jnp.zeros(n_pad * n_pad)
    total = n1 * n2
    rows = []
    for off in range(0, total, CH):
        rows.append((base + off, n2, 0, n1, min(CH, total - off), off, 0))
    meta = np.zeros((len(rows), 7), np.int32)
    for j, r in enumerate(rows):
        meta[j] = r
    A = assemble.pool_to_A(A, pool_dev, jnp.asarray(meta), selmap, CH, n_pad)
    A = np.asarray(A).reshape(n_pad, n_pad)
    want = np.zeros((n_pad, n_pad))
    want[np.ix_(sel1[::2], sel2[-20:])] = sub[::2, -20:]
    np.testing.assert_allclose(A, want, rtol=0, atol=1e-14)

    # symmetric variant writes both orientations
    A2 = assemble.pool_to_A_sym(jnp.zeros(n_pad * n_pad), pool_dev,
                                jnp.asarray(meta), selmap, CH, n_pad)
    A2 = np.asarray(A2).reshape(n_pad, n_pad)
    np.testing.assert_allclose(A2, want + want.T, rtol=0, atol=1e-14)


def test_pool_to_A_mm_matches_scatter():
    """The selection-matmul assembly equals the element-scatter assembly
    (and the np.ix_ host contract) on a rung-padded pool, both symmetric
    and not, including -1 (unselected) drops and multi-stamp targets."""
    rng = np.random.default_rng(7)
    n1s, n2s = 37, 53
    n1r, n2r = 40, 56          # rung-padded storage dims
    S, n_pad = 3, 64
    base = n1r * n2r           # second slot in the pool
    pool_np = np.zeros(2 * n1r * n2r, np.float32)
    sub = rng.standard_normal((n1s, n2s)).astype(np.float32)
    blk = np.zeros((n1r, n2r), np.float32)
    blk[:n1s, :n2s] = sub
    pool_np[base:base + n1r * n2r] = blk.ravel()
    pool = jnp.asarray(pool_np)

    sel1 = np.full(n1s, -1, np.int32)
    sel1[::2] = np.arange((n1s + 1) // 2)
    sel2 = np.full(n2s, -1, np.int32)
    sel2[-20:] = 10 + np.arange(20)
    # concatenated selmap with rung tails (-1) after each piece
    m1_off, m2_off = 0, n1r
    selc = np.full(n1r + n2r + 8, -1, np.int32)
    selc[m1_off:m1_off + n1s] = sel1
    selc[m2_off:m2_off + n2s] = sel2
    selmap = jnp.asarray(selc)

    want = np.zeros((S, n_pad, n_pad), np.float32)
    want[2][np.ix_(sel1[::2], sel2[-20:])] = sub[::2, -20:]

    uses = np.zeros((4, 5), np.int32)
    uses[1] = (base, m1_off, m2_off, 2, 1)
    uses[3] = (base, 0, 0, 0, 0)    # padded (invalid) row: no effect
    A = assemble.pool_to_A_mm(jnp.zeros(S * n_pad * n_pad, jnp.float32),
                              pool, jnp.asarray(uses), selmap,
                              n1r, n2r, n_pad, False)
    np.testing.assert_allclose(np.asarray(A).reshape(S, n_pad, n_pad),
                               want, rtol=0, atol=1e-6)

    A2 = assemble.pool_to_A_mm(jnp.zeros(S * n_pad * n_pad, jnp.float32),
                               pool, jnp.asarray(uses), selmap,
                               n1r, n2r, n_pad, True)
    wsym = want + np.transpose(want, (0, 2, 1))
    np.testing.assert_allclose(np.asarray(A2).reshape(S, n_pad, n_pad),
                               wsym, rtol=0, atol=1e-6)


def test_pool_to_A_dus_matches_mm():
    """The contiguous-block (compact + dynamic-slice add) assembly equals
    the selection-matmul assembly on the same pool/selmap, for both
    symmetric and plain placements, with the margin canvas extracted back
    to the flat A batch."""
    rng = np.random.default_rng(7)
    n1s, n2s = 37, 53
    n1r, n2r = 40, 56
    S, n_pad = 3, 64
    base = n1r * n2r
    pool_np = np.zeros(2 * n1r * n2r, np.float32)
    sub = rng.standard_normal((n1s, n2s)).astype(np.float32)
    blk = np.zeros((n1r, n2r), np.float32)
    blk[:n1s, :n2s] = sub
    pool_np[base:base + n1r * n2r] = blk.ravel()
    pool = jnp.asarray(pool_np)

    # planner contract: selected pixels map to CONTIGUOUS slot ranges
    sel1 = np.full(n1s, -1, np.int32)
    sel1[::2] = np.arange((n1s + 1) // 2)          # dst range starts at 0
    sel2 = np.full(n2s, -1, np.int32)
    sel2[-20:] = 10 + np.arange(20)                # dst range starts at 10
    m1_off, m2_off = 0, n1r
    selc = np.full(n1r + n2r + 8, -1, np.int32)
    selc[m1_off:m1_off + n1s] = sel1
    selc[m2_off:m2_off + n2s] = sel2
    selmap = jnp.asarray(selc)

    diag = jnp.asarray(rng.standard_normal((S, n_pad)).astype(np.float32))
    NC = n_pad + max(n1r, n2r)
    for sym in (False, True):
        uses_mm = np.zeros((4, 5), np.int32)
        uses_mm[1] = (base, m1_off, m2_off, 2, 1)
        A_mm = assemble.pool_to_A_mm(
            assemble.init_A_batch(diag, n_pad), pool,
            jnp.asarray(uses_mm), selmap, n1r, n2r, n_pad, sym)
        uses_dus = np.zeros((4, 7), np.int32)
        uses_dus[1] = (base, m1_off, m2_off, 2, 1, 0, 10)
        cv = assemble.init_A_canvas(diag, n_pad, NC)
        cv = assemble.pool_to_A_dus(cv, pool, jnp.asarray(uses_dus), selmap,
                                    n1r, n2r, NC, sym)
        A_dus = assemble.canvas_to_A(cv, n_pad)
        np.testing.assert_allclose(np.asarray(A_dus), np.asarray(A_mm),
                                   rtol=0, atol=1e-6)


def test_scatter_B_matches_numpy():
    rng = np.random.default_rng(1)
    n_out, m, n_pad = 2, 9, 32
    w1 = 7
    col0 = 5
    B = jnp.zeros(n_out * m * n_pad)
    want = np.zeros((n_out, m, n_pad))
    CH = 16
    for j_out in range(n_out):
        vals_rect = rng.standard_normal((w1, m))
        want[j_out, :, col0:col0 + w1] = vals_rect.T
        nq = w1 * m
        rows = [(j_out * m * n_pad, col0, off, min(CH, nq - off))
                for off in range(0, nq, CH)]
        meta = np.zeros((len(rows), 4), np.int32)
        vals = np.zeros((len(rows), CH))
        for j, r in enumerate(rows):
            meta[j] = r
            vals[j, :r[3]] = vals_rect.ravel()[r[2]:r[2] + r[3]]
        B = assemble.scatter_B(B, jnp.asarray(vals), jnp.asarray(meta),
                               CH, n_pad, m)
    np.testing.assert_allclose(np.asarray(B).reshape(n_out, m, n_pad), want,
                               rtol=0, atol=1e-14)


def test_sweep_v2_kernels_match_v1():
    """sweep_pool_scan / sweep_b_scan (gather-free query formation) produce
    the same pool / B contents as sweep_scatter_scan on identical rect
    metadata (the pool path's int + f32-hi/lo one-hot selection
    reconstructs the f64 query positions to the ulp)."""
    rng = np.random.default_rng(3)
    K, W = 5, 64
    L, m, n_pad = 400, 25, 48
    combined = jnp.asarray(rng.standard_normal((K, W, W)).astype(np.float32))
    xt_np = rng.uniform(5, 20, L)
    yt_np = rng.uniform(5, 20, L)
    pad = 300
    xt_np = np.pad(xt_np, (0, pad))
    yt_np = np.pad(yt_np, (0, pad))
    xt, yt = jnp.asarray(xt_np), jnp.asarray(yt_np)
    inv_scale, off_grid = 2.0, 32.0
    bucket, NB, R = 64, 3, 4

    # one pool rect (w1=9, w2=11 -> 99 queries over two pieces) and one
    # B rect (w1=6, w2=m)
    P = 512
    pool_rect = (2, 40, 120, 9, 11, 17, 13)   # kg,i1,i2,w1,w2,base,stride
    b_rect = (4, 200, 300, 6)                 # kg,i1,i2,w1
    ks = np.zeros((NB, R), np.int32)
    imeta = np.zeros((NB, R, 5), np.int32)
    imeta[..., 2] = 1
    pmeta = np.zeros((NB, R, 5), np.int32)
    pmeta[..., 1] = 1
    bmeta = np.zeros((NB, R, 4), np.int32)
    # v1 layout: rows mix kinds
    kg, i1, i2, w1, w2, base, stride = pool_rect
    nq = w1 * w2
    rows = [(kg, i1, i2, w2, off, min(bucket, nq - off), base, stride, 0)
            for off in range(0, nq, bucket)]
    kgb, i1b, i2b, w1b = b_rect
    nqb = w1b * m
    rows += [(kgb, i1b, i2b, m, off, min(bucket, nqb - off), 0, 3, 1)
             for off in range(0, nqb, bucket)]
    assert len(rows) <= NB * R
    for j, (kg_, i1_, i2_, w2_, off, nval, a_, b_, kind) in enumerate(rows):
        nb, r = divmod(j, R)
        ks[nb, r] = kg_
        imeta[nb, r] = (i1_, i2_, w2_, off, nval)
        if kind == 0:
            pmeta[nb, r] = (a_, w2_, b_, off, nval)
        else:
            bmeta[nb, r] = (a_, b_, off, nval)
    pool1, B1 = assemble.sweep_scatter_scan(
        jnp.zeros(P, jnp.float32), jnp.zeros(1 * m * n_pad, jnp.float32),
        combined, xt, yt, jnp.asarray(ks), jnp.asarray(imeta),
        jnp.asarray(pmeta), jnp.asarray(bmeta),
        inv_scale, off_grid, bucket, "D5512", n_pad, m)

    # v2: same metadata, kind-segregated
    pm2 = pmeta.copy()
    im_p = imeta.copy()
    im_b = imeta.copy()
    bm2 = bmeta.copy()
    for j in range(NB * R):
        nb, r = divmod(j, R)
        is_pool = j < len(rows) and rows[j][8] == 0
        is_b = j < len(rows) and rows[j][8] == 1
        if not is_pool:
            im_p[nb, r] = (0, 0, 1, 0, 0)
            pm2[nb, r] = (0, 1, 1, 0, 0)
        if not is_b:
            im_b[nb, r] = (0, 0, 1, 0, 0)
            bm2[nb, r] = (0, 0, 0, 0)
    tabs = [jnp.asarray(t) for t in assemble.split_tables(xt_np, yt_np)]
    pool2 = assemble.sweep_pool_scan(
        jnp.zeros(P, jnp.float32), combined, *tabs,
        jnp.asarray(ks), jnp.asarray(im_p), jnp.asarray(pm2),
        inv_scale, off_grid, bucket, "D5512")
    B2 = assemble.sweep_b_scan(
        jnp.zeros(1 * m * n_pad, jnp.float32), combined, xt, yt,
        jnp.asarray(ks), jnp.asarray(im_b), jnp.asarray(bm2),
        inv_scale, off_grid, bucket, "D5512", n_pad, m)
    np.testing.assert_allclose(np.asarray(B2), np.asarray(B1),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pool2), np.asarray(pool1),
                               rtol=0, atol=1e-11)


@pytest.fixture(scope="module")
def small_survey(tmp_path_factory):
    """A reduced survey (small PSF, tight acceptance radius) so both
    assembly paths run in reasonable time on the CPU backend."""
    from survey_fixture import build_survey

    tmp = tmp_path_factory.mktemp("devasm")
    cfg_dict = build_survey(tmp, n_obs=8, extrainput=["cstar14"],
                            config_overrides={"NPIXPSF": 16, "INPAD": 0.3,
                                              "FLATPEN": 1e-7})
    return tmp, cfg_dict


def _run(cfg_dict, suffix, stop, monkeypatch, device: bool, n_devices=None):
    from pyimcom_tpu.config import Config
    from pyimcom_tpu.coadd import Block

    monkeypatch.setenv("PYIMCOM_DEVICE_ASSEMBLY", "1" if device else "0")
    if n_devices is not None:
        monkeypatch.setenv("PYIMCOM_NDEVICES", str(n_devices))
    else:
        monkeypatch.delenv("PYIMCOM_NDEVICES", raising=False)
    d = dict(cfg_dict)
    d["STOP"] = stop
    d["OUT"] = d["OUT"] + suffix
    Block(cfg=Config(d), this_sub=1)
    return d["OUT"] + "_00_01.fits"


def _compare_outputs(out_a, out_b, atol_sci):
    from pyimcom_tpu.fitsio import fits_read

    fa = fits_read(out_a)
    fb = fits_read(out_b)
    a = np.asarray(fa[0].data, np.float64)
    b = np.asarray(fb[0].data, np.float64)
    scale = max(np.abs(a).max(), 1e-30)
    np.testing.assert_allclose(b, a, rtol=0, atol=atol_sci * scale)
    names_a = {h.header.get("EXTNAME") for h in fa}
    for name in ["FIDELITY", "SIGMA", "KAPPA", "INWTSUM", "EFFCOVER"]:
        if name not in names_a:
            continue  # e.g. KAPPA is stripped for single-kappa configs
        np.testing.assert_allclose(np.asarray(fb[name].data, np.float64),
                                   np.asarray(fa[name].data, np.float64),
                                   rtol=0, atol=1.0)  # quantized to <=1 LSB
    np.testing.assert_allclose(np.asarray(fb["INWEIGHT"].data),
                               np.asarray(fa["INWEIGHT"].data),
                               rtol=0, atol=1e-8)


@pytest.mark.slow
def test_device_path_matches_host_path(small_survey, monkeypatch):
    """STOP=6 covers one full 2x2 group plus two stamps of the next group,
    exercising fresh pools, cross-group pool reuse, selection maps, the
    symmetric off-diagonal scatter, and the flat-field penalty addend."""
    tmp, cfg_dict = small_survey
    out_h = _run(cfg_dict, "_host", 6, monkeypatch, device=False)
    out_d = _run(cfg_dict, "_dev", 6, monkeypatch, device=True)
    _compare_outputs(out_h, out_d, atol_sci=1e-8)


@pytest.mark.slow
def test_multi_device_rounds_match_single_device(small_survey, monkeypatch):
    """Groups column-band-sharded over 4 virtual devices produce the same
    block as a single device (stamp-level data parallelism over the mesh
    with shard_map solves + quality collectives), with ZERO
    device-to-device pool replication (band seams recompute locally)."""
    import jax

    from pyimcom_tpu import coadd as coadd_mod

    if len(jax.local_devices()) < 4:
        pytest.skip("needs >= 4 devices (conftest forces 8 virtual)")
    tmp, cfg_dict = small_survey
    # STOP=8 -> two full 2x2 groups in one row: the round has one group per
    # column band, so the shard_map mesh solve engages and the band seam
    # between the groups exercises the local-recompute path
    out_1 = _run(cfg_dict, "_dev1", 8, monkeypatch, device=True, n_devices=1)
    blocks = []
    orig_call = coadd_mod.Block.__call__

    def spy_call(self):
        blocks.append(self)
        return orig_call(self)

    monkeypatch.setattr(coadd_mod.Block, "__call__", spy_call)
    out_4 = _run(cfg_dict, "_dev4", 8, monkeypatch, device=True, n_devices=4)
    _compare_outputs(out_1, out_4, atol_sci=1e-12)
    assert blocks and blocks[-1]._cross_device_puts == 0
    # the mesh solve path actually ran (rounds with >1 live group)
    assert getattr(blocks[-1], "_round_stats", None) is not None


def test_solve_finalize_iterative_matches_kernel():
    """solve_finalize's device coaddition wrapper reproduces the Iterative
    kernel + host coaddition algebra on a synthetic stamp."""
    import jax.numpy as jnp

    from pyimcom_tpu.solvers import iterative_solve

    rng = np.random.default_rng(2)
    n, m, n_out, nfr, nimg = 128, 25, 1, 2, 3
    X = rng.standard_normal((n, 32))
    A = X @ X.T / 32 + np.eye(n)
    B = rng.standard_normal((n_out, m, n))
    C = np.array([1.5])
    kC = np.array([1e-4])
    rel = rng.random((m, n)) < 0.7
    data = rng.standard_normal((nfr, n)).astype(np.float32)
    img = rng.integers(0, nimg, n)
    onehot = np.zeros((n, nimg), np.float32)
    onehot[np.arange(n), img] = 1.0
    fade = rng.uniform(0.5, 1.0, m)

    out = assemble.solve_finalize(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(C), jnp.asarray(kC),
        jnp.asarray(data), jnp.asarray(onehot), jnp.asarray(fade),
        jnp.asarray(rel), 1e-6, 0.5, 1e-3, 25, "iterative", False, 20)

    T, kappa, Sigma, UC = iterative_solve(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(C), jnp.asarray(kC),
        jnp.asarray(rel), 1e-3, 1e-6, 0.5, maxiter=20, exact_UC=False)
    Tf = np.asarray(T) * fade[None, :, None]
    want_img = np.einsum("omn,fn->ofm", Tf, data)
    np.testing.assert_allclose(np.asarray(out["outimage"]), want_img,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out["UC"]),
                               np.maximum(np.asarray(UC), 1e-32) * fade[None, :],
                               rtol=1e-5)
    Tsum_image = np.einsum("omn,ni->omi", Tf, onehot)
    np.testing.assert_allclose(np.asarray(out["Tsum_stamp"]),
                               Tsum_image.sum(1) / 25, rtol=0, atol=1e-6)


@pytest.mark.slow
def test_pool_budget_eviction_matches_unbudgeted(small_survey, monkeypatch,
                                                 capfd):
    """Retained submatrix pools beyond PYIMCOM_POOL_BUDGET_GB are evicted
    (oldest first) and recomputed on later use through the seam machinery;
    the block output is unchanged.  STOP=0 runs every group, so the
    cross-row pool reuse that the budget interrupts is exercised."""
    tmp, cfg_dict = small_survey
    out_ref = _run(cfg_dict, "_nobudget", 0, monkeypatch, device=True,
                   n_devices=1)
    capfd.readouterr()
    monkeypatch.setenv("PYIMCOM_POOL_BUDGET_GB", "1e-9")  # evict everything
    out_ev = _run(cfg_dict, "_budget", 0, monkeypatch, device=True,
                  n_devices=1)
    monkeypatch.delenv("PYIMCOM_POOL_BUDGET_GB")
    assert "pool budget: evicted" in capfd.readouterr().out
    _compare_outputs(out_ref, out_ev, atol_sci=1e-12)


def test_shape_rungs_deterministic_ladder():
    """Shape quantizer: ~8%-spaced geometric ladder, identical across
    processes so restarted/resumed blocks hit the persistent compile
    cache (coadd._ShapeRungs)."""
    from pyimcom_tpu.coadd import _ShapeRungs

    r = _ShapeRungs()
    a = r.fit("pool", 100_000, 1 << 16)
    assert a >= 100_000 and a % (1 << 16) == 0
    # quantization never exceeds quantum + 8% headroom
    assert a <= int(100_000 * 1.08) + (1 << 16)
    # idempotent: a rung maps to itself
    assert r.fit("pool", a, 1 << 16) == a
    # deterministic across instances (the property restarts rely on):
    # a fresh quantizer, fed sizes in any order, returns the same rungs
    r2 = _ShapeRungs()
    for n in (500_000, 100_000, 1, 65_536, 3_000_000, 100_001):
        assert r2.fit("pool", n, 1 << 16) == r.fit("pool", n, 1 << 16)
    # distinct rungs stay O(log range): 1..10M at 8% spacing
    vals = {r.fit("x", n, 128) for n in range(1, 10_000_000, 9973)}
    assert len(vals) < 120
    # monotone and covering
    assert r.fit("pool", 60_000, 1 << 16) == 1 << 16
    big = r.fit("pool", 3_000_000, 1 << 16)
    assert big >= 3_000_000


def test_place_stack_matches_concatenate():
    """Rung-padded dynamic_update_slice placement == jnp.concatenate on
    the used prefix (coadd.Block._group_combined_stack contract)."""
    rng = np.random.default_rng(7)
    stacks = [rng.standard_normal((k, 6, 5)) for k in (3, 1, 4)]
    buf = assemble.zeros3_on(16, 6, 5, jnp.float64)
    off = 0
    for s in stacks:
        buf = assemble.place_stack(buf, jnp.asarray(s), np.int32(off))
        off += s.shape[0]
    ref = np.concatenate(stacks, axis=0)
    got = np.asarray(buf)
    assert np.array_equal(got[:off], ref)
    assert np.all(got[off:] == 0.0)


@pytest.mark.slow
def test_checkpoint_kill_and_resume(small_survey, monkeypatch):
    """
    Crash a block mid-coadd (after 2 checkpointed groups), then rerun the
    same block: it must resume from the durable .ckpt.npz (skipping the
    completed scan-order prefix), finish, remove the snapshot, and produce
    the SAME maps as an uninterrupted run.  This is the production
    watchdog's recovery path (scripts/run_production_block.py) -- the
    reference's analog is rerunning an idempotent Slurm block job
    (reference examples/multiblock_paper4.pl:24-28), which restarts from
    zero; here the prefix is not recomputed.
    """
    import os

    from pyimcom_tpu.coadd import Block

    tmp, cfg_dict = small_survey
    ref = _run(cfg_dict, "_ckref", 0, monkeypatch, device=True)

    monkeypatch.setenv("PYIMCOM_CHECKPOINT", "1")
    monkeypatch.setenv("PYIMCOM_CKPT_SEC", "0")   # snapshot every group

    class Boom(Exception):
        pass

    orig = Block._maybe_ckpt
    n_saves = {"n": 0}

    def dying(self, force=False):
        orig(self, force)
        n_saves["n"] += 1
        if n_saves["n"] == 2:
            raise Boom("simulated SIGKILL")

    monkeypatch.setattr(Block, "_maybe_ckpt", dying)
    with pytest.raises(Boom):
        _run(cfg_dict, "_ckres", 0, monkeypatch, device=True)
    monkeypatch.setattr(Block, "_maybe_ckpt", orig)

    ckpt = cfg_dict["OUT"] + "_ckres_00_01.ckpt.npz"
    assert os.path.exists(ckpt), "crash must leave the snapshot behind"
    z = np.load(ckpt)
    assert int(z["groups_done"]) >= 1

    out = _run(cfg_dict, "_ckres", 0, monkeypatch, device=True)
    assert not os.path.exists(ckpt), "finished block removes the snapshot"
    _compare_outputs(ref, out, atol_sci=1e-11)
