"""Layer subsystem unit tests: seeds, noise reproducibility, name broker."""

import numpy as np
import pytest

from pyimcom_tpu.layer import (
    galaxy_ft,
    get_sca_imagefile,
    layer_seed,
    noise_1f_frame,
    parse_gsext_args,
    _shear_matrix,
)


def test_layer_seed_convention():
    """seed = 1000000*(18q + sca) + obsid (reference layer.py:1301)."""
    assert layer_seed(1, (123, 5)) == 1000000 * (18 + 5) + 123
    assert layer_seed(0, (7, 18)) == 18000000 + 7


def test_noise_1f_statistics():
    frame = noise_1f_frame(layer_seed(2, (3, 1)))
    assert frame.shape == (4088, 4088)
    # 1/f noise: power concentrated at low frequency along columns
    col_ps = np.abs(np.fft.rfft(frame[:, :128].mean(axis=1))) ** 2
    lo = col_ps[1:20].mean()
    hi = col_ps[-200:].mean()
    assert lo > 10 * hi
    # reproducible
    frame2 = noise_1f_frame(layer_seed(2, (3, 1)))
    np.testing.assert_array_equal(frame, frame2)


def test_name_broker_formats():
    obs = {"filter": np.array([1, 2])}
    assert get_sca_imagefile("/d", (0, 7), obs, "L2_fits") == "/d/sim_L2_F184_0_7.fits"
    assert get_sca_imagefile("/d", (1, 7), obs, "L2_2506") == "/d/sim_L2_H158_1_7.asdf"
    assert get_sca_imagefile("/d", (0, 3), obs, "dc2_imsim") == "/d/simple/dc2_F184_0_3.fits"
    assert get_sca_imagefile("/d", (0, 3), obs, "anlsim") \
        == "/d/simple/Roman_WAS_simple_model_F184_0_3.fits"
    assert get_sca_imagefile("/d", (0, 3), obs, "L2_fits",
                             extraargs={"type": "mask"}).endswith("_mask.fits")
    assert get_sca_imagefile("/d", (0, 3), obs, "nonsense") is None


def test_parse_gsext_args():
    a = parse_gsext_args(["n=0.5", "hlr=0.1", "shape=0.2:0.1", "shear=0.05:-0.12"])
    assert a["n"] == 0.5 and a["hlr"] == 0.1
    assert a["shape"] == (0.2, 0.1)
    assert a["shear"] == (0.05, -0.12)
    b = parse_gsext_args(["seed=100", "rot=45"])
    assert b["seed"] == 100 and b["rot"] == 45.0


def test_galaxy_ft_unit_flux_and_profiles():
    n = 64
    uy = np.fft.fftfreq(n)[:, None]
    ux = np.fft.rfftfreq(n)[None, :]
    A = np.eye(2)
    # n=0.5 / n=1 have closed forms; general n goes through the
    # Hankel-transform table -- all must reproduce the half-light radius
    for prof, tol in ((0.5, 1e-12), (1.0, 1e-12), (2.5, 1e-3), (4.0, 2e-3)):
        g = galaxy_ft(ux, uy, prof, 5.0, np.eye(2), A)
        assert abs(g[0, 0] - 1.0) < tol  # unit flux
        img = np.fft.fftshift(np.fft.irfft2(g, s=(n, n)))
        # half-light radius check: flux inside r=hlr ~ half of total
        yy, xx = np.mgrid[0:n, 0:n] - n // 2
        r = np.hypot(yy, xx)
        frac = img[r <= 5.0].sum() / img.sum()
        assert abs(frac - 0.5) < 0.06, (prof, frac)


def test_shear_matrix_unit_det():
    M = _shear_matrix(0.3, -0.2)
    assert abs(np.linalg.det(M) - 1.0) < 1e-12
    with pytest.raises(ValueError):
        _shear_matrix(0.8, 0.7)  # |e| >= 1


def test_field_dependent_star_flux():
    """gsfdstar layers: flux 1 at FPA center to 1+amp at corners
    (reference layer.py:188-218, 273-276, 1419-1434)."""
    from pyimcom_tpu.config import fpaCoords

    xf, yf = fpaCoords.pix2fpa(1, 2043.5, 2043.5)
    r2 = (xf ** 2 + yf ** 2) / fpaCoords.Rfpa ** 2
    amp = 0.3
    flux_ctr = 1.0 + amp * r2
    assert 1.0 < flux_ctr < 1.3  # SCA 1 sits off the FPA center

    # flux_fn wiring through make_image_from_grid: two identical stars with
    # flux_fn=2x draw exactly twice the unit-flux image
    from pyimcom_tpu.layer import make_image_from_grid
    from pyimcom_tpu.wcsutil import WCS

    w = WCS(ctype=("RA---TAN", "DEC--TAN"), crval=(150.0, 2.0),
            crpix=(2043.5, 2043.5), cd=np.array([[-3.1e-5, 0], [0, 3.1e-5]]),
            lonpole=180.0)
    yy, xx = np.mgrid[0:61, 0:61]
    psf = np.exp(-0.5 * ((xx - 30) ** 2 + (yy - 30) ** 2) / 36.0)
    psf /= psf.sum()

    def getpsf(pt, use_drawpsf=False):
        return psf

    img1 = make_image_from_grid(12, getpsf, (0, 1), {"filter": [1]}, w,
                                4088, 6)
    img2 = make_image_from_grid(12, getpsf, (0, 1), {"filter": [1]}, w,
                                4088, 6, flux_fn=lambda xs, ys: 2.0 * np.ones(len(xs)))
    assert img1.sum() > 0
    np.testing.assert_allclose(img2, 2.0 * img1, rtol=0, atol=1e-10)


def test_gsextchrom_missing_cube_raises(tmp_path):
    """A missing chromatic PSF cube is a config mistake and must raise
    (the reference opens the file unconditionally, layer.py:1446-1456)."""
    import pytest

    from pyimcom_tpu.layer import _build_extra_layer

    class _Cfg:
        inpsf_oversamp = 6

    class _Blk:
        cfg = _Cfg()
        obsdata = None

    class _Img:
        blk = _Blk()
        idsca = (0, 1)
        inwcs = None

    with pytest.raises(FileNotFoundError, match="chromatic PSF cube"):
        _build_extra_layer(f"gsextchrom14,{tmp_path}/nope,n=1.0", _Img())


def test_cache_lock_excludes_a_second_holder(tmp_path):
    from pyimcom_tpu.layer import cache_lock

    path = str(tmp_path / "sub" / "layer.fits.lock")
    with cache_lock(path, 1.0) as first:
        assert first
        with cache_lock(path, 0.2) as second:
            assert not second          # timed out: proceed without the cache
    with cache_lock(path, 0.2) as again:
        assert again                   # released on exit


def test_layer_cache_skipped_while_locked(tmp_path, monkeypatch):
    """get_all_data builds the layers itself when the cache stays locked."""
    from types import SimpleNamespace

    from pyimcom_tpu import layer

    monkeypatch.setattr(layer.Stn, "sca_nside", 8)
    cache = str(tmp_path / "cache" / "in")
    cfg = SimpleNamespace(inlayercache=cache, n_inframe=1, inpath=str(tmp_path),
                          informat="L2_fits", extrainput=[None])
    img = SimpleNamespace(blk=SimpleNamespace(cfg=cfg, obsdata={"filter": [1] * 4}),
                          idsca=(3, 4), inwcs=None)
    lock = cache + "_00000003_04.fits.lock"
    with layer.cache_lock(lock, 1.0):
        layer.get_all_data(img, timeout=0.2)
    assert img.indata.shape == (1, 8, 8)
    assert not (tmp_path / "cache" / "in_00000003_04.fits").exists()
    layer.get_all_data(img, timeout=0.2)   # unlocked: the cube is cached
    assert (tmp_path / "cache" / "in_00000003_04.fits").exists()


def test_coadd_imports_without_filelock_or_yaml():
    """The main path needs only numpy, scipy and JAX beyond the standard
    library: `import pyimcom_tpu.coadd` with filelock and yaml blocked."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "sys.modules['filelock'] = sys.modules['yaml'] = None\n"
            "import pyimcom_tpu.coadd, pyimcom_tpu.runner\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
