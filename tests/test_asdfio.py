"""Self-contained ASDF container + GWCS-subset evaluator tests."""

import numpy as np
import pytest

from pyimcom_tpu.asdfio import (
    GWCS,
    Tagged,
    asdf_read,
    asdf_write,
    build_transform,
)


def test_asdf_roundtrip(tmp_path):
    tree = {
        "roman": {
            "data": np.arange(12, dtype=np.float32).reshape(3, 4) * 0.5,
            "dq": np.zeros((3, 4), dtype=np.uint16),
            "meta": {"exposure": {"obsid": 123}, "scale": 0.11},
        },
        "history": ["made by test"],
    }
    path = tmp_path / "t.asdf"
    asdf_write(str(path), tree)
    out = asdf_read(str(path))
    np.testing.assert_array_equal(out["roman"]["data"], tree["roman"]["data"])
    assert out["roman"]["data"].dtype == np.float32
    np.testing.assert_array_equal(out["roman"]["dq"], tree["roman"]["dq"])
    assert out["roman"]["meta"]["exposure"]["obsid"] == 123
    assert out["roman"]["meta"]["scale"] == 0.11
    assert out["history"] == ["made by test"]


def test_asdf_rejects_non_asdf(tmp_path):
    p = tmp_path / "x.asdf"
    p.write_bytes(b"SIMPLE  = T")
    with pytest.raises(ValueError):
        asdf_read(str(p))


def _tag(name, value):
    return Tagged(name, value)


def _tan_gwcs(crpix, cd, crval):
    """Build a serialized-GWCS-style tree: shift -> affine -> gnomonic ->
    native-to-celestial rotation (lonpole=180)."""
    det2sky = _tag("transform/compose-1.2.0", {"forward": [
        _tag("transform/concatenate-1.2.0", {"forward": [
            _tag("transform/shift-1.2.0", {"offset": -crpix[0]}),
            _tag("transform/shift-1.2.0", {"offset": -crpix[1]}),
        ]}),
        _tag("transform/compose-1.2.0", {"forward": [
            _tag("transform/affine-1.2.0", {"matrix": cd}),
            _tag("transform/compose-1.2.0", {"forward": [
                _tag("transform/gnomonic-1.2.0", {"direction": "pix2sky"}),
                _tag("transform/rotate_sequence_3d-1.0.0", {
                    # native->celestial as astropy serializes it (passive
                    # rotations applied in listed order):
                    # [lonpole-180, dec-90, -ra] over zyz
                    "angles": [0.0, crval[1] - 90.0, -crval[0]],
                    "axes_order": "zyz", "rotation_type": "spherical"}),
            ]}),
        ]}),
    ]})
    return _tag("gwcs/wcs-1.0.0", {"name": "", "steps": [
        _tag("gwcs/step-1.0.0", {"frame": "detector", "transform": det2sky}),
        _tag("gwcs/step-1.0.0", {"frame": "world", "transform": None}),
    ]})


def test_transform_pieces():
    sh = build_transform(_tag("transform/shift-1.2.0", {"offset": 3.0}))
    assert sh(np.array([1.0]))[0][0] == 4.0
    sc = build_transform(_tag("transform/scale-1.2.0", {"factor": 2.0}))
    assert sc(np.array([1.5]))[0][0] == 3.0
    poly = build_transform(_tag("transform/polynomial-1.2.0",
                                {"coefficients": np.array([[1.0, 2.0],
                                                           [3.0, 0.0]])}))
    # 1 + 2y + 3x at (x=2, y=5)
    assert poly(np.array([2.0]), np.array([5.0]))[0][0] == 17.0
    rm = build_transform(_tag("transform/remap_axes-1.3.0",
                              {"mapping": [1, 0, 1]}))
    out = rm(np.array([7.0]), np.array([9.0]))
    assert [o[0] for o in out] == [9.0, 7.0, 9.0]


def test_rotate_sequence_3d():
    # a single PASSIVE z rotation by -90 moves lon 0 -> +90
    rot = build_transform(_tag("transform/rotate_sequence_3d-1.0.0",
                               {"angles": [-90.0], "axes_order": "z",
                                "rotation_type": "spherical"}))
    lon, lat = rot(np.array([0.0]), np.array([0.0]))
    np.testing.assert_allclose(lon[0], 90.0, atol=1e-12)
    np.testing.assert_allclose(lat[0], 0.0, atol=1e-12)


def test_rotate_sequence_convention():
    """Regression fixture for the astropy/gwcs rotate_sequence_3d
    convention: the JWST/Roman ``v23tosky`` sequence --
    angles [v2, -v3, roll, dec, -ra] over 'zyxyz', exactly as romancal
    serializes it -- must map the reference point (v2, v3) to
    (ra, dec), and at roll 0 a +v3 step must move toward celestial
    north.  Only passive rotations applied in listed order satisfy both."""
    v2r, v3r, rollr, decr, rar = 1.2, -0.7, 33.0, -40.0, 150.0
    rot = build_transform(_tag("transform/rotate_sequence_3d-1.0.0", {
        "angles": [v2r, -v3r, rollr, decr, -rar],
        "axes_order": "zyxyz", "rotation_type": "spherical"}))
    lon, lat = rot(np.array([v2r]), np.array([v3r]))
    np.testing.assert_allclose(lon[0], rar, atol=1e-9)
    np.testing.assert_allclose(lat[0], decr, atol=1e-9)

    rot0 = build_transform(_tag("transform/rotate_sequence_3d-1.0.0", {
        "angles": [v2r, -v3r, 0.0, decr, -rar],
        "axes_order": "zyxyz", "rotation_type": "spherical"}))
    lon1, lat1 = rot0(np.array([v2r]), np.array([v3r + 0.01]))
    np.testing.assert_allclose(lat1[0] - decr, 0.01, rtol=1e-4)
    np.testing.assert_allclose(lon1[0], rar, atol=1e-9)

    # at roll 90 the same step moves along -RA (east-west) instead
    rot90 = build_transform(_tag("transform/rotate_sequence_3d-1.0.0", {
        "angles": [v2r, -v3r, 90.0, decr, -rar],
        "axes_order": "zyxyz", "rotation_type": "spherical"}))
    lon2, lat2 = rot90(np.array([v2r]), np.array([v3r + 0.01]))
    np.testing.assert_allclose(lat2[0], decr, atol=1e-6)
    assert abs(np.cos(np.deg2rad(decr)) * (lon2[0] - rar)) > 0.009


def test_gwcs_tan_chain():
    crpix = (50.0, 50.0)
    s = 0.11 / 3600.0
    cd = [[-s, 0.0], [0.0, s]]
    crval = (150.0, 2.0)
    g = GWCS(_tan_gwcs(crpix, cd, crval))

    # reference point maps to crval
    ra, dec = g.pix2world(np.array([50.0]), np.array([50.0]))
    np.testing.assert_allclose(ra[0], crval[0], atol=1e-9)
    np.testing.assert_allclose(dec[0], crval[1], atol=1e-9)

    # a one-pixel step changes position by the pixel scale
    ra2, dec2 = g.pix2world(np.array([50.0]), np.array([51.0]))
    np.testing.assert_allclose(dec2[0] - dec[0], s, rtol=1e-6)

    # round trip through the Newton inverse
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 100, 40)
    y = rng.uniform(0, 100, 40)
    ra, dec = g.pix2world(x, y)
    x2, y2 = g.world2pix(ra, dec)
    np.testing.assert_allclose(x2, x, atol=1e-6)
    np.testing.assert_allclose(y2, y, atol=1e-6)


def test_gwcs_matches_fits_tan():
    """The GWCS chain agrees with the framework's FITS TAN WCS."""
    from pyimcom_tpu.wcsutil import WCS

    crpix = (33.0, 41.0)
    s = 0.05 / 3600.0
    cd = np.array([[-s, 0.2 * s], [0.1 * s, s]])
    crval = (211.3, -44.2)
    g = GWCS(_tan_gwcs(crpix, cd, crval))
    w = WCS(ctype=("RA---TAN", "DEC--TAN"), crval=crval, crpix=crpix,
            cd=cd, lonpole=180.0)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 80, 30)
    y = rng.uniform(0, 80, 30)
    ra1, dec1 = g.pix2world(x, y)
    ra2, dec2 = w.pix2world(x, y)
    np.testing.assert_allclose(dec1, dec2, atol=1e-9)
    np.testing.assert_allclose(np.cos(np.deg2rad(dec1)) *
                               ((ra1 - ra2 + 180) % 360 - 180), 0, atol=1e-9)


def test_inimage_asdf_integration(tmp_path):
    """An L2_2506 ASDF exposure loads through InImage (GWCS) and
    read_sci_frame (roman/data), matching the equivalent FITS WCS."""
    from types import SimpleNamespace

    from pyimcom_tpu.asdfio import asdf_write
    from pyimcom_tpu.coadd import InImage
    from pyimcom_tpu.layer import read_sci_frame
    from pyimcom_tpu.wcsutil import WCS

    crpix = (2044.0, 2044.0)
    s = 0.11 / 3600.0
    cd = np.array([[-s, 0.0], [0.0, s]])
    crval = (9.5, -44.1)
    det2sky = _tag("transform/compose-1.2.0", {"forward": [
        _tag("transform/concatenate-1.2.0", {"forward": [
            _tag("transform/shift-1.2.0", {"offset": -crpix[0]}),
            _tag("transform/shift-1.2.0", {"offset": -crpix[1]}),
        ]}),
        _tag("transform/compose-1.2.0", {"forward": [
            _tag("transform/affine-1.2.0", {"matrix": cd}),
            _tag("transform/compose-1.2.0", {"forward": [
                _tag("transform/stereographic-1.2.0",
                     {"direction": "pix2sky"}),
                _tag("transform/rotate_sequence_3d-1.0.0", {
                    "angles": [0.0, crval[1] - 90.0, -crval[0]],
                    "axes_order": "zyz", "rotation_type": "spherical"}),
            ]}),
        ]}),
    ]})
    gw = _tag("gwcs/wcs-1.0.0", {"name": "", "steps": [
        _tag("gwcs/step-1.0.0", {"frame": "detector", "transform": det2sky}),
        _tag("gwcs/step-1.0.0", {"frame": "world", "transform": None}),
    ]})
    rng = np.random.default_rng(7)
    data = rng.normal(size=(64, 64)).astype(np.float32)
    fname = tmp_path / "sim_L2_H158_37_11.asdf"
    asdf_write(str(fname), {"roman": {"data": data, "meta": {"wcs": gw}}})

    cfg = SimpleNamespace(inpath=str(tmp_path), informat="L2_2506")
    blk = SimpleNamespace(cfg=cfg, obsdata="H158")
    ii = InImage(blk, (37, 11))
    assert ii.exists_

    w = WCS(ctype=("RA---STG", "DEC--STG"), crval=crval, crpix=crpix,
            cd=cd, lonpole=180.0)
    x = rng.uniform(0, 4088, 25)
    y = rng.uniform(0, 4088, 25)
    ra1, dec1 = ii.inwcs.pix2world(x, y)
    ra2, dec2 = w.pix2world(x, y)
    np.testing.assert_allclose(dec1, dec2, atol=1e-9)
    np.testing.assert_allclose(np.cos(np.deg2rad(dec1)) *
                               ((ra1 - ra2 + 180) % 360 - 180), 0, atol=1e-9)
    x2, y2 = ii.inwcs.world2pix(ra1, dec1)
    np.testing.assert_allclose(x2, x, atol=1e-5)

    sci = read_sci_frame(str(fname), "L2_2506")
    np.testing.assert_array_equal(sci, data)
