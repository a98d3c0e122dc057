"""
Input layer cube generation: science frames, synthetic noise, injected
sources, and masks.

Counterpart of reference src/pyimcom/layer.py.  Each input exposure
contributes an (n_inframe, sca_nside, sca_nside) cube: layer 0 is the
science image; the extra layers are specified by config EXTRAINPUT strings
("whitenoise1", "1fnoise2", "cstar14", "nstar14,2e5,100,256",
"gsstar14", "truth", "labnoise", "skyerr").

Differences from the reference, by design:

* No GalSim: point-source injection ("gsstar"/"cstar") draws stars by
  direct D5512 interpolation of the oversampled PSF -- mathematically the
  same operation GalSim performs for an InterpolatedImage drawn with
  method='no_pixel' (reference GridInject.make_image_from_grid,
  layer.py:791-854).  Star patches are drawn as one batched device
  interpolation per exposure instead of a per-star C-loop.
* No healpy: injection grids come from pyimcom_tpu.sphere.

Deterministic RNG layers use the same seed convention as the reference
(seed = 1000000*(18*q + sca) + obsid; layer.py:1301-1311) so noise
realizations are reproducible across processes.
"""

from __future__ import annotations

import contextlib
import fcntl
import functools
import os
import re
import sys
import time
from os.path import exists

import numpy as np

from .config import Settings as Stn
from .fitsio import HDUList, ImageHDU, fits_read, fits_write


# ---------------------------------------------------------------------------
# input file name broker
# ---------------------------------------------------------------------------

def get_sca_imagefile(path, idsca, obsdata, format_, extraargs=None):
    """
    Input file name for an (obsid, SCA) pair.

    Formats: 'L2_fits' (this framework's native FITS L2 layout),
    'L2_2506' (reference ASDF layout -- name resolution only),
    'anlsim', 'dc2_imsim' (reference FITS layouts; layer.py:1128-1171).
    """
    scastr = f"{idsca[1]:d}" if idsca[1] != -1 else "{:d}"
    filter_ = obsdata if isinstance(obsdata, str) else Stn.RomanFilters[obsdata["filter"][idsca[0]]]
    typ = (extraargs or {}).get("type")

    if format_ in ("L2_fits", "L2_2506"):
        ext = "fits" if format_ == "L2_fits" else "asdf"
        out = f"{path}/sim_L2_{filter_:s}_{idsca[0]:d}_{scastr:s}.{ext}"
        if typ == "mask":
            out = f"{path}/sim_L2_{filter_:s}_{idsca[0]:d}_{scastr:s}_mask.fits" \
                if format_ == "L2_fits" else out
        elif typ == "labnoise":
            out = f"{path}/labnoise/slope_{idsca[0]:d}_{scastr:s}.fits"
        elif typ == "truth":
            out = f"{path}/truth/Roman_WAS_truth_{filter_:s}_{idsca[0]:d}_{scastr:s}.fits"
        elif typ == "noise":
            out = f"{path}/sim_L2_{filter_:s}_{idsca[0]:d}_{scastr:s}_noise.{ext}"
        return out

    if format_ == "anlsim":
        out = f"{path}/simple/Roman_WAS_simple_model_{filter_:s}_{idsca[0]:d}_{scastr:s}.fits"
        if typ == "labnoise":
            out = f"{path}/labnoise/slope_{idsca[0]:d}_{scastr:s}.fits"
        return out

    if format_ == "dc2_imsim":
        out = f"{path}/simple/dc2_{filter_:s}_{idsca[0]:d}_{scastr:s}.fits"
        if typ == "truth":
            out = f"{path}/truth/dc2_{filter_:s}_{idsca[0]:d}_{scastr:s}.fits"
        elif typ == "labnoise":
            out = f"{path}/labnoise/slope_{idsca[0]:d}_{scastr:s}.fits"
        return out

    return None


def check_if_idsca_exists(cfg, obsdata, idsca):
    """Return (exists, filename) for an observation/SCA pair."""
    fname = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat)
    return (fname is not None and exists(fname)), fname


def read_sci_frame(filename, format_):
    """Science layer from an input file (sky-subtracted where applicable)."""
    if format_ in ("dc2_imsim", "anlsim"):
        hdus = fits_read(filename)
        sci = hdus["SCI"]
        return np.asarray(sci.data, dtype=np.float32) - float(sci.header["SKY_MEAN"])
    if format_ == "L2_fits":
        hdus = fits_read(filename)
        return np.asarray(hdus[0].data, dtype=np.float32)
    if format_ == "L2_2506":
        # Roman L2 ASDF layout (reference layer.py:1256-1264): the science
        # array lives at roman/data, already in electrons
        from .asdfio import asdf_read

        tree = asdf_read(filename)
        return np.asarray(tree["roman"]["data"], dtype=np.float32)
    raise ValueError(f"unknown input format {format_!r}")


# ---------------------------------------------------------------------------
# synthetic noise layers
# ---------------------------------------------------------------------------

def layer_seed(q: int, idsca) -> int:
    """Deterministic RNG seed (matches reference layer.py:1301)."""
    return 1000000 * (18 * q + idsca[1]) + idsca[0]


def noise_1f_frame(seed: int) -> np.ndarray:
    """
    1/f read-noise frame, independent per output channel, serpentine channel
    read order (reference CplxNoise.noise_1f_frame, layer.py:870-913).
    """
    this_array = np.zeros((4096, 4096), dtype=np.float32)
    rng = np.random.default_rng(seed)
    len_ = 8192 * 128

    freq = np.linspace(0, 1 - 1.0 / len_, len_)
    freq[len_ // 2:] -= 1.0
    amp = (1.0e-99 + np.abs(freq * len_)) ** (-0.5)
    amp[0] = 0.0
    for ch in range(32):
        ftsignal = rng.normal(size=(len_,)) + 1j * rng.normal(size=(len_,))
        ftsignal *= amp
        block = np.fft.fft(ftsignal).real[: len_ // 2] / np.sqrt(2.0)
        block -= np.mean(block)
        xmin = ch * 128
        cols = block.reshape((4096, 128))
        this_array[:, xmin:xmin + 128] = cols if ch % 2 == 0 else cols[:, ::-1]
    return this_array[4:4092, 4:4092]


# ---------------------------------------------------------------------------
# star-grid injection (device-batched interpolation)
# ---------------------------------------------------------------------------

def generate_star_grid(res, mywcs, scapar=None):
    """
    HEALPix injection grid covering one SCA (reference layer.py:742-789).

    Returns (ipix, x, y, ra_deg, dec_deg).
    """
    from .sphere import healpix_patch

    scapar = scapar or {"nside": Stn.sca_nside, "pix_arcsec": 0.11}
    degree = np.pi / 180.0
    sidelength = scapar["nside"] * scapar["pix_arcsec"] / 3600 * degree
    radius = sidelength

    cpos = (scapar["nside"] - 1) / 2
    cw = mywcs.all_pix2world(np.array([[cpos, cpos]]), 0)[0]
    grid = healpix_patch(res, cw[0] * degree, cw[1] * degree, radius)
    px, py = mywcs.all_world2pix(grid["rapix"] / degree, grid["decpix"] / degree, 0)
    return grid["ipix"], px, py, grid["rapix"] / degree, grid["decpix"] / degree


def make_image_from_grid(res, inpsf, idsca, obsdata, mywcs, nside_sca, inpsf_oversamp,
                         patch_half: int = 64, chunk: int = 32, flux_fn=None):
    """
    Draw a star at every grid point by interpolating the oversampled PSF
    (reference GridInject.make_image_from_grid, layer.py:791-854), batched
    on device in chunks of stars.  `flux_fn(xsca, ysca) -> (nstar,)` sets
    per-star fluxes (default: unit flux; used by the field-dependent
    'gsfdstar' layers, reference layer.py:188-218,273-276).
    """
    import jax.numpy as jnp

    from .ops.interp import interp2d_stack

    image = np.zeros((nside_sca, nside_sca), dtype=np.float64)
    ipix, xsca, ysca, rapix, decpix = generate_star_grid(res, mywcs)
    nstar = len(ipix)
    if nstar == 0:
        return image
    p = 6  # interpolation guard padding
    d = patch_half

    # keep stars whose patch intersects the SCA
    keep = (xsca > -d) & (xsca < nside_sca + d) & (ysca > -d) & (ysca < nside_sca + d)
    idx = np.nonzero(keep)[0]

    inpsf_batch = getattr(inpsf, "__self__", None)
    inpsf_batch = getattr(inpsf_batch, "get_psf_pos_batch", None)

    from .psfgrp import _use_dense

    if _use_dense():
        chunk = min(chunk, 8)  # bound the dense weight-matrix working set

    for start in range(0, len(idx), chunk):
        sel = idx[start:start + chunk]
        ns = len(sel)
        if inpsf_batch is not None:
            psfs = list(inpsf_batch(np.stack([rapix[sel], decpix[sel]], axis=-1),
                                    use_drawpsf=True))
        else:
            psfs = [np.asarray(inpsf((rapix[i], decpix[i]), use_drawpsf=True))
                    for i in sel]
        shp = max(pp.shape[0] for pp in psfs)
        stack = np.zeros((ns, shp + 2 * p, shp + 2 * p))
        for k, pp in enumerate(psfs):
            o = (shp - pp.shape[0]) // 2
            stack[k, p + o:p + o + pp.shape[0], p + o:p + o + pp.shape[1]] = pp
        ctr = (shp - 1) / 2.0

        # patch pixel grids per star (static patch size; off-image masked)
        x0 = np.clip(np.floor(xsca[sel]).astype(int) - d, 0, None)
        y0 = np.clip(np.floor(ysca[sel]).astype(int) - d, 0, None)
        P = 2 * d
        gx = x0[:, None, None] + np.arange(P)[None, None, :]
        gy = y0[:, None, None] + np.arange(P)[None, :, None]
        inb = (gx < nside_sca) & (gy < nside_sca)

        qx = inpsf_oversamp * (gx - xsca[sel][:, None, None]) + ctr + p
        qy = inpsf_oversamp * (gy - ysca[sel][:, None, None]) + ctr + p
        qx, qy = np.broadcast_arrays(qx, qy)

        from .psfgrp import _use_dense

        if _use_dense():
            from .ops.interp import interp2d_dense
            from .psfgrp import compute_dtype

            dt = compute_dtype()
            vals = np.asarray(interp2d_dense(
                jnp.asarray(stack, dtype=dt),
                jnp.asarray(qx.reshape(ns, -1), dtype=dt),
                jnp.asarray(qy.reshape(ns, -1), dtype=dt))).reshape(ns, P, P) * inpsf_oversamp ** 2
        else:
            which = np.broadcast_to(np.arange(ns)[:, None, None], qx.shape).astype(np.int32)
            vals = np.asarray(interp2d_stack(
                jnp.asarray(stack), jnp.asarray(qx.ravel()), jnp.asarray(qy.ravel()),
                jnp.asarray(which.ravel()))).reshape(ns, P, P) * inpsf_oversamp ** 2

        if flux_fn is not None:
            vals = vals * np.asarray(flux_fn(xsca[sel], ysca[sel]))[:, None, None]
        for k in range(ns):
            m = inb[k]
            np.add.at(image, (gy[k].repeat(P, axis=1)[m], gx[k].repeat(P, axis=0)[m]), vals[k][m])

    return image


# ---------------------------------------------------------------------------
# extended-object (galaxy) injection
# ---------------------------------------------------------------------------

def _shear_matrix(e1, e2):
    """Distortion-convention shear matrix [[1+e1, e2], [e2, 1-e1]]/sqrt(1-e^2)."""
    e2n = e1 * e1 + e2 * e2
    if e2n >= 1.0:
        raise ValueError("shear magnitude must be < 1")
    return np.array([[1 + e1, e2], [e2, 1 - e1]]) / np.sqrt(1.0 - e2n)


def _shear_expm(s1, s2):
    """Area-preserving shear exp([[s1, s2], [s2, -s1]])."""
    from scipy.linalg import expm

    return expm(np.array([[s1, s2], [s2, -s1]]))


def galaxy_ft(u, v, profile_n: float, hlr_arcsec: float, M_sky: np.ndarray,
              A_samp2sky: np.ndarray):
    """
    Fourier transform (on the sample grid) of a unit-flux galaxy whose
    profile is defined and sheared in *sky* coordinates, so all exposures
    inject a consistently oriented object regardless of roll angle.

    profile_n : Sersic index; 0.5 (Gaussian) and 1.0 (exponential) have
        closed forms -- the cases the reference test suite exercises.
    hlr_arcsec : half-light radius on the sky.
    M_sky : 2x2 shape/shear transformation in sky coordinates.
    A_samp2sky : 2x2 matrix mapping sample offsets to sky arcsec (the local
        WCS Jacobian per oversampled pixel).

    u, v : frequencies in cycles/sample.  The sheared profile's FT is the
    circular FT evaluated at M^T A^{-T} k.
    """
    kx = 2 * np.pi * u
    ky = 2 * np.pi * v
    AinvT = np.linalg.inv(A_samp2sky).T
    kxs = AinvT[0, 0] * kx + AinvT[0, 1] * ky  # cycles*2pi / arcsec
    kys = AinvT[1, 0] * kx + AinvT[1, 1] * ky
    kxp = M_sky[0, 0] * kxs + M_sky[1, 0] * kys
    kyp = M_sky[0, 1] * kxs + M_sky[1, 1] * kys
    k2 = kxp ** 2 + kyp ** 2
    if abs(profile_n - 0.5) < 1e-12:
        sigma = hlr_arcsec / np.sqrt(2 * np.log(2))
        return np.exp(-0.5 * k2 * sigma ** 2)
    if abs(profile_n - 1.0) < 1e-12:
        r0 = hlr_arcsec / 1.678346990
        return (1.0 + k2 * r0 ** 2) ** -1.5
    # general Sersic index: radially symmetric profile -> Hankel-transform
    # table (unit flux, Re = 1), evaluated at k*Re
    kq = np.sqrt(k2) * hlr_arcsec
    ktab, Ftab = _sersic_ft_table(round(float(profile_n), 4))
    return np.interp(np.clip(kq, 0, ktab[-1]), ktab, Ftab)


@functools.lru_cache(maxsize=16)
def _sersic_ft_table(n: float, kmax: float = 400.0, nk: int = 4096):
    """
    Hankel transform F(k) = 2 pi int I(r) J0(k r) r dr of a unit-flux
    Sersic-n profile with half-light radius Re = 1, tabulated on
    k in [0, kmax] (k in radians per Re).  The reference delegates general
    n to GalSim's Sersic class; this is the GalSim-free equivalent for the
    gsext injection layers.
    """
    from scipy.special import gammaincinv, j0

    b = float(gammaincinv(2 * n, 0.5))
    # log-spaced radial grid covering the extended Sersic wings
    r = np.geomspace(1e-5, 60.0 * max(1.0, n), 6000)
    prof = np.exp(-b * (r ** (1.0 / n)))
    w = prof * r
    k = np.linspace(0.0, kmax, nk)
    # trapezoid weights on the log grid
    dr = np.empty_like(r)
    dr[1:-1] = 0.5 * (r[2:] - r[:-2])
    dr[0] = 0.5 * (r[1] - r[0])
    dr[-1] = 0.5 * (r[-1] - r[-2])
    base = w * dr
    F = np.array([np.sum(base * j0(kk * r)) for kk in k])
    return k, F / F[0]


def parse_gsext_args(arglist):
    """Parse 'gsext' morphology arguments: n=, hlr=, shape=a:b, shear=a:b,
    rot=deg, seed=int (reference GalSimInject argument conventions)."""
    out = {"n": 0.5, "hlr": 0.1, "shape": (0.0, 0.0), "shear": None,
           "rot": None, "seed": None}
    for a in arglist:
        if "=" not in a:
            continue
        k, v = a.split("=", 1)
        k = k.strip().lower()
        if k in ("n", "hlr", "rot"):
            out[k] = float(v)
        elif k == "seed":
            out["seed"] = int(v)
        elif k in ("shape", "g"):
            p = v.split(":")
            out["shape"] = (float(p[0]), float(p[1]))
        elif k == "shear":
            p = v.split(":")
            out["shear"] = (float(p[0]), float(p[1]))
    return out


def make_extobj_image_from_grid(res, inimage, nside_sca, inpsf_oversamp, args,
                                patch_half: int = 64, chunk: int = 16,
                                psf_source=None):
    """
    Draw unit-flux extended objects at every grid point: the oversampled PSF
    is convolved with the analytic sheared galaxy profile in Fourier space,
    then resampled like a star (GalSim-free counterpart of reference
    GalSimInject.galsim_extobj_grid, layer.py:481-669).
    """
    import jax.numpy as jnp

    from .ops.interp import interp2d_stack

    image = np.zeros((nside_sca, nside_sca), dtype=np.float64)
    ipix, xsca, ysca, rapix, decpix = generate_star_grid(res, inimage.inwcs)
    if len(ipix) == 0:
        return image
    ov = inpsf_oversamp
    d = patch_half
    p = 6

    # morphology transformation in sky coordinates
    M = _shear_matrix(*args["shape"])
    if args["rot"] is not None:
        th = args["rot"] * np.pi / 180.0
        M = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) @ M
    if args["shear"] is not None:
        M = _shear_expm(*args["shear"]) @ M

    # local sample->sky Jacobian at the SCA center (arcsec per sample)
    from .wcsutil import local_partial_pixel_derivatives2

    ctr_pix = (nside_sca - 1) / 2.0
    jac = local_partial_pixel_derivatives2(inimage.inwcs, ctr_pix, ctr_pix)
    A_samp2sky = jac * 3600.0 / ov

    keep = (xsca > -d) & (xsca < nside_sca + d) & (ysca > -d) & (ysca < nside_sca + d)
    idx = np.nonzero(keep)[0]

    rng_master = np.random.default_rng(args["seed"]) if args["seed"] is not None else None

    from .psfgrp import _use_dense

    if _use_dense():
        chunk = min(chunk, 8)

    batch_fn = getattr(inimage, "get_psf_pos_batch", None)
    for start in range(0, len(idx), chunk):
        sel = idx[start:start + chunk]
        ns = len(sel)
        if psf_source is not None:
            psfs = list(psf_source(np.stack([rapix[sel], decpix[sel]], axis=-1)))
        elif batch_fn is not None:
            psfs = list(batch_fn(np.stack([rapix[sel], decpix[sel]], axis=-1),
                                 use_drawpsf=True))
        else:
            psfs = [np.asarray(inimage.get_psf_pos((rapix[i], decpix[i]),
                                                   use_drawpsf=True)) for i in sel]
        shp = max(pp.shape[0] for pp in psfs)
        # convolve each PSF with the galaxy profile in Fourier space
        uy = np.fft.fftfreq(shp)[:, None]
        ux = np.fft.rfftfreq(shp)[None, :]
        stack = np.zeros((ns, shp + 2 * p, shp + 2 * p))
        for k, pp in enumerate(psfs):
            o = (shp - pp.shape[0]) // 2
            frame = np.zeros((shp, shp))
            frame[o:o + pp.shape[0], o:o + pp.shape[1]] = pp
            Mk = M
            hlr_k = args["hlr"]
            if rng_master is not None:
                # reproducible per-object morphology (RNG subsequence keyed
                # by HEALPix index, cf. reference GalSimInject.subgen)
                sub = np.random.default_rng([args["seed"], int(ipix[sel[k]])])
                hlr_k = args["hlr"] * (0.8 + 0.4 * sub.uniform())
            gft = galaxy_ft(ux, uy, args["n"], hlr_k, Mk, A_samp2sky)
            conv = np.fft.irfft2(np.fft.rfft2(frame) * gft, s=(shp, shp))
            stack[k, p:p + shp, p:p + shp] = conv
        ctr = (shp - 1) / 2.0

        x0 = np.clip(np.floor(xsca[sel]).astype(int) - d, 0, None)
        y0 = np.clip(np.floor(ysca[sel]).astype(int) - d, 0, None)
        P = 2 * d
        gx = x0[:, None, None] + np.arange(P)[None, None, :]
        gy = y0[:, None, None] + np.arange(P)[None, :, None]
        inb = (gx < nside_sca) & (gy < nside_sca)
        qx = ov * (gx - xsca[sel][:, None, None]) + ctr + p
        qy = ov * (gy - ysca[sel][:, None, None]) + ctr + p
        qx, qy = np.broadcast_arrays(qx, qy)

        if _use_dense():
            from .ops.interp import interp2d_dense
            from .psfgrp import compute_dtype

            dt = compute_dtype()
            vals = np.asarray(interp2d_dense(
                jnp.asarray(stack, dtype=dt),
                jnp.asarray(qx.reshape(ns, -1), dtype=dt),
                jnp.asarray(qy.reshape(ns, -1), dtype=dt))).reshape(ns, P, P) * ov ** 2
        else:
            which = np.broadcast_to(np.arange(ns)[:, None, None], qx.shape).astype(np.int32)
            vals = np.asarray(interp2d_stack(
                jnp.asarray(stack), jnp.asarray(qx.ravel()), jnp.asarray(qy.ravel()),
                jnp.asarray(which.ravel()))).reshape(ns, P, P) * ov ** 2

        for k in range(ns):
            m = inb[k]
            np.add.at(image, (gy[k].repeat(P, axis=1)[m], gx[k].repeat(P, axis=0)[m]),
                      vals[k][m])
    return image


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

class Mask:
    """Permanent / cosmic-ray / file masks (reference layer.py:916-1082)."""

    @staticmethod
    def randmask(idsca, pcut, hitinfo=None):
        """Pseudorandom cosmic-ray mask: True = good pixel."""
        from scipy.signal import convolve

        seed = 100000000 + idsca[0]
        rng = np.random.default_rng(seed)
        pad = 10
        g = rng.uniform(size=(18, 2 * pad + Stn.sca_nside, 2 * pad + Stn.sca_nside))[idsca[1] - 1]
        crhits = np.where(g < pcut, 1.0, 0.0)
        if hitinfo is None:
            sm = convolve(crhits, np.ones((3, 3)), mode="same")[pad:-pad, pad:-pad]
            return sm < 0.5

    @staticmethod
    def load_permanent_mask(block):
        """Permanent mask from the config PMASK file; True = usable pixel."""
        if block.cfg.permanent_mask is None:
            print("No permanent mask")
            return None
        hdus = fits_read(block.cfg.permanent_mask)
        data = hdus[0].data
        if hdus[0].header.get("GOODVAL") == 0:
            pm = data == 0
        else:
            pm = data != 0
        print("Permanent mask loaded -->", np.count_nonzero(pm), "good pixels")
        return pm

    @staticmethod
    def load_mask_from_maskfile(cfg, obsdata, idsca):
        """Per-exposure mask file; True = good pixel."""
        without_maskfiles = ["dc2_sim", "anlsim"]
        if cfg.informat in without_maskfiles:
            return np.ones((Stn.sca_nside, Stn.sca_nside), dtype=bool)
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "mask"})
        if filename is not None and filename.endswith(".fits") and exists(filename):
            hdus = fits_read(filename)
            try:
                return hdus["MASK"].data == 0
            except KeyError:
                return hdus[0].data == 0
        return np.ones((Stn.sca_nside, Stn.sca_nside), dtype=bool)

    @staticmethod
    def load_cr_mask(inimage):
        """Cosmic-ray mask for an exposure (True = good), or None."""
        config = inimage.blk.cfg
        if config.cr_mask_rate > 0:
            cr_mask = Mask.randmask(inimage.idsca, config.cr_mask_rate)
            try:
                idx = config.extrainput.index("labnoise")
            except ValueError:
                pass
            else:
                cr_mask = np.logical_and(
                    cr_mask, np.abs(inimage.indata[idx]) < config.labnoisethreshold)
            return cr_mask
        return None


# ---------------------------------------------------------------------------
# layer dispatch
# ---------------------------------------------------------------------------

def _build_extra_layer(spec: str, inimage) -> np.ndarray | None:
    """Build one extra input layer from its EXTRAINPUT spec string."""
    cfg = inimage.blk.cfg
    idsca = inimage.idsca
    obsdata = inimage.blk.obsdata
    nside = Stn.sca_nside

    m = re.search(r"^whitenoise(\d+)$", spec, re.IGNORECASE)
    if m:
        seed = layer_seed(int(m.group(1)), idsca)
        rng = np.random.default_rng(seed)
        return rng.normal(size=(nside, nside)).astype(np.float32)

    m = re.search(r"^1fnoise(\d+)$", spec, re.IGNORECASE)
    if m:
        return noise_1f_frame(layer_seed(int(m.group(1)), idsca))

    m = re.search(r"^(cstar|gsstar|gstrstar)(\d+)$", spec, re.IGNORECASE)
    if m:
        # 'gsstar'/'gstrstar' are drawn with the same batched interpolation
        # as 'cstar' (see module docstring); the angle-transient variant
        # ('gstrstar') injects only for one of the two pass angles.
        if m.group(1).lower() == "gstrstar":
            pa = float(obsdata["pa"][idsca[0]])
            if not pa < 90.0:  # transient present in first-pass geometry only
                return np.zeros((nside, nside), dtype=np.float32)
        res = int(m.group(2))
        return make_image_from_grid(res, inimage.get_psf_pos, idsca, obsdata,
                                    inimage.inwcs, nside, cfg.inpsf_oversamp
                                    ).astype(np.float32)

    m = re.search(r"^gsfdstar(\d+),(.+)$", spec, re.IGNORECASE)
    if m:
        # field-dependent star flux: 1 at the FPA center rising to 1+amp at
        # the corners (reference layer.py:1419-1434, 273-276)
        from .config import fpaCoords

        res = int(m.group(1))
        amp = float(m.group(2))
        sca = idsca[1]

        def flux_fn(xs, ys):
            xf, yf = fpaCoords.pix2fpa(sca, xs, ys)
            return 1.0 + amp * (xf ** 2 + yf ** 2) / fpaCoords.Rfpa ** 2

        return make_image_from_grid(res, inimage.get_psf_pos, idsca, obsdata,
                                    inimage.inwcs, nside, cfg.inpsf_oversamp,
                                    flux_fn=flux_fn).astype(np.float32)

    m = re.search(r"^(gsext|gsextchrom)(\d+)(,|$)", spec, re.IGNORECASE)
    if m:
        res = int(m.group(2))
        raw = spec.split(",")[1:]
        psf_source = None
        if m.group(1).lower() == "gsextchrom" and raw and "=" not in raw[0]:
            # chromatic variant: inject with the PSF cube from the given
            # directory instead of the run PSF (reference layer.py:1446-1456)
            chrom_path = raw[0]
            raw = raw[1:]
            fname = chrom_path + f"/psf_polyfit_{idsca[0]:d}.fits"
            if exists(fname):
                from .ops import psfmodels

                cube = np.asarray(fits_read(fname)[idsca[1]].data,
                                  dtype=np.float64)

                def psf_source(points):
                    px, py = inimage.inwcs.world2pix(points[:, 0], points[:, 1])
                    psfs = psfmodels.eval_psf_cube_batch(cube, px, py,
                                                         nside=nside)
                    return psfmodels.smooth_and_pad_batch(
                        psfs, tophatwidth=cfg.inpsf_oversamp)
            else:
                # a missing chromatic PSF cube is a config mistake: the
                # reference opens the file unconditionally and raises
                # (reference layer.py:1446-1456 via GalSimInject.get_psf)
                raise FileNotFoundError(
                    f"gsextchrom: chromatic PSF cube {fname} not found "
                    f"(layer spec {spec!r})")
        args = parse_gsext_args(raw)
        return make_extobj_image_from_grid(res, inimage, nside, cfg.inpsf_oversamp,
                                           args, psf_source=psf_source
                                           ).astype(np.float32)

    m = re.search(r"^nstar(\d+),", spec, re.IGNORECASE)
    if m:
        res = int(m.group(1))
        extargs = spec.split(",")[1:]
        tot_int, bg, q = float(extargs[0]), float(extargs[1]), int(extargs[2])
        rng = np.random.default_rng(layer_seed(q, idsca))
        brightness = make_image_from_grid(res, inimage.get_psf_pos, idsca, obsdata,
                                          inimage.inwcs, nside, cfg.inpsf_oversamp)
        lam = brightness * tot_int + bg
        lam_c = np.clip(lam, 0, None)
        return (rng.poisson(lam=lam_c) - lam_c + lam - bg).astype(np.float32)

    m = re.search(r"^noise,(\S+)$", spec, re.IGNORECASE)
    if m:
        # saved noise realizations from the L2 preprocessing (reference
        # layer.py:1460-1490): pick the slice whose label matches
        noiselabel = m.group(1)
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "noise"})
        if filename and exists(filename):
            if filename.endswith(".asdf"):
                from .asdfio import asdf_read

                tree = asdf_read(filename)
                labels = list(tree["config"]["NOISE"]["LAYER"])
                data = np.asarray(tree["noise"])
            else:
                f = fits_read(filename)
                labels = [str(f[0].header.get(f"NOISE{j:d}", "")).strip()
                          for j in range(len(f) - 0)]
                data = np.asarray(f[0].data)
            jn_use = -1
            for jn, lab in enumerate(labels):
                if lab == noiselabel and jn_use < 0:
                    jn_use = jn
            if jn_use < 0:
                print(f"noise layer {noiselabel!r} not found in {filename}",
                      flush=True)
                return np.zeros((nside, nside), dtype=np.float32)
            sl = data[jn_use] if data.ndim == 3 else data
            return np.asarray(sl[:nside, :nside], dtype=np.float32)
        return np.zeros((nside, nside), dtype=np.float32)

    if spec.casefold() == "truth" or spec.lower().startswith("truth,"):
        rescale = 1.0
        mm = re.search(r"^truth,(.+)$", spec, re.IGNORECASE)
        if mm:
            rescale = float(mm.group(1))
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "truth"})
        if filename and exists(filename):
            layer = np.asarray(fits_read(filename)[0].data, dtype=np.float32)
            return layer * rescale
        return None

    if spec.casefold() == "labnoise":
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "labnoise"})
        if filename and exists(filename):
            data = np.asarray(fits_read(filename)[0].data, dtype=np.float32)
            if data.shape[0] == 4096:
                data = data[4:4092, 4:4092]
            return data
        print("Warning: labnoise file not found, skipping ...")
        return None

    if spec.casefold() == "skyerr":
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "skyerr"})
        if filename and exists(filename):
            hdus = fits_read(filename)
            return (np.asarray(hdus["ERR"].data, dtype=np.float32)
                    - float(hdus["SCI"].header["SKY_MEAN"]))
        return None

    raise ValueError(f"unsupported EXTRAINPUT layer spec: {spec!r}")


@contextlib.contextmanager
def cache_lock(path: str, timeout: float):
    """
    Exclusive advisory lock on the file `path` (created if missing), shared
    by every process on the machine.  Yields True once held, or False when
    `timeout` seconds pass without it: the caller then goes on without the
    cache, as the reference does (layer.py:1236-1249).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    yield False
                    return
                time.sleep(0.05)
        try:
            yield True
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)


def get_all_data(inimage, timeout: float = 300.0) -> None:
    """
    Fill inimage.indata with the (n_inframe, nside, nside) layer cube,
    loading from / saving to the INLAYERCACHE when configured (with file
    locks for cross-process safety; reference layer.py:1199-1529).
    """
    cfg = inimage.blk.cfg
    idsca = inimage.idsca
    nside = Stn.sca_nside

    cache_path = None
    if cfg.inlayercache:
        cache_path = cfg.inlayercache + f"_{idsca[0]:08d}_{idsca[1]:02d}.fits"
        with cache_lock(cache_path + ".lock", 30.0) as held:
            if held and exists(cache_path):
                print("loading input layer <<", cache_path)
                inimage.indata = np.asarray(fits_read(cache_path)[0].data,
                                            dtype=np.float32)
                sys.stdout.flush()
                return

    indata = np.zeros((cfg.n_inframe, nside, nside), dtype=np.float32)
    filename = get_sca_imagefile(cfg.inpath, idsca, inimage.blk.obsdata, cfg.informat)
    if filename and exists(filename):
        indata[0] = read_sci_frame(filename, cfg.informat)

    inimage.indata = indata
    for i in range(1, cfg.n_inframe):
        layer = _build_extra_layer(cfg.extrainput[i], inimage)
        if layer is not None:
            indata[i] = layer

    if cache_path is not None:
        with cache_lock(cache_path + ".lock", timeout) as held:
            if held:
                print("saving input layer >>", cache_path)
                hdus = [ImageHDU(indata)]
                sciwcs = _sciwcs_hdu(inimage, filename)
                if sciwcs is not None:
                    hdus.append(sciwcs)
                fits_write(cache_path, HDUList(hdus))
    sys.stdout.flush()


def _sciwcs_hdu(inimage, src_file):
    """
    SCIWCS HDU recording the science WCS of a cached layer cube, so
    downstream stages (wing subtraction) can map pixels without the
    original exposure (reference layer.py:1500-1529).  FITS-style WCS
    objects serialize their header cards (WCSTYPE='FITS'); GWCS records
    the source ASDF path (WCSTYPE='GWCS', WCSSRC) for re-reading, in
    place of the reference's ancillary ``*_wcs.asdf`` copy.
    """
    from .fitsio import Header

    inwcs = getattr(inimage, "inwcs", None)
    if inwcs is None:
        return None
    if hasattr(inwcs, "to_header"):
        hdu = ImageHDU(np.zeros((1, 1), dtype=np.uint8),
                       header=Header(inwcs.to_header()), name="SCIWCS")
        hdu.header["WCSTYPE"] = "FITS"
        return hdu
    src = getattr(inimage, "infile", None) or src_file
    if not src:
        return None
    hdu = ImageHDU(np.zeros((1, 1), dtype=np.uint8), name="SCIWCS")
    hdu.header["WCSTYPE"] = "GWCS"
    hdu.header["WCSSRC"] = str(src)
    return hdu
