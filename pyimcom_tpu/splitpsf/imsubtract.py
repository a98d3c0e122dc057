"""
Wing subtraction: remove K (*) (coadded mosaic) from cached input exposures.

Counterpart of reference src/pyimcom/splitpsf/imsubtract.py.  The heavy
kernel is :func:`fftconvolve_multi` -- a valid-mode FFT convolution of one
large canvas with a stack of kernels sharing one forward transform -- which
on accelerators runs as batched jnp.fft; the per-exposure resampling back
to the SCA frame reuses the framework's interpolation ops.
"""

from __future__ import annotations

import os

import numpy as np


def fftconvolve_multi(canvas: np.ndarray, kernels: np.ndarray,
                      use_jax: bool = None) -> np.ndarray:
    """
    Valid-mode convolution of `canvas` (ny, nx) with a stack of `kernels`
    (nk, my, mx): returns (nk, ny-my+1, nx-mx+1).  The canvas is transformed
    once and multiplied against every kernel spectrum (reference
    imsubtract.py:48-130).
    """
    ny, nx = canvas.shape
    nk, my, mx = kernels.shape
    oy, ox = ny - my + 1, nx - mx + 1
    if oy <= 0 or ox <= 0:
        raise ValueError("kernel larger than canvas")

    if use_jax is None:
        import jax

        use_jax = jax.default_backend() != "cpu"

    if use_jax:
        import jax.numpy as jnp

        cf = jnp.fft.rfft2(jnp.asarray(canvas), s=(ny, nx))
        kf = jnp.fft.rfft2(jnp.asarray(kernels), s=(ny, nx))
        full = jnp.fft.irfft2(cf[None] * kf, s=(ny, nx))
        out = np.asarray(full[:, my - 1:my - 1 + oy, mx - 1:mx - 1 + ox])
    else:
        # threaded host FFTs (reference imsubtract.py:108-124 worker control)
        import scipy.fft as sfft

        nw = fft_workers()
        cf = sfft.rfft2(canvas, s=(ny, nx), workers=nw)
        kf = sfft.rfft2(kernels, s=(ny, nx), workers=nw)
        full = sfft.irfft2(cf[None] * kf, s=(ny, nx), workers=nw)
        out = full[:, my - 1:my - 1 + oy, mx - 1:mx - 1 + ox]
    return out


def tukey_window_1d(n: int, width: int) -> np.ndarray:
    """Flat-top window with cosine tapers of `width` samples on each side."""
    w = np.ones(n)
    if width > 0:
        t = 0.5 * (1 - np.cos(np.pi * np.arange(1, width + 1) / (width + 1)))
        w[:width] = t
        w[-width:] = t[::-1]
    return w


def tukey_window_2d(n: int, width: int) -> np.ndarray:
    w = tukey_window_1d(n, width)
    return np.outer(w, w)


def subtract_wings_from_exposure(exposure_image, exposure_wcs, mosaic_image,
                                 mosaic_wcs, K_cube, oversamp,
                                 eval_legendre_at=None):
    """
    Subtract the long-range PSF contribution from one exposure.

    The (Gamma-smoothed) coadded mosaic is convolved with the exposure's
    wing kernel K (evaluated at the exposure center unless
    `eval_legendre_at` provides per-position Legendre weights) and the
    result is resampled onto the exposure grid and subtracted.

    Returns the corrected exposure image.  This is the single-canvas core
    of the reference's per-block stitched pipeline (imsubtract.py:265-725);
    the blockwise Tukey-stitched driver composes it over mosaic blocks.
    """
    import jax.numpy as jnp

    from ..ops.interp import interp2d, interp2d_dense
    from ..psfgrp import _use_dense

    # kernel at the exposure center (constant Legendre term if no evaluator)
    if eval_legendre_at is None:
        K = K_cube[0]
    else:
        K = np.einsum("a,aij->ij", eval_legendre_at, K_cube)

    conv = fftconvolve_multi(mosaic_image, K[None])[0]
    # mosaic pixel coordinates of the valid-convolution origin
    my, mx = K.shape
    off_y, off_x = (my - 1) / 2.0, (mx - 1) / 2.0

    ny, nx = exposure_image.shape
    yy, xx = np.mgrid[0:ny, 0:nx]
    ra, dec = exposure_wcs.pix2world(xx.ravel().astype(float), yy.ravel().astype(float))
    gx, gy = mosaic_wcs.world2pix(ra, dec)
    # positions within the valid-convolution frame
    qx = gx - off_x + 6
    qy = gy - off_y + 6
    # wing subtraction uses the faster G4460 family, matching the
    # reference's unconditional iG4460C resample (imsubtract.py:652)
    pad = np.pad(conv, 6)
    if _use_dense():
        vals = np.asarray(interp2d_dense(jnp.asarray(pad)[None],
                                         jnp.asarray(qx)[None],
                                         jnp.asarray(qy)[None], "G4460"))[0]
    else:
        vals = np.asarray(interp2d(jnp.asarray(pad), jnp.asarray(qx),
                                   jnp.asarray(qy), "G4460"))
    return exposure_image - vals.reshape(ny, nx)


# --------------------------------------------------------------------------
# Blockwise stitched driver: walk the mosaic's blocks, Tukey-window each,
# resample onto an oversampled SCA canvas, convolve with the Legendre wing
# kernels, and subtract from the cached input cube
# (reference imsubtract.py:265-844).
# --------------------------------------------------------------------------


def _interp_scattered(image2d, qx, qy, kern="G4460"):
    """Interpolate one padded host image at scattered points.

    The wing-subtraction resample defaults to the faster 8x8 G4460 kernel,
    matching the reference's unconditional iG4460C call (imsubtract.py:652).
    """
    import jax.numpy as jnp

    from ..ops.interp import interp2d, interp2d_dense
    from ..psfgrp import _use_dense, compute_dtype

    if _use_dense():
        return np.asarray(interp2d_dense(
            jnp.asarray(image2d, dtype=compute_dtype())[None],
            jnp.asarray(qx)[None], jnp.asarray(qy)[None], kern))[0]
    return np.asarray(interp2d(jnp.asarray(image2d), jnp.asarray(qx),
                               jnp.asarray(qy), kern))


def build_wing_canvas(exposure_wcs, block_reader, nblock: int, overlap: int,
                      x_canvas: np.ndarray, layer: int,
                      out: np.ndarray = None) -> np.ndarray:
    """
    Stitch the Tukey-windowed mosaic blocks of one layer onto the exposure's
    oversampled canvas (reference imsubtract.py:493-686).

    block_reader(ix, iy) -> (data (n_out, nlayer, N, N) or (N, N), WCS) or
    None if the block does not exist.  Adjacent blocks overlap by
    2*`overlap` output pixels; the complementary cosine tapers sum to unity
    there, so the stitched mosaic is seamless.  Each resampled value is
    multiplied by the exposure pixel solid angle in ideal-output-pixel
    units (surface-brightness -> flux conversion).
    """
    from ..config import Settings as Stn
    from ..wcsutil import get_pix_area

    A = len(x_canvas)
    if out is not None:
        H = out
        H[:] = 0.0
    else:
        H = np.zeros((A, A))
    gx, gy = np.meshgrid(x_canvas, x_canvas)   # (A, A); gx varies along x
    ra, dec = exposure_wcs.pix2world(gx.ravel(), gy.ravel())

    area = get_pix_area(exposure_wcs, gx.ravel(), gy.ravel()) \
        / Stn.pixscale_native ** 2

    for iy in range(nblock):
        for ix in range(nblock):
            got = block_reader(ix, iy)
            if got is None:
                continue
            data, bwcs = got
            data = np.asarray(data, dtype=np.float64)
            if data.ndim == 4:
                data = data[0, layer]
            N = data.shape[-1]
            xb, yb = bwcs.world2pix(ra, dec)
            inside = (xb > -5.5) & (xb < N + 4.5) & (yb > -5.5) & (yb < N + 4.5)
            if not np.any(inside):
                continue
            w = tukey_window_1d(N, 2 * overlap)
            pad = np.pad(data * w[:, None] * w[None, :], 6)
            vals = _interp_scattered(pad, xb[inside] + 6, yb[inside] + 6)
            Hf = H.ravel()
            Hf[inside] += vals * area[inside]
    return H


def subtract_wings_blockwise(cube, exposure_wcs, K_cube, oversamp: int,
                             nblock: int, overlap: int, block_reader,
                             porder: int = None, max_layers: int = None,
                             use_memmap: bool = False):
    """
    Subtract K (*) (stitched mosaic) from every layer of one exposure cube.

    cube : (nlayer, n, n) cached input cube (modified copy returned).
    K_cube : (npoly, axis, axis) Legendre wing kernels on the `oversamp`
        grid, index lu + lv*Nl (reference imsubtract.py:523-529,689-708).
    """
    cube = np.array(cube, dtype=np.float32)
    nlayer, sca_nside = cube.shape[0], cube.shape[-1]
    npoly, axis_num = K_cube.shape[0], K_cube.shape[-1]
    Nl = porder + 1 if porder is not None and porder >= 0 \
        else int(np.floor(np.sqrt(npoly + 0.5)))

    I_pad = int(np.ceil(axis_num / 2 / oversamp))
    first = (oversamp + 2 * oversamp * I_pad - axis_num) // 2
    A = oversamp * (sca_nside + 2 * I_pad)
    x_canvas = np.linspace(-I_pad - 0.5 + 0.5 / oversamp,
                           sca_nside + I_pad - 0.5 - 0.5 / oversamp, A)
    u_canvas = (x_canvas - (sca_nside - 1) / 2) / (sca_nside / 2)
    leg = np.polynomial.legendre.Legendre
    lvals = np.stack([leg.basis(l)(u_canvas) for l in range(Nl)])

    nrun = nlayer if max_layers is None else min(nlayer, max_layers)
    canvas_mm = None
    if use_memmap:
        # memmapped canvas scratch (reference imsubtract.py:463-474): bounds
        # peak RAM for production 4088-px exposures at 8x oversampling
        import tempfile

        tmpd = os.environ.get("TMPDIR", tempfile.gettempdir())
        canvas_mm = np.memmap(os.path.join(
            tmpd, f"imsub_canvas_{os.getpid()}.dat"), dtype=np.float64,
            mode="w+", shape=(A, A))
    for n in range(nrun):
        H = build_wing_canvas(exposure_wcs, block_reader, nblock, overlap,
                              x_canvas, n, out=canvas_mm)
        # Legendre-weighted canvases share one convolution sweep
        arrs = np.stack([H * lvals[lv][:, None] * lvals[lu][None, :]
                         for lv in range(Nl) for lu in range(Nl)])
        kerns = np.stack([K_cube[lu + lv * Nl]
                          for lv in range(Nl) for lu in range(Nl)])
        KH = np.zeros((A - axis_num + 1, A - axis_num + 1))
        for a, k in zip(arrs, kerns):
            KH += fftconvolve_multi(a, k[None])[0]
        cube[n] -= KH[first::oversamp, first::oversamp][:sca_nside,
                                                        :sca_nside]
    return cube


def _default_block_reader(outstem: str):
    """Read coadded block FITS files written by Block.build_output_file."""
    from ..fitsio import fits_read
    from ..wcsutil import WCS

    def reader(ix, iy):
        path = f"{outstem}_{ix:02d}_{iy:02d}.fits"
        if not os.path.exists(path):
            return None
        f = fits_read(path)
        return np.asarray(f[0].data), WCS.from_header(f[0].header)

    return reader


def reinterp(arr):
    """
    2x2 bin an oversampled kernel without growing the pixel tophat:
    interpolate arr[1:-1, 1:-1] onto a grid at double the spacing
    (reference imsubtract.py:241-262; the separable [-1/8, 9/8, 9/8, -1/8]
    filter is the cubic-interpolation midpoint stencil).
    """
    import scipy.signal

    _f = np.array([-0.125, 1.125, 1.125, -0.125], dtype=np.float64)
    f2d = np.outer(_f, _f)
    return scipy.signal.convolve(arr, f2d, mode="valid", method="direct")[::2, ::2]


def bin_kernel_2x2(K: np.ndarray, oversamp: int):
    """
    Downsample a Legendre wing-kernel cube to half the oversampling
    (reference imsubtract.py:360-384; PSFSPLIT[3] = bin2x2).  Returns
    (K_binned, oversamp // 2).
    """
    ncoeff, axis_num = K.shape[0], K.shape[1]
    if oversamp % 2:
        raise ValueError(f"oversamp={oversamp:d} is odd, not consistent with bin2x2")
    oversamp //= 2
    axis_num //= 2
    if oversamp % 2 and not (axis_num // oversamp) % 2:
        # trim 1 native pixel so axis_num / oversamp is odd
        axis_num -= oversamp
        K = K[:, oversamp - 1:1 - oversamp, oversamp - 1:1 - oversamp]
    else:
        K = np.pad(K, ((0, 0), (1, 1), (1, 1)), mode="edge")
    out = None
    for j in range(ncoeff):
        Ks = reinterp(K[j])
        if out is None:
            out = np.zeros((ncoeff,) + Ks.shape, dtype=np.float64)
        out[j] = Ks
    return out, oversamp


def fft_workers() -> int:
    """Threaded-FFT worker count (reference imsubtract.py:108-124:
    scipy.fft workers from SLURM_CPUS_PER_TASK / OMP_NUM_THREADS)."""
    for var in ("PYIMCOM_FFT_WORKERS", "SLURM_CPUS_PER_TASK",
                "OMP_NUM_THREADS"):
        val = os.environ.get(var)
        if val:
            try:
                return max(1, int(val))
            except ValueError:
                pass
    return 1


def run_imsubtract(cfg, idsca, split_file: str, out_file: str = None,
                   oversamp: int = None, max_layers: int = None,
                   bin2x2: bool = None, use_memmap: bool = False) -> str:
    """
    Wing-subtract one cached exposure and write `*_subI.fits`
    (reference imsubtract.py:265-729).

    split_file : split-PSF FITS from splitpsf.split_psf_to_fits; the wing
        kernel for SCA s is HDU[KERSKIP + s].
    """
    from ..fitsio import HDUList, ImageHDU, fits_read, fits_write
    from ..wcsutil import WCS

    obsid, sca = idsca
    cache = cfg.inlayercache + f"_{obsid:08d}_{sca:02d}.fits"
    f = fits_read(cache)
    cube = np.asarray(f[0].data, dtype=np.float32)
    if cube.ndim == 2:
        cube = cube[None]
    wcs_ = get_cache_wcs(f)

    sf = fits_read(split_file)
    kerskip = int(sf[0].header.get("KERSKIP", (len(sf) - 1) // 2))
    K_cube = np.asarray(sf[kerskip + sca].data, dtype=np.float64)
    if oversamp is None:
        oversamp = int(sf[0].header.get("OVSAMP", 1))
    if bin2x2 is None:
        bin2x2 = bool(getattr(cfg, "psfsplit_bin2x2", False))
    if bin2x2:
        # halve the kernel oversampling: 4x fewer canvas samples and ~4x
        # cheaper convolutions at slightly reduced wing resolution
        K_cube, oversamp = bin_kernel_2x2(K_cube, oversamp)

    overlap = cfg.n2 * cfg.postage_pad
    reader = _default_block_reader(cfg.outstem)
    out = subtract_wings_blockwise(cube, wcs_, K_cube, oversamp, cfg.nblock,
                                   overlap, reader, max_layers=max_layers,
                                   use_memmap=use_memmap)

    if out_file is None:
        out_file = cfg.inlayercache + f"_{obsid:08d}_{sca:02d}_subI.fits"
    hdu = ImageHDU(out.astype(np.float32))
    hdu.header = f[0].header
    # carry the SCIWCS HDU forward so update_cube's swap keeps the cache
    # self-describing for the next wing-subtraction iteration
    extra = [h for h in list(f)[1:] if h.name == "SCIWCS"]
    fits_write(out_file, HDUList([hdu] + extra))
    return out_file


def get_cache_wcs(hdus):
    """
    WCS of a cached input-layer file (reference imsubtract.py:190-216
    ``get_wcs``): prefer the SCIWCS HDU written by the layer stage —
    FITS-style cards, or a WCSSRC pointer back to the exposure's ASDF
    file for GWCS — falling back to the primary header for legacy caches.
    """
    from ..wcsutil import WCS

    try:
        sw = hdus["SCIWCS"]
    except KeyError:
        sw = None
    if sw is not None:
        wcstype = str(sw.header.get("WCSTYPE", "FITS")).strip().upper()
        if wcstype.startswith("GWCS"):
            from ..asdfio import GWCS, asdf_read

            tree = asdf_read(str(sw.header["WCSSRC"]).strip())
            return GWCS(tree["roman"]["meta"]["wcs"])
        return WCS.from_header(sw.header)
    return WCS.from_header(hdus[0].header)


def run_imsubtract_all(cfg, idscas, split_file: str, nworkers: int = None,
                       **kw) -> list:
    """
    Wing-subtract every exposure of a mosaic (reference
    imsubtract_wrapper.py:12-106).  Work items are independent; with
    nworkers > 1 they run in a process pool (forkserver, matching the
    reference), otherwise serially in-process (one process per
    accelerator).
    """
    if nworkers and nworkers > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        with cf.ProcessPoolExecutor(max_workers=nworkers,
                                    mp_context=ctx) as ex:
            futs = [ex.submit(run_imsubtract, cfg, idsca, split_file, **kw)
                    for idsca in idscas]
            return [fu.result() for fu in futs]
    return [run_imsubtract(cfg, idsca, split_file, **kw) for idsca in idscas]


def main(cfgfile, sca: int, nworkers: int = None):
    """
    Wing-subtract every cached exposure using the given SCA (reference
    job-array entry ``python -m pyimcom.splitpsf.imsubtract cfg sca``,
    imsubtract.py:265 / imsubtract_wrapper.py:12).

    The split-PSF file for observation `obsid` is
    INLAYERCACHE.psf/psf_{obsid}.fits (written by splitpsf.main); exposures
    are discovered from the input-layer cache.
    """
    import glob
    import re

    from ..config import Config

    cfg = cfgfile if hasattr(cfgfile, "inlayercache") else Config(cfgfile)
    pat = re.compile(r"_(\d{8})_(\d{2})\.fits$")
    idscas = []
    for path in sorted(glob.glob(cfg.inlayercache + "_*_*.fits")):
        mm = pat.search(path)
        if mm and int(mm.group(2)) == sca:
            idscas.append((int(mm.group(1)), sca))
    done = []
    for idsca in idscas:
        split_file = cfg.inlayercache + f".psf/psf_{idsca[0]:d}.fits"
        if not os.path.exists(split_file):
            print(f"imsubtract: no split PSF for obsid {idsca[0]}, skipping",
                  flush=True)
            continue
        done.append(run_imsubtract(cfg, idsca, split_file))
        print("imsubtract: wrote", done[-1], flush=True)
    return done


if __name__ == "__main__":
    # python -m pyimcom_tpu.splitpsf.imsubtract <config.json> <sca>
    import sys

    main(sys.argv[1], int(sys.argv[2]))
