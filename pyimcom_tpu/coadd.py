"""
Block coaddition driver.

Counterpart of reference src/pyimcom/coadd.py (InImage/InStamp/OutStamp/
Block).  The host orchestrates geometry, caching, and I/O; every hot
numerical step -- PSF sampling, FFT overlaps, system-matrix interpolation,
and the T solves -- runs on device through the modules in ops/, psfgrp, and
solvers.

Processing layout (mirrors the reference's two-pass scheme,
coadd.py:2003-2081): a simulation pass counts references to PSF groups,
overlap stacks, and A submatrices; the real pass computes them on demand and
frees each object when its count reaches zero, bounding memory.

Solver calls use bucketed zero-padding (n rounded up to a multiple of 128)
so XLA compiles one program per bucket instead of one per stamp.
"""

from __future__ import annotations


import bisect
import os
import time
from itertools import combinations, product
from os.path import exists

import numpy as np

from .config import Config, Settings as Stn, Timer
from .fitsio import HDUList, Header, ImageHDU, TableHDU, fits_read, fits_write
from .layer import Mask, check_if_idsca_exists, get_all_data
from .ops import psfmodels
from . import psfgrp as _psfgrp
from .psfgrp import (
    PSFGeometry,
    PSFGroup,
    _interp_rects_dense,
    build_overlap_stack,
    interp_io_submatrix,
    interp_submatrix,
    io_submatrix_rect_plan,
    outpsf_C_values,
    sample_psf_rotated,
    sample_psf_rotated_batch,
    sample_psf_unrotated,
    submatrix_rect_plan,
)
from .profiling import phase as _phase, report as _profile_report, sync as _sync
from .wcsutil import WCS, make_block_wcs

SOLVE_BUCKET = 128

# metadata row/batch counts are padded onto this ~1.5x geometric ladder so
# the fused scatter programs compile for only a handful of distinct shapes
_PAD_LADDER = tuple(sorted({1 << p for p in range(3, 22)}
                           | {3 << p for p in range(2, 21)}))


def _scan_pad(n: int) -> int:
    """Smallest ladder value >= n (bounds distinct compiled shapes)."""
    for v in _PAD_LADDER:
        if v >= n:
            return v
    return n


class _ShapeRungs:
    """
    Deterministic geometric shape quantizer.

    The fused group programs take several operands whose natural sizes
    differ slightly for every 2x2 stamp group (submatrix-pool length,
    selection-map length, overlap-stack rows, solve padding).  Compiling
    one XLA program per unique size made full production blocks
    compile-bound: a fresh compile every few groups for the whole block.

    `fit(kind, n, quantum)` rounds n up onto a fixed ladder: multiples of
    `quantum` spaced by ~8% (`headroom`).  Distinct compiled shapes per
    kind are O(log_1.08(max/min)) instead of O(#groups) -- and, because
    the ladder depends only on (quantum, headroom), the SAME sizes come
    back in every process: a watchdog-restarted or resumed block replays
    identical shapes and hits the persistent XLA compile cache instead of
    re-entering a compile storm (the earlier per-run "sticky" quantizer
    minted different rungs after every restart).  Padding is numerically
    neutral everywhere these sizes are used (identity solve padding,
    never-read pool/selmap/stack tails).
    """

    def __init__(self, headroom: float = 1.08):
        self.headroom = headroom
        self._ladders: dict[int, list[int]] = {}

    def fit(self, kind: str, n: int, quantum: int = 128) -> int:
        lad = self._ladders.setdefault(quantum, [quantum])
        n = max(int(n), 1)
        while lad[-1] < n:
            lad.append(max(
                lad[-1] + quantum,
                int(np.ceil(lad[-1] * self.headroom / quantum)) * quantum))
        return lad[bisect.bisect_left(lad, n)]


class _SubmatStore:
    """
    System-submatrix cache with optional disk spill.

    With a TEMPFILE directory configured, large entries are np.save'd and
    reloaded on demand instead of held in RAM -- the reference's
    virtual-memory spill for SysMatA submatrices (psfutil.py:2056-2085).
    Dict-style access keeps the call sites unchanged.
    """

    SPILL_BYTES = 1 << 18

    def __init__(self, tempdir=None, tag=""):
        self.tempdir = tempdir
        self.tag = tag
        self.mem = {}
        self.disk = {}
        self._ctr = 0

    def __contains__(self, key):
        return key in self.mem or key in self.disk

    def __setitem__(self, key, arr):
        if self.tempdir and arr.nbytes > self.SPILL_BYTES:
            os.makedirs(self.tempdir, exist_ok=True)
            path = os.path.join(self.tempdir,
                                f"submat{self.tag}_{os.getpid()}_{self._ctr}.npy")
            self._ctr += 1
            np.save(path, arr)
            self.disk[key] = path
        else:
            self.mem[key] = arr

    def __getitem__(self, key):
        if key in self.mem:
            return self.mem[key]
        return np.load(self.disk[key])

    def __delitem__(self, key):
        if key in self.mem:
            del self.mem[key]
        else:
            path = self.disk.pop(key)
            try:
                os.remove(path)
            except OSError:
                pass

    def pop(self, key, default=None):
        if key in self:
            val = self[key]
            del self[key]
            return val
        return default


def _device_f64(x):
    """Upcast on device (used to ship f32 over the host->device link)."""
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda a: a.astype(jnp.float64))(x)


def _device_f32(x):
    """Downcast on device before a device->host transfer."""
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda a: a.astype(jnp.float32))(x)


def trapezoid(arr, fade_kernel, recover_mode=False, pad_widths=(0, 0, 0, 0),
              do_sides="BTLR", use_trunc_sinc=True):
    """
    In-place trapezoid cross-fade over 2*fade_kernel transition rows/columns
    on each requested side (reference OutStamp.trapezoid, coadd.py:1221-1292).
    """
    fk2 = fade_kernel * 2
    if fk2 <= 0:
        return
    ny, nx = arr.shape[-2:]
    pb, pt, pl, pr = pad_widths
    it, ir = ny - pt - 1, nx - pr - 1

    s = np.arange(1, fk2 + 1, dtype=np.float64) / (fk2 + 1)
    if use_trunc_sinc:
        s -= np.sin(2 * np.pi * s) / (2 * np.pi)
    sT = s[:, None]

    if not recover_mode:
        if "B" in do_sides:
            arr[..., pb:pb + fk2, :] *= sT
        if "T" in do_sides:
            arr[..., it:it - fk2 if it - fk2 >= 0 else None:-1, :] *= sT
        if "L" in do_sides:
            arr[..., :, pl:pl + fk2] *= s
        if "R" in do_sides:
            arr[..., :, ir:ir - fk2 if ir - fk2 >= 0 else None:-1] *= s
    else:
        if "B" in do_sides:
            arr[..., pb:pb + fk2, :] /= sT
        if "T" in do_sides:
            arr[..., it:it - fk2 if it - fk2 >= 0 else None:-1, :] /= sT
        if "L" in do_sides:
            arr[..., :, pl:pl + fk2] /= s
        if "R" in do_sides:
            arr[..., :, ir:ir - fk2 if ir - fk2 >= 0 else None:-1] /= s


def compress_map(map_, coef, dtype):
    """Log-quantize a float map to (u)int16 (reference coadd.py:2086-2138)."""
    if dtype == np.uint16:
        a_min, a_max = 0, 65535
    else:
        a_min, a_max = -32768, 32767
    return np.clip(np.floor(coef * np.log10(np.clip(map_, 1e-32, None)) + 0.5),
                   a_min, a_max).astype(dtype)


class InImage:
    """One input exposure/SCA: WCS, pixel partition, layers, PSF access."""

    def __init__(self, blk: "Block", idsca):
        self.blk = blk
        self.idsca = idsca
        self.exists_, self.infile = check_if_idsca_exists(blk.cfg, blk.obsdata, idsca)
        self.is_relevant = False
        if self.exists_:
            if self.infile.endswith(".asdf"):
                # Roman L2 ASDF: evaluable GWCS subset (reference
                # coadd.py:110-113 wraps the gwcs object the same way)
                from .asdfio import GWCS, asdf_read

                tree = asdf_read(self.infile)
                self.inwcs = GWCS(tree["roman"]["meta"]["wcs"])
            else:
                hdus = fits_read(self.infile)
                # WCS from whichever HDU carries it (primary or SCI)
                hdr = None
                for h in hdus:
                    if "CTYPE1" in h.header:
                        hdr = h.header
                        break
                if hdr is None:
                    raise ValueError(f"no WCS found in {self.infile}")
                self.inwcs = WCS.from_header(hdr)
        self._psf_cache = {}

    # ----- geometry ---------------------------------------------------------

    def inpix2world2outpix(self, inxys):
        """(N, 2) input pixels -> output block pixels."""
        ra, dec = self.inwcs.pix2world(inxys[:, 0], inxys[:, 1])
        x, y = self.blk.outwcs.world2pix(ra, dec)
        return np.stack([x, y], axis=-1)

    def outpix2world2inpix(self, outxys):
        """(N, 2) output block pixels -> input pixels."""
        outxys = np.asarray(outxys, dtype=np.float64)
        ra, dec = self.blk.outwcs.pix2world(outxys[:, 0], outxys[:, 1])
        x, y = self.inwcs.world2pix(ra, dec)
        return np.stack([x, y], axis=-1)

    # ----- pixel partition --------------------------------------------------

    def partition_pixels(self, sp_res: int = 90, verbose=False):
        """
        Partition this exposure's pixels into input postage stamps.

        Vectorized version of the reference's sparse-grid search
        (coadd.py:174-380): a coarse grid finds the relevant region, then all
        pixels of relevant cells are transformed in one vectorized call.
        """
        cfg = self.blk.cfg
        n2 = cfg.n2
        pix_lower = -n2 - 0.5
        pix_upper = cfg.NsideP + n2 - 0.5

        sp_arr = np.linspace(0, Stn.sca_nside, sp_res + 1).astype(np.int64)
        gx, gy = np.meshgrid(sp_arr, sp_arr)
        sp_out = self.inpix2world2outpix(
            np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float64))
        ox = sp_out[:, 0].reshape(sp_res + 1, sp_res + 1)
        oy = sp_out[:, 1].reshape(sp_res + 1, sp_res + 1)

        # interior grid nodes in range whose stamp neighborhood is used
        self.is_relevant = False
        relevant = np.zeros((sp_res, sp_res), dtype=bool)
        inr = ((ox > pix_lower) & (ox < pix_upper) & (oy > pix_lower) & (oy < pix_upper))
        n1P2 = cfg.n1P + 2
        for j in range(1, sp_res):
            for i in range(1, sp_res):
                if not inr[j, i]:
                    continue
                i_st = int((ox[j, i] - pix_lower) // n2)
                j_st = int((oy[j, i] - pix_lower) // n2)
                if np.any(self.blk.use_instamps[max(j_st - 2, 0):min(j_st + 3, n1P2),
                                                max(i_st - 2, 0):min(i_st + 3, n1P2)]):
                    self.is_relevant = True
                    relevant[max(j - 2, 0):min(j + 3, sp_res),
                             max(i - 2, 0):min(i + 3, sp_res)] = True
        if not self.is_relevant:
            return
        print("input image", self.idsca, flush=True)

        # masks
        if self.blk.pmask is not None:
            mask = self.blk.pmask[self.idsca[1] - 1].copy()
        else:
            mask = np.ones((Stn.sca_nside, Stn.sca_nside), dtype=bool)

        get_all_data(self)  # fills self.indata

        cr = Mask.load_cr_mask(self)
        if cr is not None:
            mask &= cr
        mask &= Mask.load_mask_from_maskfile(self.blk.cfg, self.blk.obsdata, self.idsca)

        # gather pixels of relevant cells and transform them all at once
        pixmask = np.zeros((Stn.sca_nside, Stn.sca_nside), dtype=bool)
        for j, i in zip(*np.nonzero(relevant)):
            pixmask[sp_arr[j]:sp_arr[j + 1], sp_arr[i]:sp_arr[i + 1]] = True
        pixmask &= mask
        yy, xx = np.nonzero(pixmask)
        out = self.inpix2world2outpix(np.stack([xx, yy], axis=-1).astype(np.float64))
        keep = ((out[:, 0] > pix_lower) & (out[:, 0] < pix_upper)
                & (out[:, 1] > pix_lower) & (out[:, 1] < pix_upper))
        xx, yy, out = xx[keep], yy[keep], out[keep]

        i_st = ((out[:, 0] - pix_lower) // n2).astype(np.int64)
        j_st = ((out[:, 1] - pix_lower) // n2).astype(np.int64)
        used = self.blk.use_instamps[j_st, i_st]
        xx, yy, out, i_st, j_st = xx[used], yy[used], out[used], i_st[used], j_st[used]

        # group by stamp
        order = np.lexsort((xx, yy, i_st, j_st))
        xx, yy, out, i_st, j_st = xx[order], yy[order], out[order], i_st[order], j_st[order]
        key = j_st * n1P2 + i_st
        self.stamp_pix = {}
        starts = np.concatenate([[0], np.nonzero(np.diff(key))[0] + 1, [len(key)]])
        for s0, s1 in zip(starts[:-1], starts[1:]):
            if s1 <= s0:
                continue
            self.stamp_pix[(int(j_st[s0]), int(i_st[s0]))] = dict(
                x_idx=xx[s0:s1], y_idx=yy[s0:s1],
                x_val=out[s0:s1, 0], y_val=out[s0:s1, 1])
        npix_tot = len(key)
        if verbose:
            print("-->", npix_tot, "pixels selected from idsca", self.idsca)

    def extract_layers(self):
        """Attach per-stamp layer data; free the full-frame cube."""
        for ji, rec in self.stamp_pix.items():
            rec["data"] = self.indata[:, rec["y_idx"], rec["x_idx"]].astype(np.float32)
            del rec["x_idx"], rec["y_idx"]
        del self.indata

    # ----- PSF access -------------------------------------------------------

    @staticmethod
    def psf_filename(inpsf_format, obsid):
        """PSF file name broker (reference coadd.py:512-538)."""
        if inpsf_format == "dc2_imsim":
            return f"dc2_psf_{obsid:d}.fits"
        if inpsf_format in ["anlsim", "L2_2506", "L2_fits"]:
            return f"psf_polyfit_{obsid:d}.fits"
        if inpsf_format[:4].lower() == "piff":
            s = (inpsf_format[5:] if len(inpsf_format) > 4
                 and inpsf_format[4] == ":" else "ffov")
            return f"{s}_{obsid:d}.piff"
        raise ValueError(f"unknown PSF format {inpsf_format!r}")

    def get_psf_pos(self, psf_compute_point, use_shortrange=False, use_drawpsf=False):
        """
        Input PSF at an (ra, dec) position: Legendre-cube evaluation plus
        pixel-tophat smearing (reference InImage.get_psf_pos, coadd.py:540-653).
        """
        cfg = self.blk.cfg
        tophat = cfg.inpsf_oversamp
        if use_shortrange and cfg.psfsplit:
            tophat = 0

        pixloc = self.inwcs.world2pix(psf_compute_point[0], psf_compute_point[1])

        use_drawpsf = use_drawpsf and (cfg.inpsfdraw_format is not None)
        iformat = cfg.inpsfdraw_format if use_drawpsf else cfg.inpsf_format
        ipath = cfg.inpsfdraw_path if use_drawpsf else cfg.inpsf_path

        if (iformat[:4].lower() == "piff"
                and not (use_shortrange and cfg.psfsplit)):
            # Piff solution drawn at the chip position (reference
            # coadd.py:643-648; stamp_size=48, flux per sample, pixel
            # response already included by the Piff fit -- no tophat smear)
            key = (iformat, "piffmodel")
            if key not in self._psf_cache:
                from .utils.piffutils import PiffPSFModel

                fname = ipath + "/" + InImage.psf_filename(iformat, self.idsca[0])
                if not exists(fname):
                    raise FileNotFoundError(f"input PSF file missing: {fname}")
                self._psf_cache[key] = PiffPSFModel(fname, self.idsca[1])
            return self._psf_cache[key].draw(float(pixloc[0]), float(pixloc[1]),
                                             stamp_size=48,
                                             oversamp=cfg.inpsf_oversamp)

        key = (iformat, use_shortrange)
        if key not in self._psf_cache:
            fname = ipath + "/" + InImage.psf_filename(iformat, self.idsca[0])
            if use_shortrange and cfg.psfsplit:
                fname = cfg.inlayercache + f".psf/psf_{self.idsca[0]:d}.fits"
            if not exists(fname):
                raise FileNotFoundError(f"input PSF file missing: {fname}")
            hdus = fits_read(fname)
            sskip = 0
            if use_shortrange and cfg.psfsplit:
                sskip = int(hdus[0].header["GSSKIP"])
            self._psf_cache[key] = np.asarray(hdus[self.idsca[1] + sskip].data,
                                              dtype=np.float64)
        cube = self._psf_cache[key]

        if iformat == "dc2_imsim":
            return psfmodels.smooth_and_pad(cube if cube.ndim == 2 else cube[0],
                                            tophatwidth=tophat)
        # Legendre polynomial cube formats
        psf = psfmodels.eval_psf_cube(cube, float(pixloc[0]), float(pixloc[1]),
                                      nside=Stn.sca_nside)
        out = psfmodels.smooth_and_pad(psf, tophatwidth=tophat)
        if iformat == "anlsim":
            out = out / 64.0  # anlsim cubes are per s_in^2, not per sample^2
        return out

    def get_psf_pos_batch(self, points, use_drawpsf=False):
        """
        Input PSFs at many (ra, dec) positions at once: vectorized Legendre
        evaluation + batched FFT smearing.  Returns (S, ny, nx).
        """
        cfg = self.blk.cfg
        use_drawpsf = use_drawpsf and (cfg.inpsfdraw_format is not None)
        iformat = cfg.inpsfdraw_format if use_drawpsf else cfg.inpsf_format
        points = np.asarray(points, dtype=np.float64)

        if iformat == "dc2_imsim":
            one = self.get_psf_pos(points[0], use_drawpsf=use_drawpsf)
            return np.broadcast_to(one, (len(points),) + one.shape)
        if iformat[:4].lower() == "piff":
            return np.stack([self.get_psf_pos(p, use_drawpsf=use_drawpsf)
                             for p in points])

        # trigger the cube load through the scalar path
        self.get_psf_pos(points[0], use_drawpsf=use_drawpsf)
        cube = self._psf_cache[(iformat, False)]
        px, py = self.inwcs.world2pix(points[:, 0], points[:, 1])
        psfs = psfmodels.eval_psf_cube_batch(cube, px, py, nside=Stn.sca_nside)
        out = psfmodels.smooth_and_pad_batch(psfs, tophatwidth=cfg.inpsf_oversamp)
        if iformat == "anlsim":
            out = out / 64.0
        return out

    def clear(self):
        if hasattr(self, "stamp_pix"):
            del self.stamp_pix
        self._psf_cache.clear()


class InStamp:
    """Concatenated input pixels of one postage stamp across exposures."""

    def __init__(self, blk: "Block", j_st: int, i_st: int):
        self.blk = blk
        self.j_st = j_st
        self.i_st = i_st

        xs, ys, datas, imgs = [], [], [], []
        counts = []
        for i_im, inimage in enumerate(blk.inimages):
            rec = getattr(inimage, "stamp_pix", {}).get((j_st, i_st))
            if rec is None:
                counts.append(0)
                continue
            counts.append(len(rec["x_val"]))
            xs.append(rec["x_val"])
            ys.append(rec["y_val"])
            datas.append(rec["data"])
            imgs.append(np.full(len(rec["x_val"]), i_im, dtype=np.int32))
        self.pix_count = np.array(counts, dtype=np.int64)
        self.pix_cumsum = np.concatenate([[0], np.cumsum(self.pix_count)])
        if xs:
            self.x_val = np.concatenate(xs)
            self.y_val = np.concatenate(ys)
            self.data = np.concatenate(datas, axis=1)
            self.img_idx = np.concatenate(imgs)
        else:
            self.x_val = np.zeros(0)
            self.y_val = np.zeros(0)
            self.data = np.zeros((blk.cfg.n_inframe, 0), dtype=np.float32)
            self.img_idx = np.zeros(0, dtype=np.int32)

    @property
    def n_pix(self):
        return len(self.x_val)

    def make_selection(self, pivot=(None, None), radius=None):
        """Indices of pixels within `radius` of the pivot line/point, or None
        for all (reference InStamp.make_selection, coadd.py:716-749)."""
        if pivot == (None, None) or radius is None:
            return None
        dist_sq = np.zeros(self.n_pix)
        if pivot[0] is not None:
            dist_sq += np.square(self.x_val - pivot[0])
        if pivot[1] is not None:
            dist_sq += np.square(self.y_val - pivot[1])
        sel = np.nonzero(dist_sq < radius ** 2)[0].astype(np.int64)
        return sel if len(sel) < self.n_pix else None

    def clear(self):
        self.x_val = self.y_val = self.data = self.img_idx = None


def group_of(ji_st):
    """Stamp (j, i) -> its 2x2 PSF group anchor (even coordinates)."""
    return (ji_st[0] & ~1, ji_st[1] & ~1)


class Block:
    """
    Coadd one block of the mosaic.

    Parameters
    ----------
    cfg : Config
    this_sub : int -- block index (ibx * nblock + iby).
    run_coadd : bool -- run the full pipeline on construction.
    """

    def __init__(self, cfg: Config = None, this_sub: int = 0, run_coadd: bool = True):
        self.timer = Timer()
        if cfg is None:
            cfg = Config()
        cfg()
        self.cfg = cfg
        self.geom = PSFGeometry(npixpsf=cfg.npixpsf, oversamp=cfg.inpsf_oversamp,
                                dtheta=cfg.dtheta, psfsplit=bool(cfg.psfsplit),
                                psfinterp=getattr(cfg, "psf_interp", "D5512"))
        self.this_sub = this_sub
        if run_coadd:
            self()

    def __call__(self):
        self.parse_config()
        self.process_input_images()
        self.build_input_stamps()
        self.coadd_output_stamps(sim_mode=True)
        self.coadd_output_stamps(sim_mode=False)
        stats = getattr(self, "_round_stats", None)
        if stats is not None:
            # final mesh round's collective-reduced quality summary (device
            # scalars; converting here, after the drains, costs no stall)
            print(f"mesh round quality: sqrt(U/C)_max = "
                  f"{float(stats['uc_max']) ** 0.5:.3E}, Sigma_max = "
                  f"{float(stats['sigma_max']):.3E}", flush=True)
        self.build_output_file(is_final=True)
        p = self._ckpt_file()
        if p and os.path.exists(p):
            os.remove(p)   # the finished block supersedes the snapshot
        _profile_report(f"block {self.this_sub}")
        print(f"finished at t = {self.timer():.2f} s", flush=True)

    # ----- configuration and geometry --------------------------------------

    def parse_config(self):
        cfg = self.cfg
        print("number of input frames =", cfg.n_inframe, "type =", cfg.extrainput)

        hdus = fits_read(cfg.obsfile)
        obs = hdus[1]
        fdata = obs["filter"]
        if fdata.dtype.kind in "US":
            conv = np.zeros(len(fdata), dtype=np.uint16)
            for j, s in enumerate(Stn.RomanFilters):
                conv[np.asarray(fdata) == s] = j
            obs.data["filter"] = conv
        self.obsdata = obs.data  # dict of columns

        ibx, iby = divmod(self.this_sub, cfg.nblock)
        self.ibx, self.iby = ibx, iby
        self.outstem = cfg.outstem + f"_{ibx:02d}_{iby:02d}"
        print(f"sub-block {self.this_sub:4d} <{ibx:2d},{iby:2d}> of "
              f"{cfg.nblock}x{cfg.nblock}; outputs -> {self.outstem}", flush=True)

        self.outwcs = make_block_wcs(cfg, ibx, iby)
        ctr = (cfg.NsideP - 1) / 2.0
        ra, dec = self.outwcs.pix2world(np.array([ctr]), np.array([ctr]))
        self.centerpos = np.array([ra[0], dec[0]])

        # target output PSFs, sampled and FFT'd
        geom = self.geom
        n_out = cfg.n_out
        psfs = np.zeros((n_out, geom.nsamp + 1, geom.nsamp + 1))
        psfs[0] = self._get_outpsf(cfg.outpsf, cfg.sigmatarget)
        for j in range(1, n_out):
            psfs[j] = self._get_outpsf(cfg.outpsf_extra[j - 1], cfg.sigmatarget_extra[j - 1])
        sampled = sample_psf_unrotated(geom, psfs)
        self.outpsfgrp = PSFGroup(geom, sampled, psf_circ=cfg.psf_circ,
                                  psf_norm=cfg.psf_norm, amp_penalty=cfg.amp_penalty)
        self.outovlc = outpsf_C_values(geom, self.outpsfgrp)
        print("computed overlap, C=", self.outovlc, flush=True)

    def _get_outpsf(self, outpsf: str, extrasmooth: float):
        """Target PSF image (reference PSFGrp._get_outpsf, psfutil.py:853-898)."""
        geom = self.geom
        n = geom.nsamp + 1
        ov = geom.oversamp
        if outpsf == "GAUSSIAN":
            return psfmodels.psf_gaussian(n, extrasmooth * ov, extrasmooth * ov)
        if outpsf == "AIRYOBSC":
            return psfmodels.psf_simple_airy(
                n, Stn.QFilterNative[self.cfg.use_filter] * ov, obsc=Stn.obsc,
                sigma=extrasmooth * ov)
        if outpsf == "AIRYUNOBSC":
            return psfmodels.psf_simple_airy(
                n, Stn.QFilterNative[self.cfg.use_filter] * ov, obsc=0.0,
                sigma=extrasmooth * ov)
        raise ValueError(f"unsupported target output PSF type {outpsf!r}")

    def _get_obs_cover(self, radius):
        """Observations whose SCA field of view may intersect this block
        (spherical rotation search; reference coadd.py:1729-1787)."""
        obs = self.obsdata
        n_obs = len(obs["ra"])
        cp = self.centerpos
        x1 = np.cos(cp[1] * Stn.degree) * np.cos((cp[0] - obs["ra"]) * Stn.degree)
        y1 = np.cos(cp[1] * Stn.degree) * np.sin((cp[0] - obs["ra"]) * Stn.degree)
        z1 = np.sin(cp[1] * Stn.degree) * np.ones(n_obs)
        x2 = np.sin(obs["dec"] * Stn.degree) * x1 - np.cos(obs["dec"] * Stn.degree) * z1
        y2 = y1
        z2 = np.cos(obs["dec"] * Stn.degree) * x1 + np.sin(obs["dec"] * Stn.degree) * z1
        X = (-np.sin(obs["pa"] * Stn.degree) * x2 - np.cos(obs["pa"] * Stn.degree) * y2) / Stn.degree
        Y = (-np.cos(obs["pa"] * Stn.degree) * x2 + np.sin(obs["pa"] * Stn.degree) * y2) / Stn.degree
        X = np.where(z2 > 0, X, 1e49)

        self.obslist = []
        for isca in range(18):
            good = np.nonzero(
                (np.hypot(X - Stn.SCAFov[isca][0], Y - Stn.SCAFov[isca][1]) < radius)
                & (obs["filter"] == self.cfg.use_filter))[0]
            for k in good:
                self.obslist.append((int(k), isca + 1))
        self.obslist.sort()

    def _handle_postage_pad(self):
        cfg = self.cfg
        pad = cfg.postage_pad
        self.j_st_min = self.i_st_min = pad + 1
        self.j_st_max = self.i_st_max = self.j_st_min + cfg.n1 - 1
        self.pad_sides = ""
        if cfg.pad_sides == "all":
            self.pad_sides = "BTLR"
        elif cfg.pad_sides == "auto":
            ibx, iby = self.ibx, self.iby
            if iby == 0:
                self.pad_sides += "B"
            elif iby == cfg.nblock - 1:
                self.pad_sides += "T"
            if ibx == 0:
                self.pad_sides += "L"
            elif ibx == cfg.nblock - 1:
                self.pad_sides += "R"
        elif cfg.pad_sides != "none":
            self.pad_sides = cfg.pad_sides

        if "B" in self.pad_sides:
            self.j_st_min -= pad
        if "T" in self.pad_sides:
            self.j_st_max += pad
        if "L" in self.pad_sides:
            self.i_st_min -= pad
        if "R" in self.pad_sides:
            self.i_st_max += pad

        self.nrun = (self.j_st_max - self.j_st_min + 1) * (self.i_st_max - self.i_st_min + 1)
        if cfg.stoptile:
            self.nrun = cfg.stoptile

        # mark which input stamps are needed
        n1P2 = cfg.n1P + 2
        self.use_instamps = np.zeros((n1P2, n1P2), dtype=bool)
        n_c = 0
        for j_st in range(self.j_st_min, self.j_st_max + 1, 2):
            for i_st in range(self.i_st_min, self.i_st_max + 1, 2):
                for dj, di in product(range(2), range(2)):
                    self.use_instamps[j_st + dj - 1:j_st + dj + 2,
                                      i_st + di - 1:i_st + di + 2] = True
                    n_c += 1
                    if n_c == self.nrun:
                        return

    # ----- inputs -----------------------------------------------------------

    def process_input_images(self):
        cfg = self.cfg
        search_radius = (Stn.sca_sidelength / np.sqrt(2.0) / Stn.degree
                         + cfg.NsideP * cfg.dtheta / np.sqrt(2.0))
        self._get_obs_cover(search_radius)
        print(len(self.obslist), f"observations within range ({search_radius:7.5f} deg)",
              "filter =", cfg.use_filter, flush=True)

        self.inimages = [InImage(self, idsca) for idsca in self.obslist]
        if not any(im.exists_ for im in self.inimages):
            raise RuntimeError("No candidate observations found to stack.")

        self.pmask = Mask.load_permanent_mask(self)
        self._handle_postage_pad()
        for inimage in self.inimages:
            if not inimage.exists_:
                inimage.is_relevant = False
                continue
            inimage.partition_pixels(verbose=True)
            if inimage.is_relevant:
                inimage.extract_layers()
        del self.pmask

        keep = [i for i, im in enumerate(self.inimages) if im.is_relevant]
        self.obslist = [self.obslist[i] for i in keep]
        self.inimages = [self.inimages[i] for i in keep]
        self.n_inimage = len(self.inimages)
        print("n_inimage =", self.n_inimage, "@", f"{self.timer():.2f} s", flush=True)

    def build_input_stamps(self):
        n1P2 = self.cfg.n1P + 2
        self.instamps = {}
        for j_st in range(n1P2):
            for i_st in range(n1P2):
                if self.use_instamps[j_st, i_st]:
                    self.instamps[(j_st, i_st)] = InStamp(self, j_st, i_st)
        for inimage in self.inimages:
            inimage.clear()

    # ----- PSF group and overlap caching ------------------------------------

    def _group_images(self, ji_grp):
        """Block image indices participating in a 2x2 stamp group."""
        use = np.zeros(self.n_inimage, dtype=bool)
        for dj, di in product(range(2), range(2)):
            st = self.instamps.get((ji_grp[0] + dj, ji_grp[1] + di))
            if st is not None:
                use |= st.pix_count > 0
        return np.nonzero(use)[0]

    @staticmethod
    def _devid(device):
        return getattr(device, "id", -1) if device is not None else -1

    def _get_psf_group(self, ji_grp, device=None):
        """Input PSF group for a 2x2 stamp group (cached, refcounted).

        With `device` set, the group's PSFs are resampled and their DFT
        spectra built ON that device (band sharding: each band's device
        owns its groups end to end; nothing is replicated device-to-device).
        """
        sub = self._grp_cache.setdefault(ji_grp, {})
        devid = self._devid(device)
        if devid in sub:
            return sub[devid]
        cfg = self.cfg
        imgs = self._group_images(ji_grp)
        n_psf = len(imgs)
        blk2grp = np.full(self.n_inimage, 255, dtype=np.int64)
        for g, b in enumerate(imgs):
            blk2grp[b] = g
        compute_point_pix = [ji_grp[1] * cfg.n2 - 0.5, ji_grp[0] * cfg.n2 - 0.5]
        world = self.outwcs.all_pix2world(np.array([compute_point_pix]), 0)[0]
        with _phase("psf.sample_group"):
            psfs, mapfns = [], []
            for b in imgs:
                inimage = self.inimages[b]
                psfs.append(np.asarray(inimage.get_psf_pos(world,
                                                           use_shortrange=True)))
                mapfns.append(inimage.outpix2world2inpix)
            if (n_psf > 0 and _psfgrp._use_dense()
                    and len({p.shape for p in psfs}) == 1):
                # one dense call resamples the whole group; in device overlap
                # mode the samples stay in HBM and feed the DFT spectra
                psf_arr = sample_psf_rotated_batch(
                    self.geom, psfs, mapfns, compute_point_pix,
                    as_device=_psfgrp._overlap_mode() == "device",
                    device=device)
            else:
                psf_arr = np.zeros((n_psf, self.geom.nsamp, self.geom.nsamp))
                for g in range(n_psf):
                    psf_arr[g] = sample_psf_rotated(self.geom, psfs[g],
                                                    mapfns[g],
                                                    compute_point_pix)
        grp = PSFGroup(self.geom, psf_arr, idx_blk2grp=blk2grp, idx_grp2blk=imgs,
                       psf_circ=cfg.psf_circ, psf_norm=cfg.psf_norm,
                       amp_penalty=cfg.amp_penalty, device=device)
        sub[devid] = grp
        return grp

    def _release_group(self, ji_grp):
        self._grp_ref[ji_grp] -= 1
        if self._grp_ref[ji_grp] <= 0:
            sub = self._grp_cache.pop(ji_grp, None)
            for grp in (sub or {}).values():
                grp.clear()

    def _get_ii_overlap(self, gp1, gp2, device=None):
        """Overlap stack between two input PSF groups (cached, refcounted,
        built on `device` under band sharding)."""
        key = (gp1, gp2)
        sub = self._ovl_cache.setdefault(key, {})
        devid = self._devid(device)
        if devid not in sub:
            grp1 = self._get_psf_group(gp1, device)
            grp2 = self._get_psf_group(gp2, device) if gp2 != gp1 else None
            stack = build_overlap_stack(self.geom, grp1, grp2, device=device)
            sub[devid] = (stack, grp1,
                          grp2 if grp2 is not None else grp1)
        return sub[devid]

    def _release_ii_overlap(self, gp1, gp2):
        key = (gp1, gp2)
        self._ovl_ref[key] -= 1
        if self._ovl_ref[key] <= 0:
            self._ovl_cache.pop(key, None)
            self._release_group(gp1)
            if gp2 != gp1:
                self._release_group(gp2)

    def _get_io_overlap(self, gp, device=None):
        """Overlap stack between an input PSF group and the target PSFs."""
        sub = self._io_cache.setdefault(gp, {})
        devid = self._devid(device)
        if devid not in sub:
            grp = self._get_psf_group(gp, device)
            stack = build_overlap_stack(self.geom, grp, self.outpsfgrp,
                                        device=device)
            sub[devid] = (stack, grp)
        return sub[devid]

    def _release_io_overlap(self, gp):
        self._io_ref[gp] -= 1
        if self._io_ref[gp] <= 0:
            self._io_cache.pop(gp, None)
            self._release_group(gp)

    def _drop_iisubmat_ref(self, ji1, ji2):
        """Consume one reference to a submatrix without computing it (used
        when an output stamp turns out to have no input pixels)."""
        key = (ji1, ji2)
        self._submat_ref[key] -= 1
        if self._submat_ref[key] <= 0:
            if key in self._submat_cache:
                del self._submat_cache[key]
            elif key in self._dev_submat:
                del self._dev_submat[key]
            elif key not in self._submat_computed:
                # the computation the sim pass budgeted never happens;
                # release its overlap-stack reference
                gp1, gp2 = group_of(ji1), group_of(ji2)
                okey = (gp1, gp2) if gp1 <= gp2 else (gp2, gp1)
                self._release_ii_overlap(*okey)

    def _get_iisubmat(self, ji1, ji2):
        """A submatrix for a (sorted) stamp pair (cached, refcounted)."""
        key = (ji1, ji2)
        if key not in self._submat_cache and key not in self._submat_computed:
            gp1, gp2 = group_of(ji1), group_of(ji2)
            swap = False
            okey = (gp1, gp2) if gp1 <= gp2 else (gp2, gp1)
            if gp1 > gp2:
                swap = True
            stack, grpa, grpb = self._get_ii_overlap(*okey)
            st1, st2 = self.instamps[ji1], self.instamps[ji2]
            same_grp = gp1 == gp2
            if same_grp:
                n_in_eff = grpa.n_psf
            else:
                n_in_eff = np.sqrt(grpa.n_psf * grpb.n_psf)
            if not swap:
                sub = interp_submatrix(
                    self.geom, stack, st1.x_val, st1.y_val, st1.img_idx,
                    st2.x_val, st2.y_val, st2.img_idx,
                    grpa.idx_blk2grp, grpb.idx_blk2grp, grpb.n_psf,
                    self.cfg.flat_penalty, n_in_eff)
            else:
                # overlap stack is (grp2, grp1): evaluate transposed block
                sub = interp_submatrix(
                    self.geom, stack, st2.x_val, st2.y_val, st2.img_idx,
                    st1.x_val, st1.y_val, st1.img_idx,
                    grpa.idx_blk2grp, grpb.idx_blk2grp, grpb.n_psf,
                    self.cfg.flat_penalty, n_in_eff).T
            self._submat_cache[key] = sub
            self._submat_computed.add(key)
            self._release_ii_overlap(*okey)
        sub = self._submat_cache[key]
        self._submat_ref[key] -= 1
        if self._submat_ref[key] <= 0:
            del self._submat_cache[key]
        return sub

    def _precompute_stamp_mats(self, ji_in_s, xs, ys, imgs, out_x, out_y):
        """
        Fuse the dense-path interpolation work of one output stamp -- every
        ii-submatrix not already cached plus the nine io-submatrices -- into
        a single `_interp_rects_dense` sweep.

        The per-submatrix path issues one dispatch chain per submatrix
        (~60 per stamp).  One fused sweep packs the same rectangles into
        the same few bucketed shapes with ~10x fewer device dispatches.  Cache/refcount semantics match `_get_iisubmat`
        exactly: computed submatrices land in `_submat_cache`, join
        `_submat_computed`, and release their overlap-stack reference.

        Returns the list of nine (n_out, m, n_i) io-submatrices.
        """
        cfg = self.cfg
        keys = [(ji, ji) for ji in ji_in_s]
        keys += [(a, b) if a <= b else (b, a)
                 for a, b in combinations(ji_in_s, 2)]

        # coordinate tables for the sweep: the full pixel arrays of the nine
        # input stamps (ii-submatrices), the selected pixel arrays
        # (io-submatrices), and the output grid -- a few tens of KB uploaded
        # once, instead of raveled O(n^2) query grids
        parts_x, parts_y = [], []
        cur = 0
        base_full = {}
        for ji in ji_in_s:
            st = self.instamps[ji]
            base_full[ji] = cur
            parts_x.append(st.x_val)
            parts_y.append(st.y_val)
            cur += len(st.x_val)
        base_sel = []
        for idx in range(len(ji_in_s)):
            base_sel.append(cur)
            parts_x.append(xs[idx])
            parts_y.append(ys[idx])
            cur += len(xs[idx])
        base_out = cur
        parts_x.append(out_x)
        parts_y.append(out_y)
        xt = np.concatenate(parts_x)
        yt = np.concatenate(parts_y)

        rects = []
        ii_jobs = []   # (key, swap, okey, finalize, offset, n_rects)
        _plan_t = _phase("stamp.plan")
        _plan_t.__enter__()
        for key in keys:
            if key in self._submat_cache or key in self._submat_computed:
                continue
            ji1, ji2 = key
            gp1, gp2 = group_of(ji1), group_of(ji2)
            swap = gp1 > gp2
            okey = (gp1, gp2) if not swap else (gp2, gp1)
            stack, grpa, grpb = self._get_ii_overlap(*okey)
            if gp1 == gp2:
                n_in_eff = grpa.n_psf
            else:
                n_in_eff = np.sqrt(grpa.n_psf * grpb.n_psf)
            if swap:
                ji1, ji2 = ji2, ji1  # overlap stack is (grp2, grp1)
            st1, st2 = self.instamps[ji1], self.instamps[ji2]
            r, fin = submatrix_rect_plan(
                self.geom, stack, st1.img_idx, st2.img_idx,
                grpa.idx_blk2grp, grpb.idx_blk2grp, grpb.n_psf,
                cfg.flat_penalty, n_in_eff, base_full[ji1], base_full[ji2])
            ii_jobs.append((key, swap, okey, fin, len(rects), len(r)))
            rects += r

        io_jobs = []   # (finalize, offset, n_rects)
        m = len(out_x)
        for idx, ji in enumerate(ji_in_s):
            stack, grp = self._get_io_overlap(group_of(ji))
            r, fin = io_submatrix_rect_plan(
                self.geom, stack, imgs[idx], grp.idx_blk2grp, cfg.n_out,
                base_sel[idx], base_out, m)
            io_jobs.append((fin, len(rects), len(r)))
            rects += r
        _plan_t.__exit__(None, None, None)

        off_grid = self.geom.nc_ovl + _psfgrp.INTERP_PAD
        vals = _interp_rects_dense(rects, xt, yt, 1.0 / self.geom.dscale,
                                   off_grid, self.geom.psfinterp)

        with _phase("stamp.finalize"):
            for key, swap, okey, fin, off, nr in ii_jobs:
                sub = fin(vals[off:off + nr])
                if swap:
                    sub = sub.T
                self._submat_cache[key] = sub
                self._submat_computed.add(key)
                self._release_ii_overlap(*okey)
            return [fin(vals[off:off + nr]) for fin, off, nr in io_jobs]

    # ----- device-resident group engine --------------------------------------

    def _device_path_enabled(self):
        """
        Whether the device-resident group path runs (accelerators, Cholesky).

        The host path downloads every sweep value and re-uploads the
        assembled A (~40 MB/stamp); the device path keeps everything in HBM
        (ops/assemble.py).  Env override PYIMCOM_DEVICE_ASSEMBLY=0 forces the
        host path, =1 forces the device path (used to exercise it on CPU in
        tests).
        """
        env = os.environ.get("PYIMCOM_DEVICE_ASSEMBLY", "auto")
        if env == "0":
            return False
        if self.cfg.linear_algebra not in ("Cholesky", "Iterative", "Eigen"):
            return False
        if self.cfg.linear_algebra == "Iterative" and self.cfg.no_qlt_ctrl:
            return False
        if env == "1":
            return True
        return _psfgrp._use_dense()

    def _fade_vec(self):
        """(m,) trapezoid fade factors over the output stamp grid."""
        n2f = self.cfg.n2f
        ones = np.ones((n2f, n2f))
        trapezoid(ones, self.cfg.fade_kernel)
        return ones.ravel()

    def _solver_name(self):
        import jax

        if self.cfg.linear_algebra == "Iterative":
            return "iterative"
        if self.cfg.linear_algebra == "Eigen":
            # device Eigen contract: dense-kappa-grid emulation of the
            # bisection (solvers.eigen_solve_device); node count via env
            return "eigen" + os.environ.get("PYIMCOM_EIGEN_NODES", "9")
        prec = getattr(self.cfg, "solver_prec", "auto")
        if prec == "mixed":
            return "mixed"
        if jax.default_backend() != "cpu":
            # Auto solver on accelerators: f32 factorization + two f64
            # residual refinements when the kappa floor keeps
            # cond(A+kappa*C)*eps_f32 << 1; tiny kappa nodes use the blocked
            # f64 factorization.  SOLVERPREC: f64 forces blocked.  Kept
            # pending H100 measurement (ROADMAP): chip_smoke.py times the
            # mixed, blocked and monolithic f64 solvers side by side.
            if (prec != "f64"
                    and min(self.cfg.kappaC_arr) >= float(os.environ.get(
                        "PYIMCOM_MIXED_KAPPA_MIN", "1e-4"))):
                return "mixed"
            return "blocked"
        return "monolithic"

    CHUNK = 16384       # scatter chunk length (static bucket)

    @property
    def _rungs(self) -> _ShapeRungs:
        r = getattr(self, "_shape_rungs", None)
        if r is None:
            r = self._shape_rungs = _ShapeRungs()
        return r

    def _stamp_devices(self):
        """Devices over which postage-stamp groups are scattered."""
        import jax

        devs = list(jax.local_devices())
        env = os.environ.get("PYIMCOM_NDEVICES")
        if env:
            devs = devs[:max(1, int(env))]
        return devs

    def _group_infos(self, group):
        """Per-stamp input selections of one 2x2 group.

        Returns (infos, zeros): zero-input stamps release their sim-pass
        cache references here (bookkeeping must follow plan order) but
        their map contributions are deferred to drain time via `zeros`, so
        the accumulated maps always correspond exactly to the drained
        prefix of groups (checkpoint consistency under pipelining)."""
        infos, zeros = [], []
        for (j_st, i_st) in group:
            print(f"postage stamp {i_st:2d},{j_st:2d}  t= {self.timer():9.2f} s",
                  flush=True)
            info = self._stamp_inputs(j_st, i_st)
            if info["n"] == 0:
                self._zero_stamp_refs(info["ji_in_s"])
                zeros.append((j_st, i_st))
            else:
                infos.append((j_st, i_st, info))
        return infos, zeros

    def _coadd_group_device(self, group, device=None, infos=None,
                            n_pad=None, defer_solve=False):
        """
        Coadd up to four output stamps of one 2x2 PSF group with the fully
        device-resident pipeline:

        1. ONE fused interpolation sweep computes every fresh system
           submatrix (full-stamp pixels, shared across output stamps exactly
           as the reference SysMatA cache, psfutil.py:1764-2085) and all
           io rectangles -- values never return to the host;
        2. sweep batches scatter into a per-group submatrix pool
           (ops/assemble.scatter_pool) and the per-stamp -B/2 tensors
           (scatter_B);
        3. per stamp, pooled submatrices (this group's and cached earlier
           groups') scatter-add into the padded A with selection maps
           (pool_to_A/_sym);
        4. per stamp, solve + trapezoid fade + coaddition run on device
           (solve_finalize) and only KB-scale maps download.

        All dispatches are asynchronous; the host never blocks until the
        final small downloads, so the four solves pipeline behind the sweep.

        With `device` set, every buffer and computation of this group is
        placed on that device: the block loop enqueues one group per local
        device per round, so groups execute concurrently across the chips
        (stamp-level data parallelism; SURVEY.md section 2.2).
        Returns the per-stamp result records; the caller drains them with
        `_drain_group_results` after the round.

        `infos` / `n_pad` may be precomputed by the caller (the banded
        multi-device round loop shares one n_pad across a mini-round so the
        solves can batch over the mesh); `defer_solve=True` returns the
        assembled (A, B, data, ...) instead of solving, for the shard_map
        mesh solve (`_solve_round`).
        """
        import jax
        import jax.numpy as jnp

        from .ops import assemble

        cfg = self.cfg
        geom = self.geom
        n_out, n2f, n2 = cfg.n_out, cfg.n2f, cfg.n2
        m = n2f * n2f
        dt = _psfgrp.compute_dtype()
        kern = geom.psfinterp
        CH = self.CHUNK

        if infos is None:
            infos, zeros = self._group_infos(group)
        else:
            zeros = []
        if not infos:
            return [(infos, None, 0, zeros)] if zeros else []

        if n_pad is None:
            n_pad = self._rungs.fit("n_pad", max(i[2]["n"] for i in infos),
                                    SOLVE_BUCKET)

        # ---- coordinate tables: union full-stamp arrays + per-stamp
        #      selected arrays + per-stamp output grids ----------------------
        _plan = _phase("stamp.plan")
        _plan.__enter__()
        parts_x, parts_y = [], []
        cur = 0
        base_full = {}
        for _j, _i, info in infos:
            for ji in info["ji_in_s"]:
                if ji not in base_full:
                    st = self.instamps[ji]
                    base_full[ji] = cur
                    parts_x.append(st.x_val)
                    parts_y.append(st.y_val)
                    cur += st.n_pix
        base_sel, base_out = [], []
        for _j, _i, info in infos:
            bs = []
            for idx in range(9):
                bs.append(cur)
                parts_x.append(info["xs"][idx])
                parts_y.append(info["ys"][idx])
                cur += len(info["xs"][idx])
            base_sel.append(bs)
            base_out.append(cur)
            parts_x.append(info["out_x"])
            parts_y.append(info["out_y"])
            cur += len(info["out_x"])
        xt = np.concatenate(parts_x)
        yt = np.concatenate(parts_y)

        # ---- fresh-submatrix plan over the union of stamp neighborhoods ----
        keys_union = []
        seen = set()
        for _j, _i, info in infos:
            ji_in_s = info["ji_in_s"]
            ks = [(ji, ji) for ji in ji_in_s]
            ks += [(a, b) if a <= b else (b, a)
                   for a, b in combinations(ji_in_s, 2)]
            for k in ks:
                if k not in seen:
                    seen.add(k)
                    keys_union.append(k)

        # per-rect plan columns (python lists of scalars; vectorized below)
        r_kg, r_i1, r_w1, r_i2, r_w2 = [], [], [], [], []
        r_kind, r_a, r_b = [], [], []    # kind 0: pool (a=dst_base0, b=n2s);
                                         # kind 1: B    (a=dstB_base, b=col0)
        stack_off = {}
        stacks = []
        stot = 0

        def _stack_base(stk):
            nonlocal stot
            if id(stk) not in stack_off:
                stack_off[id(stk)] = stot
                stacks.append(stk)
                stot += stk.shape[0]
            return stack_off[id(stk)]

        pool_size = 0
        fp_rows = []     # flat-penalty constant rects: (meta5 rows, const)
        fresh = {}       # key -> (base, n1sub, n2sub, ji_row, ji_col,
                         #         okey, seam)
        devid = self._devid(device)
        nBflat = n_out * m * n_pad       # per-stamp flat B length
        for key in keys_union:
            sub = self._dev_submat.get(key)
            if sub is not None and devid in sub:
                continue                  # resident on this device
            if key in self._submat_computed and sub is None \
                    and self._submat_ref.get(key, 0) <= 0:
                continue                  # fully consumed earlier
            # key in _submat_computed with refs left = the pool holding it
            # was evicted under the HBM budget (or lives on another device
            # in the banded path): recompute it through the seam machinery
            seam = key in self._submat_computed
            ji1, ji2 = key
            gp1, gp2 = group_of(ji1), group_of(ji2)
            swap = gp1 > gp2
            okey = (gp1, gp2) if not swap else (gp2, gp1)
            if seam:
                # band seam: another device computed this submatrix; its
                # sim-pass overlap reference is spent, so take a temporary
                # one (mirrors _sim_count) and recompute locally -- cheaper
                # than bouncing the pool across devices through the host
                first = self._ovl_ref.get(okey, 0) == 0
                self._ovl_ref[okey] = self._ovl_ref.get(okey, 0) + 1
                if first:
                    self._grp_ref[okey[0]] = self._grp_ref.get(okey[0], 0) + 1
                    if okey[1] != okey[0]:
                        self._grp_ref[okey[1]] = \
                            self._grp_ref.get(okey[1], 0) + 1
            stack, grpa, grpb = self._get_ii_overlap(*okey, device=device)
            sbase = _stack_base(stack)
            if gp1 == gp2:
                n_in_eff = grpa.n_psf
            else:
                n_in_eff = np.sqrt(grpa.n_psf * grpb.n_psf)
            jA, jB = (ji2, ji1) if swap else (ji1, ji2)   # stack order
            st1, st2 = self.instamps[jA], self.instamps[jB]
            n1s, n2s = st1.n_pix, st2.n_pix
            # rung-padded storage dims: the selection-matmul A assembly
            # (ops/assemble.pool_to_A_mm) dynamic-slices (n1r, n2r) tiles,
            # so submatrices are stored with quantized strides; padding
            # stays zero and multiplies to zero in every consumer
            n1r = self._rungs.fit("subdim", n1s, 8)
            n2r = self._rungs.fit("subdim", n2s, 8)
            base = pool_size
            pool_size += n1r * n2r
            fresh[key] = (base, n1s, n2s, n1r, n2r, jA, jB, okey, seam)
            fp = cfg.flat_penalty
            for im1, s1, e1 in _psfgrp._image_runs(st1.img_idx):
                for im2, s2, e2 in _psfgrp._image_runs(st2.img_idx):
                    k = int(grpa.idx_blk2grp[im1]) * grpb.n_psf \
                        + int(grpb.idx_blk2grp[im2])
                    dst_base0 = base + s1 * n2r + s2
                    r_kg.append(sbase + k)
                    r_i1.append(base_full[jA] + s1)
                    r_w1.append(e1 - s1)
                    r_i2.append(base_full[jB] + s2)
                    r_w2.append(e2 - s2)
                    r_kind.append(0)
                    r_a.append(dst_base0)
                    r_b.append(n2r)
                    if fp != 0.0:
                        const = -fp / n_in_eff + fp * (im1 == im2)
                        nq = (e1 - s1) * (e2 - s2)
                        for off in range(0, nq, CH):
                            fp_rows.append(((dst_base0, e2 - s2, n2r, off,
                                             min(CH, nq - off)), const))

        # ---- io rectangles (selected pixels x output grid), per stamp ------
        for s_idx, (_j, _i, info) in enumerate(infos):
            for idx, ji in enumerate(info["ji_in_s"]):
                if info["counts"][idx] == 0:
                    continue
                gp_io = group_of(ji)
                stack, grp = self._get_io_overlap(gp_io, device=device)
                sbase = _stack_base(stack)
                col_base = int(info["cumsum"][idx])
                for im1, s1, e1 in _psfgrp._image_runs(info["imgs"][idx]):
                    for j_out in range(n_out):
                        k = int(grp.idx_blk2grp[im1]) * n_out + j_out
                        r_kg.append(sbase + k)
                        r_i1.append(base_sel[s_idx][idx] + s1)
                        r_w1.append(e1 - s1)
                        r_i2.append(base_out[s_idx])
                        r_w2.append(m)
                        r_kind.append(1)
                        r_a.append(s_idx * nBflat + j_out * m * n_pad)
                        r_b.append(col_base + s1)

        # ---- vectorized piece/batch construction ---------------------------
        # pool length is a compiled-program shape: quantize it onto the
        # sticky rungs so interior groups reuse one program
        pool_alloc = self._rungs.fit("pool", pool_size, 1 << 16)
        # scatter metadata is int32: a destination index >= 2**31 would wrap
        # negative and mode='drop' would silently discard the write
        if max(pool_alloc, n_pad * n_pad, len(infos) * nBflat) >= 2 ** 31:
            raise ValueError(
                f"device-assembly pool too large for int32 scatter indices "
                f"(pool_size={pool_size}, B size={len(infos) * nBflat}); "
                f"reduce group size / INPAD or use the host assembly path")
        r_kg = np.asarray(r_kg, np.int32)
        r_i1 = np.asarray(r_i1, np.int32)
        r_w1 = np.asarray(r_w1, np.int32)
        r_i2 = np.asarray(r_i2, np.int32)
        r_w2 = np.asarray(r_w2, np.int32)
        r_kind = np.asarray(r_kind, np.int32)
        r_a = np.asarray(r_a, np.int32)
        r_b = np.asarray(r_b, np.int32)
        live = (r_w1 > 0) & (r_w2 > 0)
        maxb = _psfgrp._DENSE_BUCKETS[-1]
        buckets_arr = np.asarray(_psfgrp._DENSE_BUCKETS, np.int32)
        use_v2 = os.environ.get("PYIMCOM_SWEEP_V2", "1") == "1"
        if use_v2:
            # --- v2 planning: gather-free sweep kernels -------------------
            # pool rects: chunk columns to <= WQ, cap pieces at (WQ-1)*w2
            # so one WQ-wide window covers each piece's index spans
            WQ = assemble.WQ
            k0 = np.flatnonzero(live & (r_kind == 0))
            nch = -(-r_w2[k0] // WQ)
            rid0 = np.repeat(k0, nch)
            first0 = np.concatenate([[0], np.cumsum(nch)])[:-1]
            ci = np.arange(int(nch.sum()), dtype=np.int64) \
                - np.repeat(first0, nch)
            c0 = ci * WQ
            w2c = np.minimum(WQ, r_w2[rid0] - c0).astype(np.int64)
            nq0 = r_w1[rid0].astype(np.int64) * w2c
            cap = np.minimum(maxb, (WQ - 1) * w2c)
            npc0 = (-(-nq0 // cap)).astype(np.int64)
            pid0 = np.repeat(np.arange(len(rid0)), npc0)
            firstp = np.concatenate([[0], np.cumsum(npc0)])[:-1]
            po0 = ((np.arange(int(npc0.sum()), dtype=np.int64)
                    - np.repeat(firstp, npc0))
                   * np.repeat(cap, npc0)).astype(np.int32)
            pn0 = np.minimum(np.repeat(cap, npc0),
                             nq0[pid0] - po0).astype(np.int32)
            v2_pool = dict(
                kg=r_kg[rid0][pid0],
                i1=r_i1[rid0][pid0],
                i2=(r_i2[rid0] + c0).astype(np.int32)[pid0],
                w2=w2c.astype(np.int32)[pid0],
                base=(r_a[rid0] + c0).astype(np.int32)[pid0],
                stride=r_b[rid0][pid0],
                off=po0, nval=pn0,
                bidx=np.searchsorted(buckets_arr, pn0))
            # B rects: w2 == m always; plain flat chunking
            k1 = np.flatnonzero(live & (r_kind == 1))
            nq1 = r_w1[k1].astype(np.int64) * m
            npc1 = -(-nq1 // maxb)
            pid1 = np.repeat(np.arange(len(k1)), npc1)
            first1 = np.concatenate([[0], np.cumsum(npc1)])[:-1]
            po1 = ((np.arange(int(npc1.sum()), dtype=np.int64)
                    - np.repeat(first1, npc1)) * maxb).astype(np.int32)
            pn1 = np.minimum(maxb, nq1[pid1] - po1).astype(np.int32)
            v2_b = dict(
                kg=r_kg[k1][pid1],
                i1=r_i1[k1][pid1],
                i2=r_i2[k1][pid1],
                dstb=r_a[k1][pid1],
                col0=r_b[k1][pid1],
                off=po1, nval=pn1,
                bidx=np.searchsorted(buckets_arr, pn1))
        else:
            nq_all = (r_w1 * r_w2)[live]
            npc = -(-nq_all // maxb)
            rect_id = np.repeat(np.flatnonzero(live), npc)
            first = np.concatenate([[0], np.cumsum(npc)])[:-1].astype(np.int64)
            p_off = ((np.arange(npc.sum(), dtype=np.int64)
                      - np.repeat(first, npc)) * maxb).astype(np.int32)
            p_nval = np.minimum(maxb, (r_w1 * r_w2)[rect_id] - p_off).astype(np.int32)
            p_bidx = np.searchsorted(buckets_arr, p_nval)
        _plan.__exit__(None, None, None)

        # ---- stage every host->device array of this group ------------------
        # A production group uploads 30-45 small arrays; the whole group's
        # tables/metadata are staged host-side first and shipped in ONE
        # batched device_put, then the compute dispatches read the resolved
        # handles.  Kept pending H100 measurement (ROADMAP).
        staged = []

        def stage(x):
            staged.append(np.asarray(x))
            return len(staged) - 1

        off_grid = geom.nc_ovl + _psfgrp.INTERP_PAD
        dt_np = np.dtype(dt)
        _plan2 = _phase("stamp.plan")
        _plan2.__enter__()
        L = len(xt)
        # v2 windows slice past the live region: pad the tables so
        # i2_base + m, w1_start + WQ and the B-kernel's i1 window
        # (maxb//m + 2 wide) stay in-bounds -- a clamped dynamic_slice
        # would silently SHIFT the window
        pad_req = L + (max(assemble.WQ, m, maxb // max(m, 1) + 2) + 8
                       if use_v2 else 0)
        Lp = self._rungs.fit("table", pad_req, _psfgrp._TABLE_PAD)
        xt_np = np.pad(np.asarray(xt, np.float64), (0, Lp - L))
        yt_np = np.pad(np.asarray(yt, np.float64), (0, Lp - L))
        i_xt = stage(xt_np)
        i_yt = stage(yt_np)
        if use_v2:
            i_v2tabs = [stage(t) for t in assemble.split_tables(xt_np, yt_np)]

        sweep_plan = []   # ("pool"|"b", bucket, idx...) / ("v1", ...)
        if use_v2:
            for bidx, bucket in enumerate(_psfgrp._DENSE_BUCKETS):
                rbatch = _psfgrp._DENSE_RBATCH_BY_BUCKET[bucket]
                sel = np.flatnonzero(v2_pool["bidx"] == bidx)
                if len(sel):
                    NB = _scan_pad(-(-len(sel) // rbatch))
                    tot = NB * rbatch
                    ks = np.zeros(tot, np.int32)
                    imeta = np.zeros((tot, 5), np.int32)
                    imeta[:, 2] = 1
                    pmeta = np.zeros((tot, 5), np.int32)
                    pmeta[:, 1] = 1
                    npc_ = len(sel)
                    ks[:npc_] = v2_pool["kg"][sel]
                    imeta[:npc_] = np.stack(
                        [v2_pool["i1"][sel], v2_pool["i2"][sel],
                         v2_pool["w2"][sel], v2_pool["off"][sel],
                         v2_pool["nval"][sel]], axis=1)
                    pmeta[:npc_] = np.stack(
                        [v2_pool["base"][sel], v2_pool["w2"][sel],
                         v2_pool["stride"][sel], v2_pool["off"][sel],
                         v2_pool["nval"][sel]], axis=1)
                    sweep_plan.append(
                        ("pool", bucket,
                         stage(ks.reshape(NB, rbatch)),
                         stage(imeta.reshape(NB, rbatch, 5)),
                         stage(pmeta.reshape(NB, rbatch, 5))))
                sel = np.flatnonzero(v2_b["bidx"] == bidx)
                if len(sel):
                    NB = _scan_pad(-(-len(sel) // rbatch))
                    tot = NB * rbatch
                    ks = np.zeros(tot, np.int32)
                    imeta = np.zeros((tot, 5), np.int32)
                    imeta[:, 2] = 1
                    bmeta = np.zeros((tot, 4), np.int32)
                    npc_ = len(sel)
                    ks[:npc_] = v2_b["kg"][sel]
                    imeta[:npc_] = np.stack(
                        [v2_b["i1"][sel], v2_b["i2"][sel],
                         np.full(npc_, m, np.int32), v2_b["off"][sel],
                         v2_b["nval"][sel]], axis=1)
                    bmeta[:npc_] = np.stack(
                        [v2_b["dstb"][sel], v2_b["col0"][sel],
                         v2_b["off"][sel], v2_b["nval"][sel]], axis=1)
                    sweep_plan.append(
                        ("b", bucket,
                         stage(ks.reshape(NB, rbatch)),
                         stage(imeta.reshape(NB, rbatch, 5)),
                         stage(bmeta.reshape(NB, rbatch, 4))))
        else:
            for bidx, bucket in enumerate(_psfgrp._DENSE_BUCKETS):
                sel = np.flatnonzero(p_bidx == bidx)
                if not len(sel):
                    continue
                rbatch = _psfgrp._DENSE_RBATCH_BY_BUCKET[bucket]
                NB = _scan_pad(-(-len(sel) // rbatch))
                tot = NB * rbatch
                rid = rect_id[sel]
                ks = np.zeros(tot, np.int32)
                imeta = np.zeros((tot, 5), np.int32)
                imeta[:, 2] = 1  # width placeholder for padded rows
                pmeta = np.zeros((tot, 5), np.int32)
                bmeta = np.zeros((tot, 4), np.int32)
                npc_ = len(sel)
                ks[:npc_] = r_kg[rid]
                imeta[:npc_] = np.stack(
                    [r_i1[rid], r_i2[rid], r_w2[rid], p_off[sel],
                     p_nval[sel]], axis=1)
                isp = r_kind[rid] == 0
                pm = pmeta[:npc_]
                pm[isp] = np.stack(
                    [r_a[rid][isp], r_w2[rid][isp], r_b[rid][isp],
                     p_off[sel][isp], p_nval[sel][isp]], axis=1)
                bm = bmeta[:npc_]
                bm[~isp] = np.stack(
                    [r_a[rid][~isp], r_b[rid][~isp], p_off[sel][~isp],
                     p_nval[sel][~isp]], axis=1)
                sweep_plan.append(
                    ("v1", bucket,
                     stage(ks.reshape(NB, rbatch)),
                     stage(imeta.reshape(NB, rbatch, 5)),
                     stage(pmeta.reshape(NB, rbatch, 5)),
                     stage(bmeta.reshape(NB, rbatch, 4))))
        # flat-field penalty constants over the fresh submatrices
        fp_plan = None
        if fp_rows:
            R = _scan_pad(len(fp_rows))
            meta = np.zeros((R, 5), np.int32)
            consts = np.zeros(R, np.float64)
            meta[:len(fp_rows)] = [mrow for mrow, _c in fp_rows]
            consts[:len(fp_rows)] = [c for _m, c in fp_rows]
            fp_plan = (stage(consts.astype(dt_np)), stage(meta))

        # register fresh submatrices now -- bookkeeping only; the pool array
        # itself is created at dispatch time and the overlap-stack
        # references are released only after the sweep has dispatched
        self._pool_round = getattr(self, "_pool_round", 0) + 1
        pool_holder = {"arr": None, "device": device,
                       "round": self._pool_round}
        for key, (base, n1s, n2s, n1r, n2r, jA, jB, okey, seam) in \
                fresh.items():
            self._dev_submat.setdefault(key, {})[devid] = dict(
                holder=pool_holder, base=base, n1=n1s, n2=n2s,
                n1r=n1r, n2r=n2r, ji_row=jA, ji_col=jB)
            self._submat_computed.add(key)

        # ---- group A assembly plan: one call per (pool, rung, symmetry) ----
        S = len(infos)
        solver = self._solver_name()
        mode = self._assembly_mode()
        sel_parts = []
        sel_off = {}     # (s_idx, ji) -> offset into the group selmap
        slot_off = {}    # (s_idx, ji) -> slot range start in the stamp
        sc = 0
        diag = np.zeros((S, n_pad), dtype=dt_np)
        calls = {}
        for s_idx, (j_st, i_st, info) in enumerate(infos):
            ji_in_s = info["ji_in_s"]
            counts, cumsum = info["counts"], info["cumsum"]
            for idx, ji in enumerate(ji_in_s):
                st = self.instamps[ji]
                local = np.full(st.n_pix, -1, dtype=np.int32)
                sel = info["sels"][idx]
                if sel is None:
                    local[:] = cumsum[idx] + np.arange(counts[idx])
                else:
                    local[sel] = cumsum[idx] + np.arange(len(sel))
                sel_off[(s_idx, ji)] = sc
                slot_off[(s_idx, ji)] = int(cumsum[idx])
                sel_parts.append(local)
                sc += st.n_pix
            # identity diagonal on PADDED slots only (padding convention)
            diag[s_idx] = np.arange(n_pad) >= info["n"]
            dstA_base = s_idx * n_pad * n_pad
            if mode == "dus":
                def enq(calls_, rec, selo, sidx, _dstA, sym, dev):
                    self._enqueue_submat_dus(calls_, rec, selo, slot_off,
                                             sidx, sym, dev)
            elif mode == "mm":
                enq = self._enqueue_submat_mm
            else:
                enq = self._enqueue_submat_rows
            for ji in ji_in_s:
                key = (ji, ji)
                enq(calls, self._dev_submat[key][devid], sel_off, s_idx,
                    dstA_base, False, device)
                self._drop_dev_ref(key)
            for ja, jb in combinations(ji_in_s, 2):
                key = (ja, jb) if ja <= jb else (jb, ja)
                enq(calls, self._dev_submat[key][devid], sel_off, s_idx,
                    dstA_base, True, device)
                self._drop_dev_ref(key)
        # selection-map length is a compiled shape too; the padded tail
        # (-1 = unselected) is never indexed by any metadata row
        sel_cat = np.concatenate(sel_parts)
        sel_pad = self._rungs.fit("selmap", len(sel_cat), 1024)
        i_selmap = stage(np.pad(sel_cat, (0, sel_pad - len(sel_cat)),
                                constant_values=-1))
        i_diag = stage(diag)
        asm_plan = []    # (holder, staged-meta idx, n1r, n2r, sym)
        NC = n_pad
        if mode in ("dus", "mm"):
            if mode == "dus":
                margin = max([max(k[1], k[2]) for k in calls], default=8)
                NC = n_pad + margin
            W = 7 if mode == "dus" else 5
            for (hid, n1r, n2r, sym), (holder, rows) in calls.items():
                U = self._rungs.fit("mm_uses", len(rows), 4)
                uses = np.zeros((U, W), np.int32)
                uses[:len(rows)] = rows
                asm_plan.append((holder, stage(uses), n1r, n2r, sym))
        else:
            for (hid, sym), (holder, rows) in calls.items():
                R = _scan_pad(len(rows))
                meta = np.zeros((R, 7), np.int32)
                meta[:len(rows)] = rows
                asm_plan.append((holder, stage(meta), 0, 0, sym))

        # ---- solve inputs (host) -------------------------------------------
        data = np.zeros((S, cfg.n_inframe, n_pad), dtype=np.float32)
        onehot = np.zeros((S, n_pad, self.n_inimage), dtype=np.float32)
        for s_idx, (_j, _i, info) in enumerate(infos):
            n = info["n"]
            data[s_idx, :, :n] = np.concatenate(info["datas"], axis=1)
            inimg = (np.concatenate(info["imgs"]) if n
                     else np.zeros(0, np.int32))
            onehot[s_idx, np.arange(n), inimg] = 1.0
        if solver == "iterative":
            # acceptance-radius mask from the stamp coordinates
            # (reference lakernel.py:614-620); padded slots sit at the
            # 1e6 sentinel and never pass
            rel_np = np.zeros((S, m, n_pad), dtype=bool)
            for s_idx, (_j, _i, info) in enumerate(infos):
                n = info["n"]
                ix = np.full(n_pad, 1e6)
                iy = np.full(n_pad, 1e6)
                ix[:n] = np.concatenate(info["xs"])
                iy[:n] = np.concatenate(info["ys"])
                rel_np[s_idx] = (np.hypot(
                    info["out_y"][:, None] - iy[None, :],
                    info["out_x"][:, None] - ix[None, :])
                    < info["rho_acc"])
        else:
            rel_np = np.zeros((S, 1, 1), dtype=bool)
        if not defer_solve:
            i_data = stage(data)
            i_onehot = stage(onehot)
            i_rel = stage(rel_np)
        _plan2.__exit__(None, None, None)

        # ---- THE upload: one batched RPC for the whole group ---------------
        with _phase("stamp.upload"):
            res = jax.device_put(staged, device)

        # ---- dispatch: fused sweep, ONE compiled scan per bucket size ------
        with _phase("stamp.scatter"):
            combined = self._group_combined_stack(stacks, dt, device)
            xt_d, yt_d = res[i_xt], res[i_yt]
            if use_v2:
                v2_tabs = [res[i] for i in i_v2tabs]
            pool_holder["arr"] = assemble.zeros_on(max(pool_alloc, 1), dt,
                                                   device)
            Bflat = assemble.zeros_on(max(len(infos) * nBflat, 1), dt, device)
            for ent in sweep_plan:
                if ent[0] == "pool":
                    _, bucket, ia, ib, ic = ent
                    pool_holder["arr"] = assemble.sweep_pool_scan(
                        pool_holder["arr"], combined, *v2_tabs,
                        res[ia], res[ib], res[ic],
                        1.0 / geom.dscale, off_grid, bucket, kern)
                elif ent[0] == "b":
                    _, bucket, ia, ib, ic = ent
                    Bflat = assemble.sweep_b_scan(
                        Bflat, combined, xt_d, yt_d,
                        res[ia], res[ib], res[ic],
                        1.0 / geom.dscale, off_grid, bucket, kern,
                        n_pad, m)
                else:
                    _, bucket, ia, ib, ic, ie = ent
                    pool_holder["arr"], Bflat = assemble.sweep_scatter_scan(
                        pool_holder["arr"], Bflat, combined, xt_d, yt_d,
                        res[ia], res[ib], res[ic], res[ie],
                        1.0 / geom.dscale, off_grid, bucket, kern, n_pad, m)
            if fp_plan is not None:
                pool_holder["arr"] = assemble.scatter_pool_constant(
                    pool_holder["arr"], res[fp_plan[0]], res[fp_plan[1]], CH)
            _sync((pool_holder["arr"], Bflat))

        # the sweep dispatch holds its own references to the overlap stacks;
        # release the bookkeeping references for the fresh submatrices
        for key, (base, n1s, n2s, n1r, n2r, jA, jB, okey, seam) in \
                fresh.items():
            self._release_ii_overlap(*okey)

        # ---- group A assembly dispatch -------------------------------------
        with _phase("stamp.assembleA"):
            selmap = res[i_selmap]
            if mode == "dus":
                canvas = assemble.init_A_canvas(res[i_diag], n_pad, NC)
                for holder, i_uses, n1r, n2r, sym in asm_plan:
                    canvas = assemble.pool_to_A_dus(
                        canvas, holder["arr"], res[i_uses], selmap,
                        n1r, n2r, NC, sym)
                A_flat = assemble.canvas_to_A(canvas, n_pad)
                del canvas
            elif mode == "mm":
                A_flat = assemble.init_A_batch(res[i_diag], n_pad)
                for holder, i_uses, n1r, n2r, sym in asm_plan:
                    A_flat = assemble.pool_to_A_mm(
                        A_flat, holder["arr"], res[i_uses], selmap,
                        n1r, n2r, n_pad, sym)
            else:
                A_flat = assemble.init_A_batch(res[i_diag], n_pad)
                for holder, i_meta, _n1r, _n2r, sym in asm_plan:
                    fn = (assemble.pool_to_A_sym if sym
                          else assemble.pool_to_A)
                    A_flat = fn(A_flat, holder["arr"], res[i_meta], selmap,
                                CH, n_pad)
            _sync(A_flat)

        # ---- batched solve + coadd: one dispatch for the whole group -------
        with _phase("stamp.solve"):
            if defer_solve:
                return (infos, dict(
                    A=A_flat.reshape(S, n_pad, n_pad),
                    B=Bflat.reshape(S, n_out, m, n_pad),
                    data=data, onehot=onehot, rel=rel_np,
                    n_pad=n_pad, S=S, solver=solver, device=device))
            fade, kappaC, C = self._solve_consts(devid, device, dt_np)
            exact_UC = len(cfg.kappaC_arr) > 1
            out = assemble.solve_finalize_batch(
                A_flat.reshape(S, n_pad, n_pad),
                Bflat.reshape(S, n_out, m, n_pad),
                C, kappaC, res[i_data], res[i_onehot], fade, res[i_rel],
                cfg.uctarget, cfg.sigmamax, cfg.iter_rtol,
                n2 * n2, solver, exact_UC, cfg.iter_max)
            _sync(out)
        return [(infos, out, 0, zeros)]

    def _solve_consts(self, devid, device, dt_np):
        """Per-device cache of the block-constant solve inputs.

        fade / kappaC / C are identical for every group of a block; the
        reference re-derives them per postage stamp on the host
        (lakernel.py:250-262); here they are shipped once per device and
        reused."""
        import jax

        cache = getattr(self, "_const_cache", None)
        if cache is None:
            cache = self._const_cache = {}
        key = (devid, str(dt_np))
        ent = cache.get(key)
        if ent is None:
            tree = [np.asarray(self._fade_vec(), dtype=dt_np),
                    np.asarray(self.cfg.kappaC_arr, dtype=np.float64),
                    np.asarray(self.outovlc, dtype=np.float64)]
            ent = cache[key] = jax.device_put(tree, device)
        return ent

    def _group_combined_stack(self, stacks, dt, device):
        """Concatenate the group's overlap stacks on `device`.

        Stacks are placed into a rung-padded buffer with one
        dynamic_update_slice per stack: program signatures depend only on
        (buffer rung, stack shape), never on the per-group multiset of
        stacks -- a direct jnp.concatenate signature recompiled for nearly
        every production group.  Padded rows are zeros and are referenced
        only by padded (nval = 0) scan rows.
        """
        import jax.numpy as jnp

        from .ops import assemble

        if not stacks:
            return jnp.zeros((1, 1, 1), dtype=dt)
        ny, nx = stacks[0].shape[-2:]
        stot = sum(s.shape[0] for s in stacks)
        K = self._rungs.fit("stack_rows", stot, 8)
        buf = assemble.zeros3_on(K, ny, nx, dt, device)
        off = 0
        for s in stacks:
            buf = assemble.place_stack(buf, s, np.int32(off))
            off += s.shape[0]
        return buf

    def _drain_group_results(self, results):
        """Download the stacked device outputs and accumulate them.

        Records are (infos, out, row_offset, zeros); mesh rounds share one
        `out` dict of globally-sharded arrays across their groups
        (downloaded once, cached by identity).  Zero-input stamps deferred
        from plan time accumulate here, so the maps always equal the
        drained-group prefix (checkpoint consistency)."""
        cfg = self.cfg
        n_out, n2f = cfg.n_out, cfg.n2f
        host_cache = {}
        # ---- drain: one stacked download per group + host accumulation -----
        with _phase("solve.download"):
            for infos, out, off, zeros in results:
                for (j_z, i_z) in zeros:
                    self._zero_stamp_acc(j_z, i_z)
                self._groups_drained += 1
                if out is None:
                    continue
                host = host_cache.get(id(out))
                if host is None:
                    dbg = os.environ.get("PYIMCOM_DEBUG_DRAIN") == "1"
                    host = {}
                    for k, v in out.items():
                        if dbg:
                            print("drain:", k, getattr(v, "shape", None),
                                  flush=True)
                        host[k] = np.asarray(v)
                    host_cache[id(out)] = host
                for s_off, (j_st, i_st, info) in enumerate(infos):
                    s_idx = off + s_off
                    UC = host["UC"][s_idx].reshape(n_out, n2f, n2f)
                    Sigma = host["Sigma"][s_idx].reshape(n_out, n2f, n2f)
                    kappa = host["kappa"][s_idx].reshape(n_out, n2f, n2f)
                    sq = np.sqrt(np.maximum(host["UC"][s_idx], 1e-32))
                    ss = np.sqrt(np.maximum(host["Sigma"][s_idx], 1e-32))
                    print("  n input pix =", info["n"], flush=True)
                    print(f"  sqUC,sqSig medians | {np.median(sq):8.2E} "
                          f"{np.median(ss):8.2E}", flush=True)
                    self._accumulate(
                        j_st, i_st,
                        host["outimage"][s_idx].reshape(
                            n_out, cfg.n_inframe, n2f, n2f),
                        UC, Sigma, kappa,
                        host["Tsum_inpix"][s_idx].reshape(n_out, n2f, n2f),
                        host["Neff"][s_idx].reshape(n_out, n2f, n2f),
                        host["Tsum_stamp"][s_idx])
                    self._consume_refs(info["ji_in_s"])
        self._maybe_evict_pools()
        self._maybe_ckpt()

    # HBM budget for retained submatrix pools.  A production block retains
    # every group's pool for a whole row sweep (the next stamp row reuses
    # the cross-row submatrices), which at 2560^2-block geometry is tens of
    # GiB -- far over a single chip's HBM, forcing the runtime into
    # host-paging thrash.  Beyond the budget, the OLDEST pools are dropped
    # and their still-referenced submatrices recompute on next use through
    # the band-seam machinery (the sweep is compute-cheap next to paging).
    # The reference's analogous pressure valve is the A-submatrix disk
    # spill (reference psfutil.py:2056-2085).  Sized for a 16 GB device;
    # to be derived from the H100's memory limit (ROADMAP).
    POOL_BUDGET_GB = 6.0

    def _maybe_evict_pools(self):
        budget = float(os.environ.get("PYIMCOM_POOL_BUDGET_GB",
                                      str(self.POOL_BUDGET_GB))) * 2 ** 30
        holders = {}   # id -> [bytes, round, [(key, devid)]]
        for key, sub in self._dev_submat.items():
            for devid, rec in sub.items():
                h = rec["holder"]
                ent = holders.get(id(h))
                if ent is None:
                    arr = h.get("arr")
                    nb = 0 if arr is None else arr.size * arr.dtype.itemsize
                    ent = holders[id(h)] = [nb, h.get("round", 0), []]
                ent[2].append((key, devid))
        total = sum(e[0] for e in holders.values())
        if total <= budget:
            return
        cur = max((e[1] for e in holders.values()), default=0)
        for ent in sorted(holders.values(), key=lambda e: e[1]):
            if total <= budget or ent[1] >= cur:
                break   # never evict the newest round's pools
            for key, devid in ent[2]:
                sub = self._dev_submat.get(key)
                if sub is not None:
                    sub.pop(devid, None)
                    if not sub:
                        self._dev_submat.pop(key, None)
            total -= ent[0]
            print(f"pool budget: evicted round-{ent[1]} pool "
                  f"({ent[0] / 2**30:.2f} GiB, {len(ent[2])} submats); "
                  f"retained {total / 2**30:.2f} GiB", flush=True)

    def _enqueue_submat_rows(self, calls, rec, sel_off, s_idx, dstA_base,
                             sym, device=None):
        """Append pool_to_A metadata rows for one submatrix use.

        Band sharding guarantees the pool is already resident on the
        stamp's device (seam submatrices are recomputed per device), so no
        device-to-device replication ever happens here; the counter guards
        that invariant for the tests.
        """
        n1r, n2r = rec["n1r"], rec["n2r"]
        m1 = sel_off[(s_idx, rec["ji_row"])]
        m2 = sel_off[(s_idx, rec["ji_col"])]
        holder = rec["holder"]
        if device is not None and holder["device"] is not device:
            self._cross_device_puts += 1
            raise RuntimeError(
                "cross-device pool reuse slipped through band sharding "
                f"(pool on {holder['device']}, stamp on {device})")
        entry = calls.setdefault((id(holder), sym), (holder, []))
        # chunk over the rung-padded (n1r, n2r) storage tile: padded
        # entries hold zeros and scatter-add nothing
        total = n1r * n2r
        for off in range(0, total, self.CHUNK):
            entry[1].append((rec["base"] + off, n2r, m1, m2,
                             min(self.CHUNK, total - off), off, dstA_base))

    def _use_mm_assembly(self):
        """Selection-matmul A assembly (pool_to_A_mm) vs element scatter.

        Default ON: placement by matrix products instead of an element
        scatter; PYIMCOM_A_MM=0 restores the scatter path for A/B
        comparisons."""
        return os.environ.get("PYIMCOM_A_MM", "1") == "1"

    def _assembly_mode(self):
        """A-assembly strategy: "dus" (contiguous-block compaction +
        dynamic-slice add; default), "mm" (selection matmuls into the full
        stamp matrix), or "scatter" (element scatter).

        PYIMCOM_A_MODE overrides directly; the legacy PYIMCOM_A_MM=0 knob
        still forces the scatter path."""
        mode = os.environ.get("PYIMCOM_A_MODE")
        if mode in ("dus", "mm", "scatter"):
            return mode
        if not self._use_mm_assembly():
            return "scatter"
        return "dus"

    def _enqueue_submat_dus(self, calls, rec, sel_off, slot_off, s_idx,
                            sym, device=None):
        """Append one pool_to_A_dus use row for a submatrix placement."""
        m1 = sel_off[(s_idx, rec["ji_row"])]
        m2 = sel_off[(s_idx, rec["ji_col"])]
        d1 = slot_off[(s_idx, rec["ji_row"])]
        d2 = slot_off[(s_idx, rec["ji_col"])]
        holder = rec["holder"]
        if device is not None and holder["device"] is not device:
            self._cross_device_puts += 1
            raise RuntimeError(
                "cross-device pool reuse slipped through band sharding "
                f"(pool on {holder['device']}, stamp on {device})")
        entry = calls.setdefault(
            (id(holder), rec["n1r"], rec["n2r"], sym), (holder, []))
        entry[1].append((rec["base"], m1, m2, s_idx, 1, d1, d2))

    def _enqueue_submat_mm(self, calls, rec, sel_off, s_idx, dstA_base,
                           sym, device=None):
        """Append one pool_to_A_mm use row for a submatrix placement."""
        m1 = sel_off[(s_idx, rec["ji_row"])]
        m2 = sel_off[(s_idx, rec["ji_col"])]
        holder = rec["holder"]
        if device is not None and holder["device"] is not device:
            self._cross_device_puts += 1
            raise RuntimeError(
                "cross-device pool reuse slipped through band sharding "
                f"(pool on {holder['device']}, stamp on {device})")
        entry = calls.setdefault(
            (id(holder), rec["n1r"], rec["n2r"], sym), (holder, []))
        entry[1].append((rec["base"], m1, m2, s_idx, 1))

    def _drop_dev_ref(self, key):
        """Consume one reference to a device-pooled submatrix (all device
        copies are dropped together when the sim-counted uses are spent)."""
        self._submat_ref[key] -= 1
        if self._submat_ref[key] <= 0:
            self._dev_submat.pop(key, None)

    # ----- main coaddition loop ---------------------------------------------

    def coadd_output_stamps(self, sim_mode=False):
        cfg = self.cfg
        if sim_mode:
            # reference-counting pass
            self._grp_ref = {}
            self._ovl_ref = {}
            self._io_ref = {}
            self._submat_ref = {}
            self._grp_cache = {}
            self._ovl_cache = {}
            self._io_cache = {}
            self._submat_cache = _SubmatStore(cfg.tempfile)
            self._dev_submat = {}
            self._submat_computed = set()
            self._cross_device_puts = 0
        else:
            n_out = cfg.n_out
            NsidePf = cfg.NsideP + cfg.fade_kernel * 2
            self.out_map = np.zeros((n_out, cfg.n_inframe, NsidePf, NsidePf), dtype=np.float32)
            self.T_weightmap = np.zeros((n_out, self.n_inimage, cfg.n1P, cfg.n1P),
                                        dtype=np.float32)
            shape = (n_out, NsidePf, NsidePf)
            outmaps = cfg.outmaps
            self.UC_map = np.zeros(shape, dtype=np.float32) if "U" in outmaps else None
            self.Sigma_map = np.zeros(shape, dtype=np.float32) if "S" in outmaps else None
            self.kappa_map = np.zeros(shape, dtype=np.float32) if "K" in outmaps else None
            self.Tsum_map = np.zeros(shape, dtype=np.float32) if "T" in outmaps else None
            self.Neff_map = np.zeros(shape, dtype=np.float32) if "N" in outmaps else None
            self._groups_drained = 0
            self._ckpt_t_last = time.time()
            if getattr(self, "_ckpt_maps", None):
                for name, arr in self._ckpt_maps.items():
                    cur = getattr(self, name, None)
                    if cur is not None and cur.shape == arr.shape:
                        cur[...] = arr
                self._ckpt_maps = None

        # the 2x2 iteration blocks require even stamp counts per axis
        # (reference coadd.py:2052-2055; auto padding must keep n1 + pads
        # even, as the production PAD=2 configs do)
        if ((self.j_st_max + 1 - self.j_st_min) % 2 == 1
                or (self.i_st_max + 1 - self.i_st_min) % 2 == 1):
            raise ValueError(
                f"Stamp span must be even per axis for 2x2 PSF-group "
                f"iteration: y={self.j_st_min}..{self.j_st_max}, "
                f"x={self.i_st_min}..{self.i_st_max}. Check the PAD / "
                f"PADSIDES config parity (n1 + pads must be even, as in the "
                f"production PAD=2 configs). The reference silently iterates "
                f"past the boundary here (coadd.py:2052-2060); we fail fast.")

        use_device = (not sim_mode) and self._device_path_enabled()
        devices = self._stamp_devices() if use_device else [None]
        n_dev = max(1, len(devices))

        # enumerate the 2x2 groups in scan order, honoring the stamp cap
        groups = []
        n_coadded = 0
        done = False
        for j_st in range(self.j_st_min, self.j_st_max + 1, 2):
            if done:
                break
            for i_st in range(self.i_st_min, self.i_st_max + 1, 2):
                group = []
                for dj, di in product(range(2), range(2)):
                    group.append((j_st + dj, i_st + di))
                    n_coadded += 1
                    if n_coadded == self.nrun:
                        break
                groups.append(group)
                if n_coadded == self.nrun:
                    done = True
                    break

        # checkpoint resume: skip the completed scan-order prefix in BOTH
        # passes (the sim pass must count references only for the stamps
        # the real pass will actually run)
        if sim_mode:
            self._ckpt_load(len(groups))
        k0 = getattr(self, "_ckpt_base", 0)
        if k0:
            groups = groups[k0:]
            if sim_mode:
                print(f"checkpoint: skipping {k0} completed groups",
                      flush=True)

        if not use_device:
            for group in groups:
                for (j, i) in group:
                    self._output_stamp(j, i, sim_mode)
                if not sim_mode:
                    self._groups_drained += 1
                    self._maybe_ckpt()
            return

        depth = max(1, int(os.environ.get("PYIMCOM_PIPELINE_DEPTH", "2")))
        in_flight = []  # enqueued-but-undrained rounds (device still busy)

        def push(records):
            # keep PYIMCOM_PIPELINE_DEPTH rounds in flight: the host plans
            # round k+1 while the devices compute round k; drain the oldest
            # round only when the window is full
            in_flight.append(records)
            while len(in_flight) >= depth:
                self._drain_group_results(in_flight.pop(0))

        if n_dev <= 1:
            for group in groups:
                push(self._coadd_group_device(group, None) or [])
        else:
            self._coadd_groups_banded(groups, devices, push)
        for records in in_flight:
            self._drain_group_results(records)

    # ----- block checkpoint / resume -------------------------------------
    #
    # PYIMCOM_CHECKPOINT=1 snapshots the accumulated output maps plus the
    # count of fully drained 2x2 groups every PYIMCOM_CKPT_SEC seconds
    # (default 600).  A rerun of the same block resumes after the saved
    # scan-order prefix -- both the sim pass (reference counting) and the
    # real pass skip the same groups, so cache bookkeeping stays exact.
    # Zero-input stamps accumulate at drain time (never ahead of the
    # drained prefix), so the snapshot is always consistent.  The reference
    # has no intra-block restart (its envelope restarts whole blocks,
    # scripts/writejob_example.pl); this enables multi-hour production
    # blocks to survive preemption and crashes.

    _CKPT_MAPS = ("out_map", "T_weightmap", "UC_map", "Sigma_map",
                  "kappa_map", "Tsum_map", "Neff_map")

    def _ckpt_file(self):
        if os.environ.get("PYIMCOM_CHECKPOINT", "0") != "1":
            return None
        return self.outstem + ".ckpt.npz"

    def _ckpt_load(self, n_groups):
        """Read a prior snapshot (called once, from the sim pass)."""
        self._ckpt_base = 0
        self._ckpt_maps = None
        self._ckpt_n_groups = n_groups
        p = self._ckpt_file()
        if not p or not os.path.exists(p):
            return
        with np.load(p) as z:
            if int(z["n_groups"]) != n_groups or int(z["nrun"]) != self.nrun:
                print(f"checkpoint: {p} is for a different geometry "
                      f"(n_groups {int(z['n_groups'])} != {n_groups}); "
                      f"ignoring", flush=True)
                return
            self._ckpt_base = int(z["groups_done"])
            self._ckpt_maps = {k: z[k] for k in z.files
                               if k in self._CKPT_MAPS}
        print(f"checkpoint: resuming after {self._ckpt_base}/{n_groups} "
              f"groups from {p}", flush=True)

    def _maybe_ckpt(self, force=False):
        p = self._ckpt_file()
        if not p:
            return
        every = float(os.environ.get("PYIMCOM_CKPT_SEC", "600"))
        if not force and time.time() - self._ckpt_t_last < every:
            return
        arrs = {"groups_done": np.int64(self._ckpt_base
                                        + self._groups_drained),
                "n_groups": np.int64(self._ckpt_n_groups),
                "nrun": np.int64(self.nrun)}
        for name in self._CKPT_MAPS:
            a = getattr(self, name, None)
            if a is not None:
                arrs[name] = a
        tmp = p + ".tmp.npz"
        np.savez(tmp, **arrs)
        os.replace(tmp, p)
        self._ckpt_t_last = time.time()
        print(f"checkpoint: saved {int(arrs['groups_done'])} groups "
              f"-> {p}", flush=True)
        self._print_hbm()
        # cumulative phase timings at every snapshot (PYIMCOM_PROFILE=1),
        # so multi-hour production runs expose where the time goes
        _profile_report(f"ckpt {int(arrs['groups_done'])}")

    def _print_hbm(self):
        """Device memory telemetry (when the platform exposes it): live
        bytes and peak, plus the host-side count of retained device pools."""
        try:
            import jax

            for d in jax.local_devices():
                ms = d.memory_stats() or {}
                used = ms.get("bytes_in_use")
                peak = ms.get("peak_bytes_in_use")
                if used is None:
                    continue
                holders = {}
                for sub in self._dev_submat.values():
                    for rec in sub.values():
                        arr = rec["holder"].get("arr")
                        if arr is not None:
                            holders[id(rec["holder"])] = arr.size * arr.dtype.itemsize
                print(f"hbm[{d.id}]: in_use {used / 2**30:.2f} GiB, "
                      f"peak {0 if peak is None else peak / 2**30:.2f} GiB, "
                      f"retained pools {len(holders)} "
                      f"({sum(holders.values()) / 2**30:.2f} GiB), "
                      f"submat keys {len(self._dev_submat)}", flush=True)
        except Exception:  # noqa: BLE001 - telemetry only
            pass

    def _coadd_groups_banded(self, groups, devices, push):
        """
        Multi-device block execution with COLUMN-BAND sharding.

        Each device owns a contiguous band of group columns, so the
        submatrix pools reused between vertically adjacent groups stay on
        one device for the whole block -- nothing is ever replicated
        device-to-device (seam submatrices at band boundaries are
        recomputed locally instead; `_cross_device_puts` guards the
        invariant).  Rows are processed as super-rounds: each mini-round
        dispatches one group per device and, when shapes align, batches the
        solves into ONE shard_map program over the device mesh with
        collective quality reductions (parallel.mesh.solve_finalize_mesh).
        Rows drain in exact scan order, so the output block is identical to
        the single-device one at the bit level
        (tests/test_device_assembly.py).
        """
        D = len(devices)
        cols = sorted({g[0][1] for g in groups})
        col_of = {c: k for k, c in enumerate(cols)}
        bands = np.array_split(np.arange(len(cols)), D)
        band_of = np.zeros(len(cols), dtype=np.int64)
        for d, idx in enumerate(bands):
            band_of[idx] = d

        rows = {}
        for g in groups:
            j0, i0 = g[0]
            rows.setdefault(j0, [[] for _ in range(D)])[
                band_of[col_of[i0]]].append(g)

        for j0 in sorted(rows):
            bandq = rows[j0]
            row_records = []
            r = 0
            while any(len(q) > r for q in bandq):
                entries = [(q[r], devices[d])
                           for d, q in enumerate(bandq) if len(q) > r]
                row_records += self._solve_round(entries)
                r += 1
            # records of one row, reordered to scan order for the drain
            def scan_key(rec):
                infos, _out, _off, zeros = rec
                j, i = infos[0][:2] if infos else zeros[0]
                return (j, i)

            row_records.sort(key=scan_key)
            push(row_records)

    def _solve_round(self, entries):
        """
        Dispatch one mini-round: assemble each group on its band device,
        then solve.  When every group has the same stamp count, the solves
        batch into one shard_map program over the round's device mesh
        (collectives; see parallel/mesh.py); otherwise each group
        solves on its own device as before.
        """
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from .parallel.mesh import solve_finalize_mesh

        cfg = self.cfg
        planned = []
        zero_records = []   # all-zero groups: map writes deferred to drain
        for g, d in entries:
            infos, zeros = self._group_infos(g)
            if infos:
                planned.append((g, d, infos, zeros))
            elif zeros:
                zero_records.append(([], None, 0, zeros))
        if not planned:
            return zero_records
        use_mesh = (len(planned) > 1
                    and len({len(i) for _g, _d, i, _z in planned}) == 1
                    and os.environ.get("PYIMCOM_MESH_SOLVE", "1") == "1")
        if not use_mesh:
            records = zero_records
            for g, d, infos, zeros in planned:
                recs = self._coadd_group_device(g, d, infos=infos) or []
                records += [(inf, out, off, zeros)
                            for (inf, out, off, _z) in recs]
            return records

        # one n_pad across the round so the shard shapes match (padding is
        # neutral: identity diagonal, zero B columns)
        n_pad = self._rungs.fit(
            "n_pad",
            max(i[2]["n"] for _g, _d, infos, _z in planned for i in infos),
            SOLVE_BUCKET)
        parts = []
        for g, d, infos, _zeros in planned:
            parts.append(self._coadd_group_device(
                g, d, infos=infos, n_pad=n_pad, defer_solve=True))
        S = parts[0][1]["S"]
        solver = parts[0][1]["solver"]
        devs = [d for _g, d, _i, _z in planned]
        mesh = Mesh(np.array(devs, dtype=object), ("s",))
        sh = NamedSharding(mesh, P("s"))
        repl = NamedSharding(mesh, P())
        n_out, n2f = cfg.n_out, cfg.n2f
        m = n2f * n2f
        Dn = len(parts)
        A_g = jax.make_array_from_single_device_arrays(
            (Dn * S, n_pad, n_pad), sh, [p[1]["A"] for p in parts])
        B_g = jax.make_array_from_single_device_arrays(
            (Dn * S, n_out, m, n_pad), sh, [p[1]["B"] for p in parts])
        data_g = jax.device_put(
            np.concatenate([p[1]["data"] for p in parts]), sh)
        onehot_g = jax.device_put(
            np.concatenate([p[1]["onehot"] for p in parts]), sh)
        rel_g = jax.device_put(
            np.concatenate([p[1]["rel"] for p in parts]), sh)
        dt_np = np.dtype(_psfgrp.compute_dtype())
        fade = jax.device_put(np.asarray(self._fade_vec(), dtype=dt_np), repl)
        kappaC = jax.device_put(np.asarray(cfg.kappaC_arr, np.float64), repl)
        C = jax.device_put(np.asarray(self.outovlc, np.float64), repl)
        out, stats = solve_finalize_mesh(
            mesh, A_g, B_g, C, kappaC, data_g, onehot_g, fade, rel_g,
            cfg.uctarget, cfg.sigmamax, cfg.iter_rtol, cfg.n2 * cfg.n2,
            solver, len(cfg.kappaC_arr) > 1, cfg.iter_max)
        self._round_stats = stats  # device scalars; printed at block end
        return zero_records + [(infos, out, k * S, zeros)
                               for k, (_g, _d, infos, zeros)
                               in enumerate(planned)]

    def _sim_count(self, ji_in_s, ji_out):
        """Simulation pass: count every cache reference this stamp will make."""
        if self.cfg.linear_algebra == "Empirical" and self.cfg.no_qlt_ctrl:
            return  # no system matrices are built in this mode
        if not hasattr(self, "_sim_seen"):
            self._sim_seen = set()
        seen_submat_new = []
        for ji in ji_in_s:
            key = (ji, ji)
            self._submat_ref[key] = self._submat_ref.get(key, 0) + 1
            if key not in self._sim_seen:
                self._sim_seen.add(key)
                seen_submat_new.append(key)
        for ji1, ji2 in combinations(ji_in_s, 2):
            key = (ji1, ji2) if ji1 <= ji2 else (ji2, ji1)
            self._submat_ref[key] = self._submat_ref.get(key, 0) + 1
            if key not in self._sim_seen:
                self._sim_seen.add(key)
                seen_submat_new.append(key)
        for key in seen_submat_new:
            gp1, gp2 = group_of(key[0]), group_of(key[1])
            okey = (gp1, gp2) if gp1 <= gp2 else (gp2, gp1)
            first = okey not in self._ovl_ref or self._ovl_ref[okey] == 0
            self._ovl_ref[okey] = self._ovl_ref.get(okey, 0) + 1
            if first:
                self._grp_ref[okey[0]] = self._grp_ref.get(okey[0], 0) + 1
                if okey[1] != okey[0]:
                    self._grp_ref[okey[1]] = self._grp_ref.get(okey[1], 0) + 1
        # io overlaps: one use per input stamp of this output stamp
        for ji in ji_in_s:
            gp = group_of(ji)
            first = gp not in self._io_ref or self._io_ref[gp] == 0
            self._io_ref[gp] = self._io_ref.get(gp, 0) + 1
            if first:
                self._grp_ref[gp] = self._grp_ref.get(gp, 0) + 1

    def _stamp_inputs(self, j_st, i_st):
        """Pixel selection and output-grid geometry of one output stamp."""
        cfg = self.cfg
        ji_in_s = [(j_st + dj, i_st + di) for dj in range(-1, 2) for di in range(-1, 2)]
        fade_kernel = cfg.fade_kernel
        n2 = cfg.n2
        bottom = (j_st - 1) * n2
        top = bottom + n2 - 1
        left = (i_st - 1) * n2
        right = left + n2 - 1
        rho_acc = (cfg.instamp_pad / Stn.arcsec) / (cfg.dtheta * 3600.0)

        # select input pixels from the 3x3 stamp neighborhood
        stamps = [self.instamps[ji] for ji in ji_in_s]
        sels, xs, ys, imgs, datas = [], [], [], [], []
        for ji, st in zip(ji_in_s, stamps):
            x_pivot = [left - 0.5, None, right + 0.5][ji[1] - i_st + 1]
            y_pivot = [bottom - 0.5, None, top + 0.5][ji[0] - j_st + 1]
            sel = st.make_selection((x_pivot, y_pivot), rho_acc)
            sels.append(sel)
            if sel is None:
                xs.append(st.x_val)
                ys.append(st.y_val)
                imgs.append(st.img_idx)
                datas.append(st.data)
            else:
                xs.append(st.x_val[sel])
                ys.append(st.y_val[sel])
                imgs.append(st.img_idx[sel])
                datas.append(st.data[:, sel])
        counts = np.array([len(x) for x in xs])
        cumsum = np.concatenate([[0], np.cumsum(counts)])
        n = int(cumsum[-1])

        # output grid positions (with fade transition ring)
        oy, ox = np.mgrid[bottom - fade_kernel:top + fade_kernel + 1,
                          left - fade_kernel:right + fade_kernel + 1]
        return dict(ji_in_s=ji_in_s, sels=sels, xs=xs, ys=ys, imgs=imgs,
                    datas=datas, counts=counts, cumsum=cumsum, n=n,
                    rho_acc=rho_acc,
                    out_x=ox.ravel().astype(np.float64),
                    out_y=oy.ravel().astype(np.float64))

    def _zero_stamp(self, j_st, i_st, ji_in_s):
        """Stamp with no input pixels: U=C, Sigma=0, kappa=1 (reference
        lakernel.py:109-119); releases every sim-pass reference."""
        self._zero_stamp_acc(j_st, i_st)
        self._zero_stamp_refs(ji_in_s)

    def _zero_stamp_acc(self, j_st, i_st):
        """Map contributions of a zero-input stamp (accumulation only)."""
        cfg = self.cfg
        n_out, n2f = cfg.n_out, cfg.n2f
        self._accumulate(j_st, i_st, np.zeros((n_out, cfg.n_inframe, n2f, n2f),
                                              dtype=np.float32),
                         np.ones((n_out, n2f, n2f), np.float32),
                         np.zeros((n_out, n2f, n2f), np.float32),
                         np.ones((n_out, n2f, n2f), np.float32),
                         np.zeros((n_out, n2f, n2f), np.float32),
                         np.ones((n_out, n2f, n2f), np.float32),
                         np.zeros((n_out, self.n_inimage), np.float32))

    def _zero_stamp_refs(self, ji_in_s):
        """Release every sim-pass reference a zero-input stamp holds."""
        cfg = self.cfg
        if not (cfg.linear_algebra == "Empirical" and cfg.no_qlt_ctrl):
            for ji in ji_in_s:
                self._drop_iisubmat_ref(ji, ji)
            for ji1, ji2 in combinations(ji_in_s, 2):
                if ji1 <= ji2:
                    self._drop_iisubmat_ref(ji1, ji2)
                else:
                    self._drop_iisubmat_ref(ji2, ji1)
        self._consume_refs(ji_in_s)

    def _output_stamp(self, j_st, i_st, sim_mode=False):
        cfg = self.cfg
        ji_in_s = [(j_st + dj, i_st + di) for dj in range(-1, 2) for di in range(-1, 2)]

        if sim_mode:
            self._sim_count(ji_in_s, (j_st, i_st))
            return

        print(f"postage stamp {i_st:2d},{j_st:2d}  t= {self.timer():9.2f} s", flush=True)
        info = self._stamp_inputs(j_st, i_st)
        sels, xs, ys, imgs = info["sels"], info["xs"], info["ys"], info["imgs"]
        cumsum, n = info["cumsum"], info["n"]
        out_x, out_y, rho_acc = info["out_x"], info["out_y"], info["rho_acc"]
        fade_kernel = cfg.fade_kernel
        n2 = cfg.n2
        n2f = cfg.n2f
        inx = np.concatenate(xs) if n else np.zeros(0)
        iny = np.concatenate(ys) if n else np.zeros(0)
        inimg = np.concatenate(imgs) if n else np.zeros(0, dtype=np.int32)
        indata = (np.concatenate(info["datas"], axis=1) if n
                  else np.zeros((cfg.n_inframe, 0), dtype=np.float32))
        m = n2f * n2f
        n_out = cfg.n_out

        if n == 0:
            self._zero_stamp(j_st, i_st, ji_in_s)
            return

        no_qlt = cfg.linear_algebra == "Empirical" and cfg.no_qlt_ctrl

        if not no_qlt:
            # dense path: ONE fused interpolation sweep computes every
            # uncached ii-submatrix and all nine io-submatrices
            io_subs = (self._precompute_stamp_mats(ji_in_s, xs, ys, imgs,
                                                   out_x, out_y)
                       if _psfgrp._use_dense() else None)

            # ---- A matrix -------------------------------------------------
            _asm_t = _phase("stamp.assembleA")
            _asm_t.__enter__()
            A = np.zeros((n, n))
            for idx, ji in enumerate(ji_in_s):
                sub = self._get_iisubmat(ji, ji)
                if sels[idx] is not None:
                    sub = sub[np.ix_(sels[idx], sels[idx])]
                A[cumsum[idx]:cumsum[idx + 1], cumsum[idx]:cumsum[idx + 1]] = sub
            for (ia, ib), (ja, jb), (sa, sb) in zip(
                    combinations(range(9), 2), combinations(ji_in_s, 2),
                    combinations(sels, 2)):
                ji1, ji2 = ja, jb
                swapped = not (ji1 <= ji2)
                key = (ji1, ji2) if not swapped else (ji2, ji1)
                sub = self._get_iisubmat(*key)
                if swapped:
                    sub = sub.T
                if sa is not None:
                    sub = sub[sa, :]
                if sb is not None:
                    sub = sub[:, sb]
                A[cumsum[ia]:cumsum[ia + 1], cumsum[ib]:cumsum[ib + 1]] = sub
                A[cumsum[ib]:cumsum[ib + 1], cumsum[ia]:cumsum[ia + 1]] = sub.T

            # ---- -B/2 matrix ----------------------------------------------
            mBhalf = np.zeros((n_out, m, n))
            for idx, ji in enumerate(ji_in_s):
                if io_subs is not None:
                    sub = io_subs[idx]
                else:
                    gp = group_of(ji)
                    stack, grp = self._get_io_overlap(gp)
                    sub = interp_io_submatrix(
                        self.geom, stack, xs[idx], ys[idx], imgs[idx],
                        grp.idx_blk2grp, out_x, out_y, n_out)
                mBhalf[:, :, cumsum[idx]:cumsum[idx + 1]] = sub
            _asm_t.__exit__(None, None, None)
            C = self.outovlc
        else:
            A = mBhalf = None
            C = self.outovlc

        # ---- solve -----------------------------------------------------
        with _phase("solve.total"):
            T, kappa, Sigma, UC = self._solve(A, mBhalf, C, inx, iny, out_x,
                                              out_y, rho_acc, n)

        print("  n input pix =", n, flush=True)
        sq = np.sqrt(np.maximum(UC, 1e-32))
        ss = np.sqrt(np.maximum(Sigma, 1e-32))
        print(f"  sqUC,sqSig medians | {np.median(sq):8.2E} {np.median(ss):8.2E}", flush=True)

        if cfg.linear_algebra == "Iterative":
            UC = np.maximum(UC, 1e-32)
            Sigma = np.maximum(Sigma, 1e-32)

        UC = UC.reshape(n_out, n2f, n2f).astype(np.float32)
        Sigma = Sigma.reshape(n_out, n2f, n2f).astype(np.float32)
        kappa = kappa.reshape(n_out, n2f, n2f).astype(np.float32)
        if fade_kernel > 0:
            trapezoid(kappa, fade_kernel)
            trapezoid(Sigma, fade_kernel)
            trapezoid(UC, fade_kernel)

        # ---- coaddition -------------------------------------------------
        _coadd_t = _phase("stamp.coadd_host")
        _coadd_t.__enter__()
        if fade_kernel > 0:
            T_view = np.moveaxis(T, 1, -1).reshape(n_out, n, n2f, n2f)
            trapezoid(T_view, fade_kernel)

        # per-image weights
        Tsum_image = np.zeros((n_out, m, self.n_inimage))
        for i_im in range(self.n_inimage):
            msk = inimg == i_im
            if np.any(msk):
                Tsum_image[:, :, i_im] = np.sum(T[:, :, msk], axis=2)
        Tsum_stamp = (np.sum(Tsum_image, axis=1) / n2 ** 2).astype(np.float32)
        Tsum_inpix = np.sum(Tsum_image, axis=2).reshape(n_out, n2f, n2f).astype(np.float32)
        with np.errstate(invalid="ignore", divide="ignore"):
            Tsum_norm = Tsum_image / np.abs(Tsum_image).sum(axis=2)[:, :, None]
            Neff = 1.0 / np.sum(np.square(Tsum_norm), axis=2)
        Neff = np.nan_to_num(Neff).reshape(n_out, n2f, n2f).astype(np.float32)
        if fade_kernel > 0:
            trapezoid(Neff, fade_kernel)

        outimage = np.einsum("oaj,ij->oia", T, indata).reshape(
            n_out, cfg.n_inframe, n2f, n2f).astype(np.float32)
        _coadd_t.__exit__(None, None, None)

        self._accumulate(j_st, i_st, outimage, UC, Sigma, kappa, Tsum_inpix, Neff,
                         Tsum_stamp)
        self._consume_refs(ji_in_s)

    def _solve(self, A, mBhalf, C, inx, iny, out_x, out_y, rho_acc, n):
        """Dispatch to the configured LA kernel with bucketed padding."""
        import jax.numpy as jnp

        from .solvers import KERNELS

        cfg = self.cfg
        n_out = cfg.n_out
        m = cfg.n2f ** 2
        kind = cfg.linear_algebra
        kappaC = jnp.asarray(cfg.kappaC_arr)

        n_pad = max(SOLVE_BUCKET, int(np.ceil(n / SOLVE_BUCKET) * SOLVE_BUCKET))
        need_dist = kind in ("Iterative", "Empirical")
        dist = None
        if need_dist:
            dist = np.full((m, n_pad), 1e6)
            dist[:, :n] = np.hypot(out_y[:, None] - iny[None, :],
                                   out_x[:, None] - inx[None, :])

        import jax

        accel = jax.default_backend() != "cpu"
        if kind == "Empirical" and cfg.no_qlt_ctrl:
            Ai = jnp.eye(n_pad)
            Bi = jnp.zeros((n_out, m, n_pad))
        elif accel:
            # the matrix entries carry f32 accuracy (the overlap values are
            # interpolated in f32 on accelerators), so ship them over the
            # host->device link in f32 and upcast on device -- the SOLVE
            # still runs in f64, only the transfer is halved
            with _phase("solve.upload"):
                Ap = np.eye(n_pad, dtype=np.float32)
                Ap[:n, :n] = A
                Bp = np.zeros((n_out, m, n_pad), dtype=np.float32)
                Bp[:, :, :n] = mBhalf
                Ai = _device_f64(jnp.asarray(Ap))
                Bi = _device_f64(jnp.asarray(Bp))
                _sync((Ai, Bi))
        else:
            Ap = np.eye(n_pad)
            Ap[:n, :n] = A
            Bp = np.zeros((n_out, m, n_pad))
            Bp[:, :, :n] = mBhalf
            Ai = jnp.asarray(Ap)
            Bi = jnp.asarray(Bp)
        Ci = jnp.asarray(C)

        # Precision policy: monolithic f64 Cholesky on CPU; on accelerators
        # 'auto' uses the blocked f64 factorization (kept pending H100
        # measurement, ROADMAP).  Set SOLVERPREC to 'f64' / 'mixed' to
        # force either.
        prec = getattr(cfg, "solver_prec", "auto")
        use_mixed = prec == "mixed"

        if kind == "Eigen":
            if jax.default_backend() != "cpu":
                # device emulation of the eigen contract (dense kappa grid
                # + blocked Cholesky) in place of f64 eigh; ROADMAP reach
                # item 3 replaces it with the true eigh contract.
                from .solvers import eigen_solve_device

                T, kappa, Sigma, UC = eigen_solve_device(
                    Ai, Bi, Ci, kappaC, cfg.uctarget, cfg.sigmamax)
            else:
                T, kappa, Sigma, UC = KERNELS["Eigen"](Ai, Bi, Ci, kappaC,
                                                       cfg.uctarget, cfg.sigmamax)
        elif kind == "Cholesky":
            if use_mixed:
                from .solvers import cholesky_solve_mixed

                T, kappa, Sigma, UC = cholesky_solve_mixed(
                    Ai, Bi, Ci, kappaC, cfg.uctarget, cfg.sigmamax)
            elif prec == "auto" and jax.default_backend() != "cpu":
                # full-f64 quality via the blocked factorization
                from .solvers import cholesky_solve_blocked

                with _phase("solve.kernel"):
                    T, kappa, Sigma, UC = _sync(cholesky_solve_blocked(
                        Ai, Bi, Ci, kappaC, cfg.uctarget, cfg.sigmamax))
            else:
                T, kappa, Sigma, UC = KERNELS["Cholesky"](Ai, Bi, Ci, kappaC,
                                                          cfg.uctarget, cfg.sigmamax)
        elif kind == "Iterative":
            relevant = jnp.asarray(dist < rho_acc)
            T, kappa, Sigma, UC = KERNELS["Iterative"](
                Ai, Bi, Ci, kappaC, relevant, cfg.iter_rtol,
                cfg.uctarget, cfg.sigmamax, maxiter=cfg.iter_max,
                exact_UC=(len(cfg.kappaC_arr) > 1))
        elif kind == "Empirical":
            T, kappa, Sigma, UC = KERNELS["Empirical"](
                Ai, Bi, Ci, kappaC, jnp.asarray(dist), rho_acc,
                no_qlt_ctrl=cfg.no_qlt_ctrl)
        else:
            raise ValueError(f"unknown LAKERNEL {kind!r}")

        if accel:
            # T feeds the f32 coadd accumulation; downcast on device to
            # halve the device->host transfer
            T = _device_f32(T)
        with _phase("solve.download"):
            return (np.array(T, dtype=np.float64)[:, :, :n], np.array(kappa),
                    np.array(Sigma), np.array(UC))

    def _consume_refs(self, ji_in_s):
        """Release io-overlap references made by one output stamp."""
        if self.cfg.linear_algebra == "Empirical" and self.cfg.no_qlt_ctrl:
            return
        for ji in ji_in_s:
            self._release_io_overlap(group_of(ji))

    def _accumulate(self, j_st, i_st, outimage, UC, Sigma, kappa, Tsum_inpix, Neff,
                    Tsum_stamp):
        cfg = self.cfg
        bottom = (j_st - 1) * cfg.n2
        top = j_st * cfg.n2 + cfg.fade_kernel * 2
        left = (i_st - 1) * cfg.n2
        right = i_st * cfg.n2 + cfg.fade_kernel * 2

        self.out_map[:, :, bottom:top, left:right] += outimage
        self.T_weightmap[:, :, j_st - 1, i_st - 1] = Tsum_stamp
        if self.UC_map is not None:
            self.UC_map[:, bottom:top, left:right] += UC
        if self.Sigma_map is not None:
            self.Sigma_map[:, bottom:top, left:right] += Sigma
        if self.kappa_map is not None:
            self.kappa_map[:, bottom:top, left:right] += kappa
        if self.Tsum_map is not None:
            self.Tsum_map[:, bottom:top, left:right] += Tsum_inpix
        if self.Neff_map is not None:
            self.Neff_map[:, bottom:top, left:right] += Neff

    # ----- output ------------------------------------------------------------

    def build_output_file(self, is_final=True):
        cfg = self.cfg
        fk = cfg.fade_kernel
        NsidePf = cfg.NsideP + fk * 2
        outmaps = cfg.outmaps

        if is_final:
            trapezoid(self.out_map, fk, recover_mode=True)
            width = cfg.postage_pad * cfg.n2
            pad_widths = (width * ("B" not in self.pad_sides),
                          width * ("T" not in self.pad_sides),
                          width * ("L" not in self.pad_sides),
                          width * ("R" not in self.pad_sides))
            for mp in [self.UC_map, self.Sigma_map, self.kappa_map,
                       self.Tsum_map, self.Neff_map]:
                if mp is not None:
                    trapezoid(mp, fk, True, pad_widths)

        hdr = Header(self.outwcs.to_header())

        maphdu = ImageHDU(self.out_map[:, :, fk:NsidePf - fk, fk:NsidePf - fk],
                          header=hdr)

        cfg_lines = np.array(self.cfg.to_file(None).splitlines())
        config_hdu = TableHDU(data={"text": cfg_lines}, name="CONFIG", ascii_table=True)
        config_hdu.columns = [("text", "A512")]
        config_hdu.header["TILESCHM"] = cfg.tileschm
        config_hdu.header["RERUN"] = cfg.rerun
        config_hdu.header["MOSAIC"] = cfg.mosaic
        config_hdu.header["FILTER"] = Stn.RomanFilters[cfg.use_filter]
        config_hdu.header["BLOCKX"] = self.ibx
        config_hdu.header["BLOCKY"] = self.iby

        inlist_hdu = TableHDU(data={
            "obsid": np.array([obs[0] for obs in self.obslist], dtype=np.int32),
            "sca": np.array([obs[1] for obs in self.obslist], dtype=np.int16),
            "ra": np.array([self.obsdata["ra"][obs[0]] for obs in self.obslist]),
            "dec": np.array([self.obsdata["dec"][obs[0]] for obs in self.obslist]),
            "pa": np.array([self.obsdata["pa"][obs[0]] for obs in self.obslist]),
            "valid": np.array([im.exists_ for im in self.inimages], dtype=bool),
        }, name="INDATA")

        T_hdu = ImageHDU(self.T_weightmap, name="INWEIGHT")
        T_hdu2 = ImageHDU(
            np.transpose(self.T_weightmap, axes=(0, 2, 1, 3)).reshape(
                (cfg.n_out * cfg.n1P, max(self.n_inimage, 1) * cfg.n1P)),
            name="INWTFLAT")

        hdus = HDUList([maphdu, config_hdu, inlist_hdu, T_hdu, T_hdu2])
        crop = np.s_[:, fk:NsidePf - fk, fk:NsidePf - fk]
        if "U" in outmaps and self.UC_map is not None:
            h = ImageHDU(compress_map(self.UC_map[crop], -5000, np.uint16),
                         header=Header(self.outwcs.to_header()), name="FIDELITY")
            h.header["UNIT"] = "-0.2mB"
            hdus.append(h)
        if "S" in outmaps and self.Sigma_map is not None:
            h = ImageHDU(compress_map(self.Sigma_map[crop], -10000, np.int16),
                         header=Header(self.outwcs.to_header()), name="SIGMA")
            h.header["UNIT"] = "-0.1mB"
            hdus.append(h)
        if "K" in outmaps and self.kappa_map is not None:
            h = ImageHDU(compress_map(self.kappa_map[crop], -5000, np.uint16),
                         header=Header(self.outwcs.to_header()), name="KAPPA")
            h.header["UNIT"] = "-0.2mB"
            hdus.append(h)
        if "T" in outmaps and self.Tsum_map is not None:
            h = ImageHDU(compress_map(self.Tsum_map[crop], 200000, np.int16),
                         header=Header(self.outwcs.to_header()), name="INWTSUM")
            h.header["UNIT"] = "5uB"
            hdus.append(h)
        if "N" in outmaps and self.Neff_map is not None:
            h = ImageHDU(compress_map(self.Neff_map[crop], 50000, np.uint16),
                         header=Header(self.outwcs.to_header()), name="EFFCOVER")
            h.header["UNIT"] = "20uB"
            hdus.append(h)

        if cfg.psfsplit:
            # iteration count + previous-iteration configs (reference OLDCFG
            # HDU, coadd.py:2308-2325)
            text = ""
            it = 0
            iterfile = cfg.inlayercache + "_iter.txt"
            oldcfgfile = cfg.inlayercache + "_oldcfg.json"
            if exists(iterfile):
                with open(iterfile) as f:
                    it = int(f.read().split()[0])
            if exists(oldcfgfile):
                with open(oldcfgfile) as f:
                    text = f.read()
            prev = TableHDU(data={"text": np.array(text.split() or [""])},
                            name="OLDCFG", ascii_table=True)
            prev.columns = [("text", "A512")]
            prev.header["IMSBITER"] = it
            hdus.append(prev)

        fits_write(self.outstem + ".fits", hdus)
        print("wrote", self.outstem + ".fits", flush=True)
