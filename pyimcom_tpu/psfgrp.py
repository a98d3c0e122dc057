"""
PSF groups, overlap arrays, and system-matrix assembly (device-resident).

Counterpart of reference src/pyimcom/psfutil.py (PSFGrp/PSFOvl/SysMatA/
SysMatB), re-organized for device execution:

* A **PSF group** holds the PSFs of all input images contributing to a 2x2
  group of input postage stamps, resampled onto a common output-frame grid
  (the WCS rotation happens in the sampling positions), plus their padded
  rFFTs.  Sampling is one batched device interpolation; FFTs are batched.
* An **overlap stack** between two PSF groups is the cross-correlation of
  every PSF pair, interpolation-padded, kept on device.  System submatrices
  are evaluated from it with a single stack-indexed gather-interpolation per
  stamp pair -- the per-(image-pair) C loops of the reference
  (psfutil.py:1401-1732) become one `interp2d_stack` call.
* Caches are reference-counted via the same two-pass (simulation, then
  real) scheme as the reference so device memory for overlap stacks and
  submatrices is bounded.

Shapes: nsamp = npixpsf*oversamp - 1 samples per axis, FFT grid
nfft = 2*npixpsf*oversamp, overlap window nsamp (2*nc+1).
"""

from __future__ import annotations

import os

import numpy as np

from .config import Settings as Stn
from .ops import psfmodels
from .ops.fourier import apply_amp_penalty, overlap_from_rft, pad_and_rfft2
from .profiling import phase as _phase, sync as _sync

INTERP_PAD = 6  # guard pixels for the 10x10 interpolation kernel


def compute_dtype():
    """
    Device dtype for the assembly pipeline (PSF sampling, FFTs, overlap
    interpolation): float64 on CPU; float32 on accelerators, kept pending
    H100 measurement (ROADMAP).  The T solves stay float64 everywhere --
    the quality targets (U/C ~ 1e-6) need it there, while the assembly
    tolerates f32 (chip_smoke.py checks the H100 block against the CPU f64
    path).
    """
    import jax
    import jax.numpy as jnp

    return jnp.float64 if jax.default_backend() == "cpu" else jnp.float32


class PSFGeometry:
    """Static geometry of PSF sampling and overlap arrays for one run."""

    def __init__(self, npixpsf: int = 48, oversamp: int = 8,
                 dtheta: float = 0.025 / 3600, psfsplit: bool = False,
                 psfinterp: str = "D5512"):
        from .ops.interp import KERNEL_FAMILIES

        if psfinterp not in KERNEL_FAMILIES:
            raise ValueError(f"unknown PSFINTERP {psfinterp!r}; "
                             f"choose from {sorted(KERNEL_FAMILIES)}")
        # interpolation kernel family (reference PSFInterpolator selector,
        # psfutil.py:52-87, driven by the PSFINTERP config key)
        self.psfinterp = psfinterp
        self.npixpsf = npixpsf
        self.oversamp = oversamp
        self.nsamp = npixpsf * oversamp - 1
        self.nc_samp = self.nsamp // 2
        self.nfft = npixpsf * oversamp * 2
        # sample spacing in output pixels
        self.dscale = (Stn.pixscale_native / Stn.arcsec) / oversamp / (dtheta * 3600)
        self.psfsplit = psfsplit
        # overlap window: doubled when PSF splitting is on (psfutil.py:1088)
        self.novl = 2 * self.nsamp + 1 if psfsplit else self.nsamp
        self.nc_ovl = self.novl // 2

        # unrotated sampling offsets (in samples), center 0
        c = (self.nsamp - 1) / 2.0
        ax = np.arange(self.nsamp, dtype=np.float64) - c
        self.yo = ax  # 1D; the 2D grid is the outer product
        self.xo = ax


class PSFGroup:
    """
    A group of PSFs sampled on the common overlap grid, with their rFFTs.

    Parameters
    ----------
    geom : PSFGeometry
    psf_arr : (n_psf, nsamp, nsamp) numpy array of sampled PSFs.
    idx_blk2grp / idx_grp2blk : optional maps between block-level input-image
        indices and the group's PSF slots (input groups only).
    """

    def __init__(self, geom: PSFGeometry, psf_arr: np.ndarray,
                 idx_blk2grp=None, idx_grp2blk=None,
                 psf_circ=False, psf_norm=False, amp_penalty=(0.0, 0.0),
                 device=None):
        import jax
        import jax.numpy as jnp

        def _put(a, dtype=None):
            a = jnp.asarray(a, dtype=dtype) if dtype is not None else a
            return jax.device_put(a, device) if device is not None else \
                jnp.asarray(a)

        self.geom = geom
        self.n_psf = psf_arr.shape[0]
        self.idx_blk2grp = idx_blk2grp
        self.idx_grp2blk = idx_grp2blk

        if psf_circ:
            yy, xx = np.meshgrid(geom.yo, geom.xo, indexing="ij")
            psf_arr = psf_arr * (np.hypot(yy, xx) < geom.nc_samp + 0.5)
        if psf_norm:
            psf_arr = psf_arr / psf_arr.sum(axis=(-2, -1), keepdims=True)

        mode = _overlap_mode()
        if mode == "device":
            # DFT-by-matmul at Precision.HIGHEST (ops/dftmm.py): the spectra
            # live on device as (re, im) f32 pairs and the overlap builds
            # never touch the host.  Kept pending H100 measurement against
            # complex128 jnp.fft (ROADMAP).
            from .ops import dftmm

            dt = compute_dtype()
            # psf_arr may already be a device array (device sampling path);
            # jnp.asarray keeps it resident either way
            xr, xi = dftmm.dft2_real(_put(psf_arr, dtype=dt), geom.nfft)
            if amp_penalty and amp_penalty[0] != 0.0 and amp_penalty[1] != 0.0:
                mult = dftmm.amp_penalty_multiplier(
                    geom.nfft, amp_penalty[0],
                    amp_penalty[1] * geom.oversamp, dt)
                xr = xr * mult
                xi = xi * mult
            self.psf_rft = (xr, xi)  # device (re, im) spectra
            self._rft_on = {}        # per-device copies (out PSF group only)
        elif mode == "host":
            # host f64 FFT fallback (PYIMCOM_DEVICE_OVERLAP=0): overlap
            # values are computed on the host and uploaded per stack.
            npad = geom.nfft - psf_arr.shape[-1]
            rft = np.fft.rfft2(np.pad(psf_arr, ((0, 0), (0, npad), (0, npad))))
            if amp_penalty and amp_penalty[0] != 0.0 and amp_penalty[1] != 0.0:
                u2 = np.fft.fftfreq(geom.nfft) ** 2
                ut2 = u2[:, None] + u2[None, :geom.nfft // 2 + 1]
                rft = rft * (1.0 + amp_penalty[0] * np.exp(
                    -2.0 * np.pi ** 2 * ut2 * (amp_penalty[1] * geom.oversamp) ** 2))
            self.psf_rft = rft  # (n_psf, nfft, nfft//2+1), host f64
        else:
            rft = pad_and_rfft2(jnp.asarray(psf_arr, dtype=compute_dtype()),
                                geom.nfft)
            if amp_penalty and amp_penalty[0] != 0.0 and amp_penalty[1] != 0.0:
                rft = apply_amp_penalty(rft, geom.nfft, amp_penalty[0],
                                        amp_penalty[1] * geom.oversamp)
            self.psf_rft = rft  # (n_psf, nfft, nfft//2+1), device

    def clear(self):
        self.psf_rft = None
        self._rft_on = {}

    def spectra_on(self, device):
        """
        This group's (re, im) spectra resident on `device` (device overlap
        mode only).  Used for the block-wide OUTPUT PSF group, which every
        band device needs: the copy is made once per device per block
        (setup, not steady-state traffic).  Input groups are instead built
        directly on their band's device (`PSFGroup(device=...)`).
        """
        import jax

        if device is None or not isinstance(self.psf_rft, tuple):
            return self.psf_rft
        key = getattr(device, "id", device)
        if key not in self._rft_on:
            xr, xi = self.psf_rft
            self._rft_on[key] = (jax.device_put(xr, device),
                                 jax.device_put(xi, device))
        return self._rft_on[key]


def sample_psf_rotated(geom: PSFGeometry, psf: np.ndarray,
                       outpix2world2inpix, compute_point_pix) -> np.ndarray:
    """
    Sample one input PSF onto the output-frame grid.

    The sampling positions are the unrotated grid mapped through the
    output->input WCS chain so the sampled PSF is expressed in output-frame
    orientation (reference PSFGrp._sample_psf, psfutil.py:709-795).

    psf : oversampled PSF image (ny, nx), centered at ((ny-1)/2, (nx-1)/2).
    """
    import jax.numpy as jnp

    from .ops.interp import interp2d

    ny, nx = psf.shape[-2:]
    xctr = (nx - 1) / 2.0
    yctr = (ny - 1) / 2.0

    # grid offsets in output pixels -> input-pixel offsets via WCS -> samples
    yy, xx = np.meshgrid(geom.yo, geom.xo, indexing="ij")
    xyo = np.stack([xx.ravel(), yy.ravel()], axis=-1) * geom.dscale
    inpix = outpix2world2inpix(xyo + np.asarray(compute_point_pix)[None, :])
    inpix = inpix - outpix2world2inpix(np.asarray([compute_point_pix]))
    qx = inpix[:, 0] * geom.oversamp + xctr + INTERP_PAD
    qy = inpix[:, 1] * geom.oversamp + yctr + INTERP_PAD

    psf_pad = np.pad(psf, INTERP_PAD)
    if _use_dense():
        from .ops.interp import interp2d_dense

        dt = compute_dtype()
        out = interp2d_dense(jnp.asarray(psf_pad, dtype=dt)[None],
                             jnp.asarray(qx)[None], jnp.asarray(qy)[None],
                             geom.psfinterp)[0]
    else:
        out = interp2d(jnp.asarray(psf_pad), jnp.asarray(qx), jnp.asarray(qy),
                       geom.psfinterp)
    return np.asarray(out).reshape(geom.nsamp, geom.nsamp)


def sample_psf_rotated_batch(geom: PSFGeometry, psfs, mapfns,
                             compute_point_pix, host=None,
                             as_device=False, device=None) -> np.ndarray:
    """
    Batched :func:`sample_psf_rotated`: all PSFs of a 2x2 group resample in
    ONE vectorized interpolation pass instead of one dispatch chain per PSF.

    Where it runs depends on where the overlaps are built:

    * device overlap mode (`as_device=True`): the dense device
      interpolation result is returned AS A DEVICE ARRAY -- it feeds
      straight into the on-device DFT spectra (ops/dftmm.py), so nothing
      downloads and nothing stalls the round pipeline.
    * host overlap mode (`host=None` on accelerators resolves to True):
      the interpolation runs on the HOST in f64 numpy, because the samples
      are consumed by host f64 FFTs, and downloading a device result would
      queue behind the previous round's solves on the FIFO device stream.

    psfs : list of (ny, nx) arrays (uniform shape).
    mapfns : list of outpix2world2inpix callables (one per PSF's exposure).
    """
    import jax.numpy as jnp

    from .ops.interp import interp2d_dense, interp2d_np

    n_psf = len(psfs)
    ny, nx = psfs[0].shape[-2:]
    xctr = (nx - 1) / 2.0
    yctr = (ny - 1) / 2.0
    yy, xx = np.meshgrid(geom.yo, geom.xo, indexing="ij")
    xyo = np.stack([xx.ravel(), yy.ravel()], axis=-1) * geom.dscale

    qx = np.zeros((n_psf, xyo.shape[0]))
    qy = np.zeros_like(qx)
    stack = np.zeros((n_psf, ny + 2 * INTERP_PAD, nx + 2 * INTERP_PAD))
    for g, (psf, mapfn) in enumerate(zip(psfs, mapfns)):
        inpix = mapfn(xyo + np.asarray(compute_point_pix)[None, :])
        inpix = inpix - mapfn(np.asarray([compute_point_pix]))
        qx[g] = inpix[:, 0] * geom.oversamp + xctr + INTERP_PAD
        qy[g] = inpix[:, 1] * geom.oversamp + yctr + INTERP_PAD
        stack[g] = np.pad(psf, INTERP_PAD)

    if host is None:
        host = _use_dense() and not as_device
    if host and not as_device:
        out = np.zeros_like(qx)
        chunk = 1 << 15       # bound the (N, size, size) patch working set
        for g in range(n_psf):
            for s in range(0, qx.shape[1], chunk):
                out[g, s:s + chunk] = interp2d_np(
                    stack[g], qx[g, s:s + chunk], qy[g, s:s + chunk],
                    geom.psfinterp)
        return out.reshape(n_psf, geom.nsamp, geom.nsamp)

    dt = compute_dtype()
    import jax

    def _put(a):
        return jax.device_put(a, device) if device is not None \
            else jnp.asarray(a)

    out = interp2d_dense(_put(np.asarray(stack, dtype=dt)), _put(qx),
                         _put(qy), geom.psfinterp)
    out = out.reshape(n_psf, geom.nsamp, geom.nsamp)
    return out if as_device else np.asarray(out)


def sample_psf_unrotated(geom: PSFGeometry, psfs: np.ndarray) -> np.ndarray:
    """Sample output PSFs on the unrotated grid (reference psfutil.py:784-795)."""
    import jax.numpy as jnp

    from .ops.interp import grid_interp, grid_interp_dense

    fn = grid_interp_dense if _use_dense() else grid_interp
    n_psf = psfs.shape[0]
    ny, nx = psfs.shape[-2:]
    xctr = (nx - 1) / 2.0
    yctr = (ny - 1) / 2.0
    out = np.zeros((n_psf, geom.nsamp, geom.nsamp))
    x = (geom.xo + xctr + INTERP_PAD)[None, :]
    y = (geom.yo + yctr + INTERP_PAD)[None, :]
    dt = compute_dtype()
    for i in range(n_psf):
        res = fn(jnp.asarray(np.pad(psfs[i], INTERP_PAD), dtype=dt),
                 jnp.asarray(x), jnp.asarray(y), geom.psfinterp)
        out[i] = np.asarray(res)[0]
    return out


def build_overlap_stack(geom: PSFGeometry, grp1: PSFGroup, grp2: PSFGroup | None,
                        device=None):
    """
    Overlap (cross-correlation) images for every PSF pair of two groups,
    padded for interpolation; kept on device.

    Returns a jnp array of shape (n1*n2, novl+2p, novl+2p); pair (i, j)
    of (grp1, grp2) is at index i*n2 + j.  grp2=None means self-overlap.
    With `device` set (band-sharded multi-device blocks), grp1's spectra
    are expected to live there already and grp2's are fetched via
    :meth:`PSFGroup.spectra_on`, so the build executes on that device.
    """
    import jax.numpy as jnp

    g2 = grp2 if grp2 is not None else grp1
    if isinstance(grp1.psf_rft, tuple):
        # device (re, im) spectra: the whole build runs as matrix
        # products (ops/dftmm.py) and nothing is uploaded per stack.
        from .ops import dftmm

        x1r, x1i = (grp1.spectra_on(device) if device is not None
                    else grp1.psf_rft)
        x2r, x2i = g2.spectra_on(device) if device is not None else g2.psf_rft
        with _phase("psf.overlap_dft"):
            return _sync(dftmm.overlap_from_spectra(
                x1r, x1i, x2r, x2i, geom.nfft, geom.novl, INTERP_PAD))
    if isinstance(grp1.psf_rft, np.ndarray):
        # host f64 path (accelerators; see PSFGroup.__init__)
        with _phase("psf.overlap_fft_host"):
            nc = geom.nc_ovl
            prod = grp1.psf_rft[:, None] * np.conj(g2.psf_rft[None, :])
            corr = np.fft.irfft2(prod, s=(geom.nfft, geom.nfft))
            corr = np.roll(corr, (nc, nc), axis=(-2, -1))[..., :geom.novl, :geom.novl]
            n1, n2 = corr.shape[:2]
            padded = np.pad(corr.reshape(n1 * n2, geom.novl, geom.novl),
                            ((0, 0), (INTERP_PAD, INTERP_PAD), (INTERP_PAD, INTERP_PAD)))
        with _phase("psf.overlap_upload"):
            return _sync(jnp.asarray(padded, dtype=compute_dtype()))

    rft1 = grp1.psf_rft[:, None]       # (n1, 1, ...)
    rft2 = g2.psf_rft[None, :]         # (1, n2, ...)
    ovl = overlap_from_rft(rft1, rft2, geom.novl, geom.nfft)  # (n1, n2, novl, novl)
    n1, n2 = ovl.shape[:2]
    ovl = jnp.pad(ovl.reshape(n1 * n2, geom.novl, geom.novl),
                  ((0, 0), (INTERP_PAD, INTERP_PAD), (INTERP_PAD, INTERP_PAD)))
    return ovl


def outpsf_C_values(geom: PSFGeometry, outgrp: PSFGroup) -> np.ndarray:
    """Target normalizations C: zero-lag self-overlap per output PSF."""
    if isinstance(outgrp.psf_rft, tuple):
        from .ops import dftmm

        xr, xi = outgrp.psf_rft
        return np.asarray(dftmm.zero_lag_from_spectra(xr, xi, geom.nfft),
                          dtype=np.float64)
    if isinstance(outgrp.psf_rft, np.ndarray):
        corr = np.fft.irfft2(outgrp.psf_rft * np.conj(outgrp.psf_rft),
                             s=(geom.nfft, geom.nfft))
        return corr[:, 0, 0]  # zero lag
    ovl = overlap_from_rft(outgrp.psf_rft, outgrp.psf_rft, geom.novl, geom.nfft)
    return np.asarray(ovl[:, geom.nc_ovl, geom.nc_ovl])


def _use_dense() -> bool:
    """Gather-free matmul interpolation on accelerators; gathers on CPU."""
    import jax

    return jax.default_backend() != "cpu"


def _overlap_mode() -> str:
    """
    Where PSF overlap stacks are built: "device" (DFT-by-matmul spectra,
    ops/dftmm.py) or "host" (f64 FFTs + per-stack upload) or "cpu"
    (complex FFTs through the CPU jit path).  PYIMCOM_DEVICE_OVERLAP
    overrides: 0 -> host FFTs on accelerators, 1 -> device spectra even on
    the CPU backend (used by the equivalence tests).
    """
    env = os.environ.get("PYIMCOM_DEVICE_OVERLAP", "auto")
    if env == "1":
        return "device"
    if _use_dense():
        return "host" if env == "0" else "device"
    return "cpu"


# query-count buckets and per-bucket rectangle batch sizes for the dense
# path.  Larger batches amortize dispatch latency; the W-matrix working set
# stays under ~200 MB f32.  Tuned for another accelerator: to be tuned on
# the H100 (ROADMAP).
_DENSE_BUCKETS = (1024, 4096, 16384)
_DENSE_RBATCH_BY_BUCKET = {1024: 128, 4096: 64, 16384: 32}


# coordinate tables are padded to multiples of this so only a handful of
# table lengths ever compile
_TABLE_PAD = 2048


def _interp_rects_enqueue(rects, xt, yt, inv_scale, off_grid,
                          kern: str = "D5512", device=None):
    """
    Enqueue the dense-sweep device computation for `rects` WITHOUT bringing
    the values back to the host.

    Same rect convention as :func:`_interp_rects_dense`.  Returns a list of
    (batch, dev_vals) where dev_vals is an (rbatch, bucket) device array and
    batch lists (rid, off, kg, i1s, i2s, w2, nval, bucket) rows aligned with
    it.  The device-resident assembly path scatters dev_vals straight into
    submatrix pools / B tensors; the host path drains them into numpy.
    """
    import jax
    import jax.numpy as jnp
    from collections import defaultdict

    from .ops.interp import interp2d_dense_pairs

    if not rects:
        return []

    def put(x):
        return jax.device_put(x, device) if device is not None else jnp.asarray(x)

    # combine all distinct stacks into one device array (one dispatch)
    stack_off = {}
    stacks = []
    total = 0
    for (stk, *_rest) in rects:
        if id(stk) not in stack_off:
            stack_off[id(stk)] = total
            stacks.append(stk)
            total += stk.shape[0]
    dt = compute_dtype()
    combined = (stacks[0] if len(stacks) == 1
                else jnp.concatenate(stacks, axis=0)).astype(dt)

    L = len(xt)
    Lp = max(_TABLE_PAD, -(-L // _TABLE_PAD) * _TABLE_PAD)
    xt_d = put(np.pad(np.asarray(xt, dtype=np.float64), (0, Lp - L)))
    yt_d = put(np.pad(np.asarray(yt, dtype=np.float64), (0, Lp - L)))

    pieces = []
    maxb = _DENSE_BUCKETS[-1]
    for rid, (stk, k, i1s, w1, i2s, w2) in enumerate(rects):
        if w1 == 0 or w2 == 0:
            continue
        kg = stack_off[id(stk)] + k
        nq = w1 * w2
        for off in range(0, nq, maxb):
            nval = min(maxb, nq - off)
            bucket = next(b for b in _DENSE_BUCKETS if b >= nval)
            pieces.append((rid, off, kg, i1s, i2s, w2, nval, bucket))

    groups = defaultdict(list)
    for p in pieces:
        groups[p[7]].append(p)
    pending = []
    with _phase("sweep.enqueue"):
        for bucket, plist in groups.items():
            rbatch = _DENSE_RBATCH_BY_BUCKET[bucket]
            for i0 in range(0, len(plist), rbatch):
                batch = plist[i0:i0 + rbatch]
                meta = np.zeros((rbatch, 5), dtype=np.int32)
                meta[:, 2] = 1  # width placeholder for padded rows (n_valid=0)
                ks = np.zeros(rbatch, dtype=np.int32)
                for j, (rid, off, kg, i1s, i2s, w2, nval, _b) in enumerate(batch):
                    meta[j] = (i1s, i2s, w2, off, nval)
                    ks[j] = kg
                imgs = jnp.take(combined, put(ks), axis=0)
                # tables stay f64: the fractional phase is extracted in f64
                # on device before the cast to the image dtype
                pending.append((batch, interp2d_dense_pairs(
                    imgs, xt_d, yt_d, put(meta), inv_scale, off_grid, bucket,
                    kern)))
    return pending


def _interp_rects_dense(rects, xt, yt, inv_scale, off_grid,
                        kern: str = "D5512"):
    """
    Evaluate outer-difference query rectangles against per-rectangle overlap
    images using the gather-free dense kernel, batched and bucket-padded so
    only a handful of shapes ever compile.

    Two costs shape this design:

    * dispatch count -- all referenced overlap stacks are concatenated on
      device ONCE per sweep and each batch selects its images with a single
      `take`, so an entire output stamp's system-matrix work costs a few
      dozen device ops (per-rect eager slicing would cost thousands);
    * host->device bandwidth -- queries are separations between coordinate-
      table entries, formed ON DEVICE from (start, width) metadata
      (`ops.interp.interp2d_dense_pairs`), so the upload is the (L,) tables
      (KBs) instead of the raveled O(n^2) query grids (~75 MB per stamp).

    rects : list of (stack, k, i1_start, w1, i2_start, w2) -- a device
        (n_k, ny, nx) overlap stack, an index into it, and the table spans:
        rect (p, q) evaluates at ((xt[i1+p] - xt[i2+q]) * inv_scale +
        off_grid, same in y), raveled row-major.
    xt, yt : 1-D host float64 coordinate tables.
    Returns a list of flat numpy value arrays (length w1*w2 each).
    """
    import jax.numpy as jnp
    from collections import defaultdict

    from .ops.interp import interp2d_dense_pairs

    results = [np.zeros(w1 * w2) for (_s, _k, _i1, w1, _i2, w2) in rects]
    pending = _interp_rects_enqueue(rects, xt, yt, inv_scale, off_grid, kern)
    with _phase("sweep.drain"):
        for batch, dev_vals in pending:
            vals = np.asarray(dev_vals)
            for j, (rid, off, _kg, _i1, _i2, _w2, nval, _b) in enumerate(batch):
                results[rid][off:off + nval] = vals[j, :nval]
    return results


def _image_runs(img_idx):
    """Contiguous runs of equal image index: list of (im, start, end)."""
    if len(img_idx) == 0:
        return []
    change = np.nonzero(np.diff(img_idx))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(img_idx)]])
    return [(int(img_idx[s]), int(s), int(e)) for s, e in zip(starts, ends)]


def submatrix_rect_plan(geom: PSFGeometry, ovl_stack, img1, img2,
                        blk2grp1, blk2grp2, n_psf2: int,
                        flat_penalty: float, n_in_eff: float,
                        base1: int, base2: int):
    """
    Build the dense-path rectangle plan for one system submatrix.

    Returns (rects, finalize): `rects` is a list of index-span rectangles
    for `_interp_rects_dense` (base1/base2 locate the two pixel groups in
    the sweep's coordinate tables); `finalize(vals)` assembles the flat
    value arrays into the (n1, n2) submatrix (applying the flat-field
    penalty).  Splitting plan from evaluation lets the block driver fuse
    every uncached submatrix of an output stamp into ONE device sweep
    instead of one dispatch chain per submatrix.
    """
    n1, n2 = len(img1), len(img2)
    # per-image-pair rectangles (pixels are image-sorted within a stamp)
    rects = []
    slices = []
    for im1, s1, e1 in _image_runs(img1):
        for im2, s2, e2 in _image_runs(img2):
            k = int(blk2grp1[im1]) * n_psf2 + int(blk2grp2[im2])
            rects.append((ovl_stack, k, base1 + s1, e1 - s1,
                          base2 + s2, e2 - s2))
            slices.append((s1, e1, s2, e2))

    def finalize(vals):
        res = np.zeros((n1, n2))
        for (s1, e1, s2, e2), v in zip(slices, vals):
            res[s1:e1, s2:e2] = v.reshape(e1 - s1, e2 - s2)
        if flat_penalty != 0.0:
            res = res - flat_penalty / n_in_eff
            res = res + flat_penalty * (img1[:, None] == img2[None, :])
        return res

    return rects, finalize


def interp_submatrix(geom: PSFGeometry, ovl_stack, x1, y1, img1, x2, y2, img2,
                     blk2grp1, blk2grp2, n_psf2: int,
                     flat_penalty: float, n_in_eff: float):
    """
    Evaluate a system submatrix block from an overlap stack.

    A[p, q] = Ovl[g1(p), g2(q)]((x1[p]-x2[q])/dscale, (y1[p]-y2[q])/dscale)
              - flat_penalty/n_in_eff + flat_penalty * [img1(p) == img2(q)]

    (reference PSFOvl._call_ii_cross / _call_ii_self, psfutil.py:1401-1732).

    x/y are positions in output pixels; img* are block-level image indices;
    blk2grp* map them to PSF slots.  Returns an (n1, n2) numpy array.
    """
    import jax.numpy as jnp

    from .ops.interp import interp2d_stack

    n1, n2 = len(x1), len(x2)
    if n1 == 0 or n2 == 0:
        return np.zeros((n1, n2))
    off = geom.nc_ovl + INTERP_PAD

    if _use_dense():
        rects, finalize = submatrix_rect_plan(
            geom, ovl_stack, img1, img2, blk2grp1, blk2grp2, n_psf2,
            flat_penalty, n_in_eff, 0, n1)
        vals = _interp_rects_dense(
            rects, np.concatenate([x1, x2]), np.concatenate([y1, y2]),
            1.0 / geom.dscale, off, geom.psfinterp)
        return finalize(vals)
    else:
        ddx = (x1[:, None] - x2[None, :]) / geom.dscale + off
        ddy = (y1[:, None] - y2[None, :]) / geom.dscale + off
        g1 = blk2grp1[img1]
        g2 = blk2grp2[img2]
        which = (g1[:, None] * n_psf2 + g2[None, :]).astype(np.int32)
        vals = interp2d_stack(ovl_stack, jnp.asarray(ddx.ravel()),
                              jnp.asarray(ddy.ravel()), jnp.asarray(which.ravel()),
                              geom.psfinterp)
        res = np.asarray(vals).reshape(n1, n2)

        if flat_penalty != 0.0:
            res = res - flat_penalty / n_in_eff
            res = res + flat_penalty * (img1[:, None] == img2[None, :])
        return res


def io_submatrix_rect_plan(geom: PSFGeometry, ovl_stack, img1, blk2grp1,
                           n_out: int, base1: int, out_base: int, m: int):
    """
    Rectangle plan for one input-output submatrix (dense path); see
    `submatrix_rect_plan`.  base1 locates the input pixels and out_base the
    m output-grid points in the sweep's coordinate tables.
    finalize(vals) returns (n_out, m, n1).
    """
    n1 = len(img1)
    rects = []
    slices = []
    for im1, s1, e1 in _image_runs(img1):
        for j_out in range(n_out):
            k = int(blk2grp1[im1]) * n_out + j_out
            rects.append((ovl_stack, k, base1 + s1, e1 - s1, out_base, m))
            slices.append((j_out, s1, e1))

    def finalize(vals):
        res = np.zeros((n_out, m, n1))
        for (j_out, s1, e1), v in zip(slices, vals):
            res[j_out, :, s1:e1] = v.reshape(e1 - s1, m).T
        return res

    return rects, finalize


def interp_io_submatrix(geom: PSFGeometry, ovl_stack, x1, y1, img1, blk2grp1,
                        out_x, out_y, n_out: int):
    """
    Input-output submatrix: overlap of each input pixel's PSF with each
    target PSF, evaluated at separations to the output grid points
    (reference PSFOvl._call_io_cross, psfutil.py:1497-1595).

    out_x, out_y : (m,) output pixel positions (integers on the block grid).
    Returns (n_out, m, n1).
    """
    import jax.numpy as jnp

    from .ops.interp import interp2d_stack

    n1 = len(x1)
    m = len(out_x)
    res = np.zeros((n_out, m, n1))
    if n1 == 0:
        return res
    off = geom.nc_ovl + INTERP_PAD

    if _use_dense():
        rects, finalize = io_submatrix_rect_plan(
            geom, ovl_stack, img1, blk2grp1, n_out, 0, n1, m)
        vals = _interp_rects_dense(
            rects, np.concatenate([x1, out_x]), np.concatenate([y1, out_y]),
            1.0 / geom.dscale, off, geom.psfinterp)
        return finalize(vals)

    ddx = (x1[:, None] - out_x[None, :]) / geom.dscale + off
    ddy = (y1[:, None] - out_y[None, :]) / geom.dscale + off
    g1 = blk2grp1[img1]
    for j_out in range(n_out):
        which = (g1[:, None] * n_out + j_out) * np.ones((1, m), dtype=np.int64)
        vals = interp2d_stack(ovl_stack, jnp.asarray(ddx.ravel()),
                              jnp.asarray(ddy.ravel()),
                              jnp.asarray(which.ravel().astype(np.int32)),
                              geom.psfinterp)
        res[j_out] = np.asarray(vals).reshape(n1, m).T
    return res
