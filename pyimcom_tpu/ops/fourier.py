"""
Fourier-domain PSF overlap engine (device-side).

The IMCOM system matrices are built from cross-correlations of sampled PSFs
(Rowe+ 2011 eqs. 17-18; reference implementation psfutil.py:942-986 and
1177-1295).  These are batched jnp.fft transforms, used on the CPU backend
(accelerators take ops/dftmm.py):

* :func:`pad_and_rfft2` -- zero-pad sampled PSFs to the FFT grid and rfft2.
* :func:`overlap_from_rft` -- multiply spectra, inverse transform, and
  extract the centered correlation window:
      ovl[..., nc+dy, nc+dx] = sum_{y,x} psf1[y+dy, x+dx] * psf2[y, x]
  for |dy|, |dx| <= nc, exact because nfft >= 2*nsamp.

The reference's staged "accel" FFT tricks (psfutil.py:942,1177) are CPU FFT
optimizations; XLA fuses the equivalent work, so the direct formulation is
used here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("nfft",))
def pad_and_rfft2(psf_arr: jnp.ndarray, nfft: int) -> jnp.ndarray:
    """
    Zero-pad (..., nsamp, nsamp) PSFs into an (nfft, nfft) frame (corner
    anchored) and return the 2D real FFT, shape (..., nfft, nfft//2+1).
    """
    nsamp = psf_arr.shape[-1]
    pad = [(0, 0)] * (psf_arr.ndim - 2) + [(0, nfft - nsamp), (0, nfft - nsamp)]
    return jnp.fft.rfft2(jnp.pad(psf_arr, pad))


@functools.partial(jax.jit, static_argnames=("nsamp_out", "nfft"))
def overlap_from_rft(rft1: jnp.ndarray, rft2: jnp.ndarray,
                     nsamp_out: int, nfft: int) -> jnp.ndarray:
    """
    Cross-correlation overlap array from two PSF spectra.

    Parameters
    ----------
    rft1, rft2 : (..., nfft, nfft//2+1) rfft2 spectra (broadcastable).
    nsamp_out : output window size (odd; = 2*nc+1).
    nfft : FFT grid size.

    Returns
    -------
    (..., nsamp_out, nsamp_out) with the zero-lag value at the center
    (nc, nc), nc = nsamp_out // 2.
    """
    nc = nsamp_out // 2
    corr = jnp.fft.irfft2(rft1 * jnp.conj(rft2), s=(nfft, nfft))
    corr = jnp.roll(corr, (nc, nc), axis=(-2, -1))
    return corr[..., :nsamp_out, :nsamp_out]


def apply_amp_penalty(rft: jnp.ndarray, nfft: int, amp: float,
                      sigma_eff: float) -> jnp.ndarray:
    """
    Re-weight Fourier modes of a PSF spectrum:  multiply by
    1 + amp * exp(-2 pi^2 u^2 sigma_eff^2)  (cf. reference psfutil.py:661-671).
    `sigma_eff` is in samples (config amp_penalty[1] * oversamp).
    """
    u = jnp.fft.fftfreq(nfft)
    u2 = u ** 2
    ut2 = u2[:, None] + u2[None, : nfft // 2 + 1]
    return rft * (1.0 + amp * jnp.exp(-2.0 * jnp.pi ** 2 * ut2 * sigma_eff ** 2))
