"""
DFT-by-matmul overlap builder: the overlap spectra as f32 matrix products.

IMCOM needs the PSF overlap (cross-correlation) integrals to high ABSOLUTE
accuracy (the reference computes them with f64 FFTs, psfutil.py:1103-1152).
Here the transforms are dense DFT-matrix products at
``Precision.HIGHEST``: each output is one f32 dot product (no recursive
twiddle rounding), and the 1/nfft^2 inverse rescale shrinks the
accumulation error with it.  On an NVIDIA H100 80GB HBM3 at a 400 W power
limit, nfft=768, 8 unit-flux PSFs (64 pairs): max abs error 1.2e-9 against
the host f64 pipeline, 6.4 ms for spectra plus the pair stack; the
complex128 ``jnp.fft`` route on the same card is exact to 1e-18 in 3.7 ms,
and complex64 FFTs reach 9.2e-10 (chip_smoke.py).  Kept pending H100
measurement of its end-to-end effect (ROADMAP).

All entry points are jitted with static shapes; matrices are cached per
(nfft, dtype) and live in HBM.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=8)
def _dft_mats_np(nfft: int, dtype: str):
    k = np.arange(nfft)
    ang = -2.0 * np.pi * np.outer(k, k) / nfft
    return (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype))


def dft_matrices(nfft: int, dtype=jnp.float32):
    """(cos, sin) parts of the size-`nfft` DFT matrix as device arrays."""
    fr, fi = _dft_mats_np(nfft, np.dtype(dtype).name)
    return jnp.asarray(fr), jnp.asarray(fi)


@functools.partial(jax.jit, static_argnames=("nfft",))
def dft2_real(x: jnp.ndarray, nfft: int):
    """
    2D DFT of a real batch by matmul: x (B, n, n) zero-padded to
    (nfft, nfft); returns (Xr, Xi) each (B, nfft, nfft).

    The DFT matrix is symmetric, so X = F x F with F = Fr + i*Fi and a
    real x needs six real matmuls.
    """
    fr, fi = dft_matrices(nfft, x.dtype)
    b, ny, nx = x.shape
    x = jnp.pad(x, ((0, 0), (0, nfft - ny), (0, nfft - nx)))
    ar = jnp.einsum("ij,bjk->bik", fr, x, precision=_HI)
    ai = jnp.einsum("ij,bjk->bik", fi, x, precision=_HI)
    xr = jnp.einsum("bik,kj->bij", ar, fr, precision=_HI) \
        - jnp.einsum("bik,kj->bij", ai, fi, precision=_HI)
    xi = jnp.einsum("bik,kj->bij", ar, fi, precision=_HI) \
        + jnp.einsum("bik,kj->bij", ai, fr, precision=_HI)
    return xr, xi


@functools.lru_cache(maxsize=8)
def _dft_window_mats_np(nfft: int, novl: int, dtype: str):
    """Inverse-DFT matrices restricted to the rolled novl-window rows."""
    fr, fi = _dft_mats_np(nfft, dtype)
    nc = novl // 2
    idx = (np.arange(novl) - nc) % nfft
    return fr[idx, :].copy(), fi[idx, :].copy()


@functools.partial(jax.jit, static_argnames=("nfft", "novl", "pad"))
def overlap_from_spectra(x1r, x1i, x2r, x2i, nfft: int, novl: int,
                         pad: int = 0):
    """
    Cross-correlation images for every spectrum pair of two stacks.

    x1* : (n1, nfft, nfft), x2* : (n2, nfft, nfft) -- DFT spectra from
    :func:`dft2_real`.  Returns (n1*n2, novl+2*pad, novl+2*pad) with the
    zero lag at the (rolled) center, matching the host f64 path in
    psfgrp.build_overlap_stack.

    Only the rolled novl-window of the correlation is ever consumed, so
    the inverse transform contracts with (novl, nfft) window matrices
    instead of the full (nfft, nfft) DFT: 4*W*N^2 + 2*W^2*N FLOPs per
    pair instead of 6*N^3 (~2.3x fewer at production W/N ~ 0.5), and the
    roll+slice disappears.
    """
    wr_np, wi_np = _dft_window_mats_np(nfft, novl,
                                       np.dtype(x1r.dtype).name)
    wr, wi = jnp.asarray(wr_np), jnp.asarray(wi_np)
    # P = X1 * conj(X2), all pairs
    pr = x1r[:, None] * x2r[None, :] + x1i[:, None] * x2i[None, :]
    pi = x1i[:, None] * x2r[None, :] - x1r[:, None] * x2i[None, :]
    n1, n2 = pr.shape[:2]
    pr = pr.reshape(n1 * n2, nfft, nfft)
    pi = pi.reshape(n1 * n2, nfft, nfft)
    # inverse on the window: real( conj(W) P conj(W)^T ) / nfft^2
    br = jnp.einsum("ij,bjk->bik", wr, pr, precision=_HI) \
        + jnp.einsum("ij,bjk->bik", wi, pi, precision=_HI)
    bi = jnp.einsum("ij,bjk->bik", wr, pi, precision=_HI) \
        - jnp.einsum("ij,bjk->bik", wi, pr, precision=_HI)
    cr = jnp.einsum("bik,jk->bij", br, wr, precision=_HI) \
        + jnp.einsum("bik,jk->bij", bi, wi, precision=_HI)
    corr = cr / (nfft * nfft)
    if pad:
        corr = jnp.pad(corr, ((0, 0), (pad, pad), (pad, pad)))
    return corr


@functools.partial(jax.jit, static_argnames=("nfft",))
def zero_lag_from_spectra(xr, xi, nfft: int):
    """Zero-lag self-overlap per spectrum: mean of |X|^2 / nfft^2."""
    power = xr * xr + xi * xi
    return jnp.sum(power, axis=(-2, -1)) / (nfft * nfft)


def amp_penalty_multiplier(nfft: int, amp: float, sigma: float,
                           dtype=jnp.float32) -> jnp.ndarray:
    """
    Fourier-domain amplitude-penalty factor 1 + amp*exp(-2 pi^2 u^2 s^2)
    on the FULL (nfft, nfft) frequency grid (host path applies the same
    factor on the rfft half-grid; reference psfutil.py:1244-1256).
    """
    u2 = np.fft.fftfreq(nfft) ** 2
    ut2 = u2[:, None] + u2[None, :]
    mult = 1.0 + amp * np.exp(-2.0 * np.pi ** 2 * ut2 * sigma ** 2)
    return jnp.asarray(mult.astype(np.dtype(dtype)))
