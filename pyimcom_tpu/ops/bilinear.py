"""
Device (JAX) bilinear interpolation pair for destriping.

The reference destriper calls furry-parakeet's C
``bilinear_interpolation`` / ``bilinear_transpose`` (imdestripe.py:97-100,
996-1026) inside its conjugate-gradient loop.  These are the device-resident
equivalents: the forward op is a 4-tap gain-weighted gather, the transpose
is the exact adjoint scatter (``.at[].add``), so the CG dot-product test
holds to arithmetic precision.  Positions are precomputed per SCA pair and
reused across iterations, so only the image moves per call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _taps(xf, yf, nx: int, ny: int):
    x0 = jnp.floor(xf).astype(jnp.int32)
    y0 = jnp.floor(yf).astype(jnp.int32)
    inb = (x0 >= 0) & (x0 < nx - 1) & (y0 >= 0) & (y0 < ny - 1)
    x0c = jnp.clip(x0, 0, nx - 2)
    y0c = jnp.clip(y0, 0, ny - 2)
    fx = xf - x0c
    fy = yf - y0c
    return x0c, y0c, fx, fy, inb


@jax.jit
def bilinear_gather_device(image, xf, yf):
    """Plain 4-tap bilinear gather; out-of-bounds positions give 0."""
    ny, nx = image.shape
    x0, y0, fx, fy, inb = _taps(xf, yf, nx, ny)
    out = ((1 - fx) * (1 - fy) * image[y0, x0]
           + fx * (1 - fy) * image[y0, x0 + 1]
           + (1 - fx) * fy * image[y0 + 1, x0]
           + fx * fy * image[y0 + 1, x0 + 1])
    return jnp.where(inb, out, 0.0)


@jax.jit
def bilinear_gather_weighted_device(image, xf, yf, g_eff):
    """Gain-weighted normalized gather (furry-parakeet contract)."""
    ny, nx = image.shape
    x0, y0, fx, fy, inb = _taps(xf, yf, nx, ny)
    w = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    g = (g_eff[y0, x0], g_eff[y0, x0 + 1], g_eff[y0 + 1, x0],
         g_eff[y0 + 1, x0 + 1])
    v = (image[y0, x0], image[y0, x0 + 1], image[y0 + 1, x0],
         image[y0 + 1, x0 + 1])
    norm = sum(wi * gi for wi, gi in zip(w, g))
    norm = jnp.where(norm > 0, norm, 1.0)
    out = sum(wi * gi * vi for wi, gi, vi in zip(w, g, v)) / norm
    return jnp.where(inb, out, 0.0)


@functools.partial(jax.jit, static_argnames=("shape",))
def bilinear_scatter_adjoint_device(values, xf, yf, shape):
    """Exact adjoint of :func:`bilinear_gather_device`."""
    ny, nx = shape
    x0, y0, fx, fy, inb = _taps(xf, yf, nx, ny)
    v = jnp.where(inb, values, 0.0)
    out = jnp.zeros(shape, dtype=values.dtype)
    out = out.at[y0, x0].add(v * (1 - fx) * (1 - fy))
    out = out.at[y0, x0 + 1].add(v * fx * (1 - fy))
    out = out.at[y0 + 1, x0].add(v * (1 - fx) * fy)
    out = out.at[y0 + 1, x0 + 1].add(v * fx * fy)
    return out
