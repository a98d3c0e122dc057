"""
High-accuracy separable polynomial interpolation kernels.

This is the JAX counterpart of the furry-parakeet C routines
``iD5512C`` / ``iD5512C_sym`` / ``gridD5512C`` (behavior pinned by the pure
Python mirrors in the reference repo, src/pyimcom/routine.py:29-338) and of
the faster 8x8-footprint ``iG4460C`` family (selected via the reference's
``PSFINTERP: "G4460"`` config key, reference psfutil.py:52-87).  The kernel
weights in each direction are a fixed odd-degree polynomial of the
fractional pixel phase, split into even/odd parts; interpolation is the
separable contraction  out = w_y^T P w_x  over the k x k pixel patch around
each query point.

Two kernel families are registered:

* ``D5512`` -- 10x10 footprint; the weight coefficients are the exact
  constants of the reference implementation (routine.py:46-122) and define
  numerical parity with it.
* ``G4460`` -- 8x8 footprint, faster.  furry-parakeet's C source for
  ``iG4460C`` is not available to pin bit-level parity, so this kernel is
  re-derived from the same design family as D5512: per-phase weights are the
  L2-optimal interpolator for band-limited signals (solve S w = r with
  S_jk = sinc(2 u0 (o_j - o_k)), r_k = sinc(2 u0 (fh - o_k)), u0 = 1/8,
  Tikhonov 1e-12), fit by an even/odd polynomial in the phase.  Measured
  worst-case tone error: <= 1.1e-6 for u <= 1/12 cycles/sample and
  <= 3.5e-6 for u <= 1/8 (vs D5512's 1e-8 at u <= 1/12) -- the documented
  "faster and may be sufficient" contract of the reference
  (docs/config_README.rst:189).

Formulation
-----------
Instead of the reference's per-point scalar loops, queries are processed as
batched tensors:

* weights:  powers-of-fh2 matrix (N,5) @ coefficient matrices (5,5) -> (N,10)
  (two small matmuls)
* patches:  one XLA gather of shape (N,10,10) from the source image
* contract: einsum('nij,ni,nj->n', patch, wy, wx)

Queries that fall off the valid grid region return 0, matching the reference
convention (routine.py:166).

All functions are jit-compatible and vmap-able; dtype follows the inputs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Degree-9 interpolation kernel coefficients (even/odd split), highest power
# first.  Row k gives weights w[k] and w[9-k]:
#   e_k = polyval(EVEN[k], fh^2),  o_k = polyval(ODD[k], fh^2) * fh
#   w[k] = e_k + o_k,  w[9-k] = e_k - o_k
# Numerical values are the D5512 kernel constants (reference routine.py:46-122);
# they define the interpolation scheme itself and are required for parity.
D5512_EVEN = np.array([
    [+1.651881673372979740e-05, -3.145538007199505447e-04, +1.793518183780194427e-03,
     -2.904014557029917318e-03, +6.187591260980151433e-04],
    [-1.146756217210629335e-04, +2.883845374976550142e-03, -1.857047531896089884e-02,
     +3.147734488597204311e-02, -6.753293626461192439e-03],
    [+3.256838096371517067e-04, -9.702063770653997568e-03, +8.678848026470635524e-02,
     -1.659182651092198924e-01, +3.620560878249733799e-02],
    [-4.541830837949564726e-04, +1.494862093737218955e-02, -1.668775957435094937e-01,
     +5.879306056792649171e-01, -1.367845996704077915e-01],
    [+2.266560930061513573e-04, -7.815848920941316502e-03, +9.686607348538181506e-02,
     -4.505856722239036105e-01, +6.067135256905490381e-01],
])
D5512_ODD = np.array([
    [-3.486978652054735998e-06, +6.753750285320532433e-05, -3.871378836550175566e-04,
     +6.279918076641771273e-04, -1.338434614116611838e-04],
    [+3.121412120355294799e-05, -8.040343683015897672e-04, +5.209574765466357636e-03,
     -8.847326408846412429e-03, +1.898674086370833597e-03],
    [-1.243658986204533102e-04, +3.804930695189636097e-03, -3.434861846914529643e-02,
     +6.581033749134083954e-02, -1.436476114189205733e-02],
    [+2.894406669584551734e-04, -9.794291009695265532e-03, +1.104231510875857830e-01,
     -3.906954914039130755e-01, +9.092432925988773451e-02],
    [-4.336085507644610966e-04, +1.537862263741893339e-02, -1.925091434770601628e-01,
     +8.993141455798455697e-01, -1.213035309579723942e+00],
])

# G4460: 8x8 footprint, L2-optimal band-limited design (u0 = 1/8, Tikhonov
# 1e-12, degree-9 even/odd polynomial fit; see module docstring).  Same row
# layout as D5512: row k gives taps w[k] and w[7-k].
G4460_EVEN = np.array([
    [-1.945235823911159925e-05, +1.055874006170703754e-03, -8.118995675262492134e-03,
     +1.453840359289597893e-02, -3.143522062829661335e-03],
    [+8.999088401166260235e-05, -5.148137838987351493e-03, +6.069481712095783216e-02,
     -1.235960532055178779e-01, +2.718540716184886588e-02],
    [-1.540666237308310749e-04, +9.123606051920359755e-03, -1.334507380042637137e-01,
     +5.336865231190287551e-01, -1.252224819511615628e-01],
    [+8.351472709485021652e-05, -5.031103870555608815e-03, +8.087359556892606549e-02,
     -4.246267565082386120e-01, +6.011801467479378491e-01],
])
G4460_ODD = np.array([
    [+7.260754694387638895e-06, -2.904202176384821071e-04, +2.238241587784505285e-03,
     -4.005111027206044276e-03, +8.423052633873124011e-04],
    [-4.631632696889089514e-05, +1.991059241797971720e-03, -2.378440273076087505e-02,
     +4.853753882315355733e-02, -1.053588105750352319e-02],
    [+1.308916996808606444e-04, -5.896228276277161624e-03, +8.761981577498251239e-02,
     -3.533315658835169404e-01, +8.255813013281140811e-02],
    [-2.118650110726590574e-04, +9.766034727710315444e-03, -1.596037936464457796e-01,
     +8.453409395243187685e-01, -1.200891120242346455e+00],
])

KERNEL_SIZE = 10
_LO = 4            # D5512 patch starts at xi - 4
_HI_MARGIN = 5     # valid iff xi <= ngx - 6, i.e. xi < ngx - 5

# registry: kern -> (EVEN, ODD, size, lo, hi_margin); patch spans
# [xi - lo, xi - lo + size), queries valid iff lo <= xi < ng - hi_margin
KERNEL_FAMILIES = {
    "D5512": (D5512_EVEN, D5512_ODD, 10, 4, 5),
    "G4460": (G4460_EVEN, G4460_ODD, 8, 3, 4),
}


def kernel_weights(fh: jnp.ndarray, kern: str = "D5512") -> jnp.ndarray:
    """
    Interpolation weights for fractional phase `fh` = x - floor(x) - 0.5.

    Parameters
    ----------
    fh : array, shape (...,)
    kern : "D5512" (10 taps) or "G4460" (8 taps); static.

    Returns
    -------
    array, shape (..., size)
    """
    even_np, odd_np, _size, _lo, _hi = KERNEL_FAMILIES[kern]
    dtype = jnp.result_type(fh, jnp.float32)
    even = jnp.asarray(even_np, dtype=dtype)
    odd = jnp.asarray(odd_np, dtype=dtype)
    fh2 = fh * fh
    # powers [fh2^4, fh2^3, fh2^2, fh2, 1]; the coefficient contractions are
    # matmuls and must run at HIGHEST (DEFAULT may round f32 operands, e.g.
    # to TF32 on the GPU)
    p = jnp.stack([fh2 ** 4, fh2 ** 3, fh2 ** 2, fh2, jnp.ones_like(fh2)], axis=-1)
    e = jnp.dot(p, even.T, precision=jax.lax.Precision.HIGHEST)
    o = jnp.dot(p, odd.T, precision=jax.lax.Precision.HIGHEST) * fh[..., None]
    return jnp.concatenate([e + o, (e - o)[..., ::-1]], axis=-1)


def d5512_weights(fh: jnp.ndarray) -> jnp.ndarray:
    """D5512 weights (back-compatible alias of :func:`kernel_weights`)."""
    return kernel_weights(fh, "D5512")


def _split_query(x, ng, kern: str = "D5512"):
    """Integer base index, fractional phase, and validity mask for queries."""
    _e, _o, _size, lo, hi = KERNEL_FAMILIES[kern]
    xi = jnp.floor(x).astype(jnp.int32)
    valid = (xi >= lo) & (xi < ng - hi)
    xi_safe = jnp.clip(xi, lo, ng - hi - 1)
    fh = x - xi.astype(x.dtype) - 0.5
    return xi_safe, fh, valid


@functools.partial(jax.jit, static_argnames=("kern",))
def interp2d(image: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
             kern: str = "D5512") -> jnp.ndarray:
    """
    Interpolate a single 2D image at scattered points.

    Parameters
    ----------
    image : (ny, nx)
    x, y  : (N,) query positions in pixel units.

    Returns
    -------
    (N,) interpolated values; 0 where the 10x10 patch would leave the grid.
    """
    _e, _o, size, lo, _hi = KERNEL_FAMILIES[kern]
    ny, nx = image.shape
    xi, fhx, vx = _split_query(x, nx, kern)
    yi, fhy, vy = _split_query(y, ny, kern)
    wx = kernel_weights(fhx, kern)  # (N, size)
    wy = kernel_weights(fhy, kern)
    offs = jnp.arange(size, dtype=jnp.int32) - lo
    iy = yi[:, None] + offs[None, :]             # (N, 10)
    ix = xi[:, None] + offs[None, :]             # (N, 10)
    flat = iy[:, :, None] * nx + ix[:, None, :]  # (N, 10, 10)
    patch = jnp.take(image.reshape(-1), flat, axis=0)
    out = jnp.einsum("nij,ni,nj->n", patch, wy, wx)
    return jnp.where(vx & vy, out, 0.0)


@functools.partial(jax.jit, static_argnames=("kern",))
def interp2d_multi(images: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                   kern: str = "D5512") -> jnp.ndarray:
    """
    Interpolate a stack of layers at the same scattered points.

    Equivalent of the reference iD5512C contract (routine.py:126-181).

    Parameters
    ----------
    images : (L, ny, nx) -- L layers sampled on the same grid.
    x, y   : (N,)

    Returns
    -------
    (L, N)
    """
    _e, _o, size, lo, _hi = KERNEL_FAMILIES[kern]
    L, ny, nx = images.shape
    xi, fhx, vx = _split_query(x, nx, kern)
    yi, fhy, vy = _split_query(y, ny, kern)
    wx = kernel_weights(fhx, kern)
    wy = kernel_weights(fhy, kern)
    offs = jnp.arange(size, dtype=jnp.int32) - lo
    iy = yi[:, None] + offs[None, :]
    ix = xi[:, None] + offs[None, :]
    flat = iy[:, :, None] * nx + ix[:, None, :]  # (N, 10, 10)
    patch = jnp.take(images.reshape(L, -1), flat, axis=1)  # (L, N, 10, 10)
    out = jnp.einsum("lnij,ni,nj->ln", patch, wy, wx)
    return jnp.where((vx & vy)[None, :], out, 0.0)


@functools.partial(jax.jit, static_argnames=("kern",))
def interp2d_stack(images: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                   which: jnp.ndarray, kern: str = "D5512") -> jnp.ndarray:
    """
    Interpolate where each query selects its own source image from a stack.

    This is the workhorse of system-matrix assembly: the overlap image used
    for a pixel pair depends on the (input image, input image) combination
    (cf. reference psfutil.py:1401-1495), so queries carry an image index.

    Parameters
    ----------
    images : (K, ny, nx)
    x, y   : (N,)
    which  : (N,) int32 -- index into the leading axis of `images`.

    Returns
    -------
    (N,)
    """
    _e, _o, size, lo, _hi = KERNEL_FAMILIES[kern]
    K, ny, nx = images.shape
    xi, fhx, vx = _split_query(x, nx, kern)
    yi, fhy, vy = _split_query(y, ny, kern)
    wx = kernel_weights(fhx, kern)
    wy = kernel_weights(fhy, kern)
    offs = jnp.arange(size, dtype=jnp.int32) - lo
    iy = yi[:, None] + offs[None, :]
    ix = xi[:, None] + offs[None, :]
    flat = (which[:, None, None] * (ny * nx)
            + iy[:, :, None] * nx + ix[:, None, :])  # (N, 10, 10)
    patch = jnp.take(images.reshape(-1), flat, axis=0)
    out = jnp.einsum("nij,ni,nj->n", patch, wy, wx)
    return jnp.where(vx & vy, out, 0.0)


@functools.partial(jax.jit, static_argnames=("kern",))
def grid_interp(image: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                kern: str = "D5512") -> jnp.ndarray:
    """
    Separable-grid interpolation: for each input pixel p, evaluate on the
    outer product grid (y[p, :], x[p, :]).

    Equivalent of the reference gridD5512C contract (routine.py:256-338).

    Parameters
    ----------
    image : (ny, nx)
    x : (P, nxo) -- x positions per input pixel.
    y : (P, nyo) -- y positions per input pixel.

    Returns
    -------
    (P, nyo, nxo)
    """
    _e, _o, size, lo, _hi = KERNEL_FAMILIES[kern]
    ny, nx = image.shape
    P, nxo = x.shape
    nyo = y.shape[1]
    xi, fhx, vx = _split_query(x, nx, kern)     # (P, nxo)
    yi, fhy, vy = _split_query(y, ny, kern)     # (P, nyo)
    wx = kernel_weights(fhx, kern) * vx[..., None]   # invalid -> zero weights
    wy = kernel_weights(fhy, kern) * vy[..., None]
    offs = jnp.arange(size, dtype=jnp.int32) - lo

    # stage 1: contract rows.  gather rows (P, nyo, 10, nx) is large; instead
    # gather 10x10 patches on the meshed grid (P, nyo, nxo, 10, 10) would be
    # larger still.  Use the two-stage separable contraction with a row gather
    # restricted to the 10-column band union via full-row einsum:
    #   H[p, yo, :] = sum_i wy[p, yo, i] * image[yi[p,yo]+i-4, :]
    iy = yi[:, :, None] + offs[None, None, :]   # (P, nyo, 10)
    rows = jnp.take(image, iy, axis=0)          # (P, nyo, 10, nx)
    H = jnp.einsum("pyin,pyi->pyn", rows, wy)   # (P, nyo, nx)
    # stage 2: contract columns with per-(p, xo) 10-column bands
    ix = xi[:, :, None] + offs[None, None, :]                      # (P, nxo, 10)
    idx = jnp.broadcast_to(ix.reshape(P, 1, nxo * size),
                           (P, nyo, nxo * size))
    cols = jnp.take_along_axis(H, idx, axis=-1).reshape(P, nyo, nxo, size)
    out = jnp.einsum("pyxj,pxj->pyx", cols, wx)
    return out


# --------------------------------------------------------------------------
# Gather-free formulation (the accelerator default).
#
# Each query's 10 kernel taps expand into a banded row of a dense (N, ncol)
# weight matrix built from vectorized compares; the row interpolation is an
# (N, ncol) x (ncol, ncol) matrix product and the column contraction an
# elementwise multiply-reduce.  No gathers or scatters.  Kept pending H100
# measurement against the gather form the CPU path uses (ROADMAP).
# --------------------------------------------------------------------------


def _banded_weights(x, ncol: int, dtype=None, kern: str = "D5512"):
    """
    Dense banded D5512 weight matrix.

    W[..., q, c] = weight of source column c for query position x[..., q]
    (zero outside the 10-tap support); plus the validity mask.

    x : (..., Nq) absolute positions in [0, ncol).  The integer/fractional
    split happens in x's own dtype (pass f64 positions for full placement
    accuracy), then the weights are built in `dtype` (default: x's dtype).
    Returns (W (..., Nq, ncol), valid (..., Nq)).
    """
    _e, _o, size, lo, hi = KERNEL_FAMILIES[kern]
    dtype = dtype or x.dtype
    xi = jnp.floor(x).astype(jnp.int32)
    valid = (xi >= lo) & (xi < ncol - hi)
    fh = (x - xi.astype(x.dtype) - 0.5).astype(dtype)
    w10 = kernel_weights(fh, kern)                # (..., Nq, size)
    c = jnp.arange(ncol, dtype=jnp.int32)
    k = c - xi[..., None] + lo                    # (..., Nq, ncol) tap index
    W = jnp.zeros(x.shape + (ncol,), dtype=dtype)
    for tap in range(size):
        W = W + jnp.where(k == tap, w10[..., tap:tap + 1], 0.0)
    return W, valid


@functools.partial(jax.jit, static_argnames=("kern",))
def interp2d_dense(images: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                   kern: str = "D5512") -> jnp.ndarray:
    """
    Gather-free interpolation of a batch of images at per-image query sets.

    Parameters
    ----------
    images : (R, ny, nx) -- one source image per rectangle of queries.
    x, y : (R, Nq) query positions.

    Returns
    -------
    (R, Nq); 0 where the 10x10 patch would leave the grid (same convention
    as :func:`interp2d`).
    """
    R, ny, nx = images.shape
    Wy, vy = _banded_weights(y, ny, dtype=images.dtype, kern=kern)   # (R, Nq, ny)
    Wx, vx = _banded_weights(x, nx, dtype=images.dtype, kern=kern)   # (R, Nq, nx)
    # row interpolation as a matrix product; HIGHEST precision is essential:
    # a reduced-precision f32 product (TF32 keeps 10 mantissa bits) would
    # corrupt the system matrices
    G = jnp.einsum("rqn,rnc->rqc", Wy, images,
                   preferred_element_type=images.dtype,
                   precision=jax.lax.Precision.HIGHEST)            # (R, Nq, nx)
    out = jnp.sum(G * Wx, axis=-1)
    return jnp.where(vx & vy, out, 0.0)


@functools.partial(jax.jit, static_argnames=("bucket", "kern"))
def interp2d_dense_pairs(images: jnp.ndarray, xt: jnp.ndarray, yt: jnp.ndarray,
                         meta: jnp.ndarray, inv_scale, off_grid,
                         bucket: int, kern: str = "D5512") -> jnp.ndarray:
    """
    Gather-free interpolation at implicit outer-difference queries.

    The system-matrix queries are separations between pixel positions:
    rect (p, q) evaluates at ((x1[p] - x2[q]) * inv_scale + off_grid, ...).
    Uploading those raveled grids costs O(n^2) host->device bandwidth
    (~75 MB per output stamp); this kernel instead
    takes the coordinate TABLES (a few KB) and forms the grids on device.

    images : (R, ny, nx) source image per query row.
    xt, yt : (L,) coordinate tables (f64 for exact phase extraction).
    meta : (R, 5) int32 rows [i1_start, i2_start, w2, flat_off, n_valid];
        query j of row r sits at flat index f = flat_off + j of a
        row-major (w1, w2) rectangle: i1 = i1_start + f // w2,
        i2 = i2_start + f % w2.  Entries past n_valid return 0.
    bucket : static query count per row.

    Returns (R, bucket) interpolated values, 0 where invalid/off-grid.
    """
    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    f = meta[:, 3:4] + j
    w2 = jnp.maximum(meta[:, 2:3], 1)
    i1 = meta[:, 0:1] + f // w2
    i2 = meta[:, 1:2] + f % w2
    valid = j < meta[:, 4:5]
    i1 = jnp.where(valid, i1, 0)
    i2 = jnp.where(valid, i2, 0)
    qx = jnp.where(valid, (xt[i1] - xt[i2]) * inv_scale + off_grid, -100.0)
    qy = jnp.where(valid, (yt[i1] - yt[i2]) * inv_scale + off_grid, -100.0)
    return interp2d_dense(images, qx, qy, kern)


@functools.partial(jax.jit, static_argnames=("kern",))
def grid_interp_dense(image: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                      kern: str = "D5512") -> jnp.ndarray:
    """
    Gather-free separable-grid interpolation (same contract as
    :func:`grid_interp`): image (ny, nx), x (P, nxo), y (P, nyo) ->
    (P, nyo, nxo).
    """
    ny, nx = image.shape
    Wy, vy = _banded_weights(y, ny, dtype=image.dtype, kern=kern)    # (P, nyo, ny)
    Wx, vx = _banded_weights(x, nx, dtype=image.dtype, kern=kern)    # (P, nxo, nx)
    H = jnp.einsum("pyn,nc->pyc", Wy, image,
                   preferred_element_type=image.dtype,
                   precision=jax.lax.Precision.HIGHEST)   # (P, nyo, nx)
    out = jnp.einsum("pyc,pxc->pyx", H, Wx,
                     precision=jax.lax.Precision.HIGHEST)
    return out * (vy[:, :, None] & vx[:, None, :])


# --------------------------------------------------------------------------
# NumPy reference implementation (host-side; used in tests and as the
# CPU baseline proxy for benchmarking).
# --------------------------------------------------------------------------

def kernel_weights_np(fh: np.ndarray, kern: str = "D5512") -> np.ndarray:
    """NumPy twin of :func:`kernel_weights`."""
    even, odd, _size, _lo, _hi = KERNEL_FAMILIES[kern]
    fh = np.asarray(fh, dtype=np.float64)
    fh2 = fh * fh
    p = np.stack([fh2 ** 4, fh2 ** 3, fh2 ** 2, fh2, np.ones_like(fh2)], axis=-1)
    e = p @ even.T
    o = (p @ odd.T) * fh[..., None]
    return np.concatenate([e + o, (e - o)[..., ::-1]], axis=-1)


def d5512_weights_np(fh: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`d5512_weights`."""
    return kernel_weights_np(fh, "D5512")


def interp2d_np(image: np.ndarray, x: np.ndarray, y: np.ndarray,
                kern: str = "D5512") -> np.ndarray:
    """NumPy twin of :func:`interp2d` (vectorized gather + einsum).

    Routed through the native C++ kernel when it compiled on this host
    (pyimcom_tpu.native; ~10x on one core because the (N, size, size)
    patch temporary never materializes) -- this is the hot host loop of
    batched PSF sampling (psfgrp.sample_psf_rotated_batch host mode).
    """
    from .. import native

    if native.available():
        return native.interp2d_multi(
            np.asarray(image, dtype=np.float64), x, y, kern)[0]
    _e, _o, size, lo, hi = KERNEL_FAMILIES[kern]
    image = np.asarray(image, dtype=np.float64)
    ny, nx = image.shape
    xi = np.floor(x).astype(np.int64)
    yi = np.floor(y).astype(np.int64)
    valid = (xi >= lo) & (xi < nx - hi) & (yi >= lo) & (yi < ny - hi)
    xi_s = np.clip(xi, lo, nx - hi - 1)
    yi_s = np.clip(yi, lo, ny - hi - 1)
    wx = kernel_weights_np(x - xi - 0.5, kern)
    wy = kernel_weights_np(y - yi - 0.5, kern)
    offs = np.arange(size) - lo
    patch = image[(yi_s[:, None, None] + offs[None, :, None]),
                  (xi_s[:, None, None] + offs[None, None, :])]
    out = np.einsum("nij,ni,nj->n", patch, wy, wx)
    return np.where(valid, out, 0.0)
