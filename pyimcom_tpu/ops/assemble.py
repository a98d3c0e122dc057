"""
Device-resident system-matrix assembly kernels.

The host-assembly path (coadd.Block._output_stamp) downloads every sweep
value, assembles A and -B/2 in numpy, and re-uploads ~40 MB per output
stamp.  These kernels keep the interpolated overlap values on device end
to end:

1. :func:`scatter_pool` -- sweep batch values -> a per-group "pool" buffer
   holding the freshly computed system submatrices (row-major, at planned
   base offsets).  The pool is the device twin of the reference's
   ref-counted SysMatA submatrix cache (reference psfutil.py:1764-2085).
2. :func:`pool_to_A` -- gather a submatrix region from a pool and
   scatter-add it into an output stamp's padded A matrix, applying the
   per-pixel selection through `selmap` (the device twin of the
   `sub[np.ix_(sel, sel)]` block placement, reference coadd.py:1028-1069)
   and the flat-field penalty addend (reference psfutil.py:1483-1486).
3. :func:`scatter_B` -- io-sweep values -> the (n_out, m, n_pad) -B/2
   tensor (reference coadd.py:1075-1082).
4. :func:`solve_finalize` -- f64 solve + trapezoid fade + coaddition +
   per-image weight sums, all on device; only the (tiny) per-stamp output
   maps return to the host (reference OutStamp._perform_coaddition,
   coadd.py:1294-1363).

All kernels take int32 metadata rows shaped (R, k); padded rows carry
nval = 0.  Out-of-selection targets are dropped via scatter mode="drop".
Index arithmetic happens on device so the host uploads only KB-scale
metadata.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BIG = jnp.iinfo(jnp.int32).max


@functools.partial(jax.jit, static_argnames=("bucket",), donate_argnums=(0,))
def scatter_pool(pool, vals, meta, bucket: int):
    """
    Scatter sweep batch values into the submatrix pool.

    pool : (P,) flat buffer (donated).
    vals : (R, bucket) sweep values.
    meta : (R, 5) int32 rows [dst_base0, w2, n2, off, nval] where
        dst_base0 = base + s1*n2 + s2 locates the rect's (0, 0) entry in the
        row-major (n1, n2) submatrix block at `base`; value j of the row
        lands at dst_base0 + ((off+j)//w2)*n2 + (off+j)%w2.  (The flat-field
        penalty addend is applied separately via
        :func:`scatter_pool_constant` when FLATPEN != 0.)
    """
    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    f = meta[:, 3:4] + j
    w2 = jnp.maximum(meta[:, 1:2], 1)
    dst = meta[:, 0:1] + (f // w2) * meta[:, 2:3] + f % w2
    valid = j < meta[:, 4:5]
    dst = jnp.where(valid, dst, _BIG)
    return pool.at[dst.ravel()].add(vals.ravel(), mode="drop")


@functools.partial(jax.jit, static_argnames=("bucket",), donate_argnums=(0,))
def scatter_pool_constant(pool, consts, meta, bucket: int):
    """Add a per-rect constant over rect regions of the pool (flat-field
    penalty terms: -FLATPEN/n_in_eff + FLATPEN on same-image rects;
    reference psfutil.py:1483-1486, 1704-1708).

    consts : (R,) addend per metadata row; meta as in :func:`scatter_pool`.
    """
    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    f = meta[:, 3:4] + j
    w2 = jnp.maximum(meta[:, 1:2], 1)
    dst = meta[:, 0:1] + (f // w2) * meta[:, 2:3] + f % w2
    valid = j < meta[:, 4:5]
    dst = jnp.where(valid, dst, _BIG)
    vals = jnp.broadcast_to(consts[:, None], dst.shape)
    return pool.at[dst.ravel()].add(vals.ravel(), mode="drop")


@functools.partial(jax.jit, static_argnames=("bucket", "n_pad"),
                   donate_argnums=(0,))
def pool_to_A(A, pool, meta, selmap, bucket: int, n_pad: int):
    """
    Gather a submatrix chunk from `pool` and scatter-add into A.

    A : (S*n_pad*n_pad,) flat stamp system matrices for the whole group
        (donated); a row's stamp is folded into its dstA_base column.
    pool : (P,) source pool (this group's, or a cached earlier group's).
    meta : (R, 7) int32 rows
        [src_off, w2, m1_off, m2_off, nval, flat_off, dstA_base]
        for one contiguous chunk of a row-major (n1, w2) submatrix block:
        value j reads pool[src_off + j] and corresponds to submatrix flat
        position f = flat_off + j, i.e. row f // w2 and column f % w2; it
        lands at A[dstA_base + selmap[m1_off + f//w2]*n_pad
                   + selmap[m2_off + f%w2]] where dstA_base = s_idx*n_pad^2.
    selmap : (L,) int32 -- concatenated per-(stamp, neighbor-instamp) local
        pixel index -> A slot maps (-1 for unselected pixels; dropped).
    """
    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    valid = j < meta[:, 4:5]
    f = meta[:, 5:6] + j
    w2 = jnp.maximum(meta[:, 1:2], 1)
    src = meta[:, 0:1] + j
    vals = pool[jnp.where(valid, src, 0)]
    s1 = selmap[jnp.where(valid, meta[:, 2:3] + f // w2, 0)]
    s2 = selmap[jnp.where(valid, meta[:, 3:4] + f % w2, 0)]
    dst = meta[:, 6:7] + s1 * n_pad + s2
    dst = jnp.where(valid & (s1 >= 0) & (s2 >= 0), dst, _BIG)
    return A.at[dst.ravel()].add(vals.ravel(), mode="drop")


@functools.partial(jax.jit,
                   static_argnames=("n1r", "n2r", "n_pad", "sym"),
                   donate_argnums=(0,))
def pool_to_A_mm(A, pool, uses, selmap, n1r: int, n2r: int, n_pad: int,
                 sym: bool):
    """
    Selection-matmul A assembly: matrix products replace the element
    scatter.

    :func:`pool_to_A` scatters every submatrix element through
    individually computed int32 destinations; at production volume
    (~1e9 elements/group) the index arithmetic alone materializes
    multi-GB int32 temporaries.  Here each submatrix use becomes two
    dense matmuls with one-hot selection operators:

        A[s] += P1ᵀ · sub · P2      (+ transpose when `sym`)

    where P1[r, a] = 1 iff selmap[m1_off + r] == a (likewise P2), i.e.
    exactly the ``sub[np.ix_(sel, sel)]`` block placement of the host
    path (reference coadd.py:1028-1069).  One-hot matmuls are EXACT at
    Precision.HIGHEST (full f32 operands, and each output element sums a
    single nonzero product), so this path is numerically identical to the
    scatter path up to f32 addition order.

    Requires the pool layout to be rung-padded: each submatrix stored
    with row stride n2r (>= its true n2) and n1r rows, padding zeros
    (the planner guarantees this; padded rows/columns multiply zeros).

    A : (S*n_pad*n_pad,) flat group stamp matrices (donated).
    pool : (P,) rung-padded source pool.
    uses : (U, 5) int32 rows [base, m1_off, m2_off, s_idx, valid].
    selmap : as in :func:`pool_to_A`; -1 entries produce all-zero
        one-hot rows (the unselected-pixel drop).
    """
    L = selmap.shape[0] - 1
    r = jnp.arange(n1r, dtype=jnp.int32)
    c = jnp.arange(n2r, dtype=jnp.int32)
    cols = jnp.arange(n_pad, dtype=jnp.int32)
    hi = jax.lax.Precision.HIGHEST

    def body(A_, u):
        base, m1, m2, s_idx, valid = u[0], u[1], u[2], u[3], u[4]
        sub = jax.lax.dynamic_slice(pool, (base,), (n1r * n2r,))
        sub = sub.reshape(n1r, n2r)
        s1 = selmap[jnp.minimum(m1 + r, L)]
        s2 = selmap[jnp.minimum(m2 + c, L)]
        P1 = (s1[:, None] == cols[None, :]).astype(pool.dtype)
        P2 = (s2[:, None] == cols[None, :]).astype(pool.dtype)
        SP = jnp.dot(sub, P2, precision=hi)               # (n1r, n_pad)
        contrib = jnp.dot(P1.T, SP, precision=hi)         # (n_pad, n_pad)
        if sym:
            contrib = contrib + contrib.T
        contrib = contrib * valid.astype(pool.dtype)
        A2 = A_.reshape(-1, n_pad * n_pad)
        return A2.at[s_idx].add(contrib.ravel()).ravel(), None

    A, _ = jax.lax.scan(body, A, uses)
    return A


@functools.partial(jax.jit, static_argnames=("n1r", "n2r", "NC", "sym"),
                   donate_argnums=(0,))
def pool_to_A_dus(canvas, pool, uses, selmap, n1r: int, n2r: int, NC: int,
                  sym: bool):
    """
    Contiguous-block A assembly: compact + dynamic-slice add.

    The stamp destinations of a submatrix placement are CONTIGUOUS slot
    ranges (the planner assigns `cumsum + arange` slots per instamp), so
    instead of :func:`pool_to_A_mm`'s two (n_pad-sized) selection matmuls
    plus an (n_pad, n_pad) accumulate per use, each use only

      1. compacts the selected rows/cols to the front of an (n1r, n2r)
         block with two SMALL one-hot matmuls (exact at HIGHEST -- each
         output element sums one nonzero product), then
      2. adds the block into a margin-padded canvas at its slot origin
         with dynamic_update_slice.

    FLOPs per use drop from 2*n1r*n2r*n_pad + 2*n1r*n_pad^2 to
    2*n1r^2*n2r + 2*n1r*n2r^2 (~27x at production shapes), and the
    per-use HBM traffic from ~2*n_pad^2 to ~2*n1r*n2r.

    canvas : (S, NC, NC) with NC >= n_pad + max(n1r, n2r); the live A is
        canvas[:, :n_pad, :n_pad] (:func:`canvas_to_A`); the margin absorbs
        the block writes of slot ranges near n_pad (their tails are zero).
    uses : (U, 7) int32 rows [base, m1_off, m2_off, s_idx, valid,
        dst1, dst2] -- dst = the slot range start of the instamp's rows /
        cols in this stamp.
    """
    r = jnp.arange(n1r, dtype=jnp.int32)
    c = jnp.arange(n2r, dtype=jnp.int32)
    L = selmap.shape[0] - 1
    hi = jax.lax.Precision.HIGHEST

    def body(cv, u):
        base, m1, m2, s_idx, valid, dst1, dst2 = (
            u[0], u[1], u[2], u[3], u[4], u[5], u[6])
        sub = jax.lax.dynamic_slice(
            pool, (base,), (n1r * n2r,)).reshape(n1r, n2r)
        t1 = selmap[jnp.minimum(m1 + r, L)] - dst1    # target-relative row
        t2 = selmap[jnp.minimum(m2 + c, L)] - dst2
        ohR = (t1[None, :] == r[:, None]).astype(pool.dtype)  # (tgt, src)
        ohC = (t2[:, None] == c[None, :]).astype(pool.dtype)  # (src, tgt)
        blk = jnp.dot(jnp.dot(ohR, sub, precision=hi), ohC, precision=hi)
        blk = blk * valid.astype(pool.dtype)
        cur = jax.lax.dynamic_slice(cv, (s_idx, dst1, dst2), (1, n1r, n2r))
        cv = jax.lax.dynamic_update_slice(cv, cur + blk[None],
                                          (s_idx, dst1, dst2))
        if sym:
            curT = jax.lax.dynamic_slice(cv, (s_idx, dst2, dst1),
                                         (1, n2r, n1r))
            cv = jax.lax.dynamic_update_slice(cv, curT + blk.T[None],
                                              (s_idx, dst2, dst1))
        return cv, None

    canvas, _ = jax.lax.scan(body, canvas, uses)
    return canvas


@functools.partial(jax.jit, static_argnames=("n_pad", "NC"))
def init_A_canvas(eye_scales, n_pad: int, NC: int):
    """Margin-padded canvas for :func:`pool_to_A_dus`: identity diagonal
    on the padded-slot convention, zero margin."""
    S = eye_scales.shape[0]
    cv = jnp.zeros((S, NC, NC), dtype=eye_scales.dtype)
    i = jnp.arange(n_pad)
    return cv.at[:, i, i].set(eye_scales)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def canvas_to_A(canvas, n_pad: int):
    """Extract the live flat A batch from the dus canvas."""
    S = canvas.shape[0]
    return jax.lax.slice(canvas, (0, 0, 0),
                         (S, n_pad, n_pad)).reshape(S * n_pad * n_pad)


@functools.partial(jax.jit, static_argnames=("bucket", "n_pad"),
                   donate_argnums=(0,))
def pool_to_A_sym(A, pool, meta, selmap, bucket: int, n_pad: int):
    """
    Like :func:`pool_to_A` but writes each value to BOTH (row, col) and
    (col, row) -- the off-diagonal block pairs of the host path
    (reference/coadd block layout: sub and sub.T, coadd.py:1057-1058).
    """
    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    valid = j < meta[:, 4:5]
    f = meta[:, 5:6] + j
    w2 = jnp.maximum(meta[:, 1:2], 1)
    src = meta[:, 0:1] + j
    vals = pool[jnp.where(valid, src, 0)]
    s1 = selmap[jnp.where(valid, meta[:, 2:3] + f // w2, 0)]
    s2 = selmap[jnp.where(valid, meta[:, 3:4] + f % w2, 0)]
    ok = valid & (s1 >= 0) & (s2 >= 0)
    dst1 = jnp.where(ok, meta[:, 6:7] + s1 * n_pad + s2, _BIG)
    dst2 = jnp.where(ok, meta[:, 6:7] + s2 * n_pad + s1, _BIG)
    A = A.at[dst1.ravel()].add(vals.ravel(), mode="drop")
    return A.at[dst2.ravel()].add(vals.ravel(), mode="drop")


@functools.partial(jax.jit,
                   static_argnames=("bucket", "kern", "n_pad", "m"),
                   donate_argnums=(0, 1))
def sweep_scatter_scan(pool, Bflat, combined, xt, yt, ks, imeta, pmeta,
                       bmeta, inv_scale, off_grid, bucket: int, kern: str,
                       n_pad: int, m: int):
    """
    The fused per-group sweep: interpolate every system-matrix /-B-tensor
    rectangle batch and scatter the values where they land, in ONE compiled
    program (a lax.scan over batches).

    Replaces a per-batch dispatch loop (jnp.take + interp + scatter_pool +
    scatter_B per batch, ~150 device calls per stamp): one program gives
    XLA the whole pipeline to fuse.

    pool : (P,) flat submatrix pool (donated).
    Bflat : (S*n_out*m*n_pad,) all stamps' -B/2 tensors, stamp-major
        (donated); a batch row's stamp/j_out fold into its bmeta dst_base.
    combined : (K, ny, nx) concatenated overlap stacks.
    xt, yt : (L,) f64 coordinate tables.
    ks : (NB, R) int32 image index per batch row.
    imeta : (NB, R, 5) interpolation metadata
        [i1_start, i2_start, w2, flat_off, nval] (interp2d_dense_pairs).
    pmeta : (NB, R, 5) pool-scatter metadata [dst_base0, w2, n2, off, nval]
        (scatter_pool rows); nval = 0 on rows that target B.
    bmeta : (NB, R, 4) B-scatter metadata [dst_base, col0, off, nval]
        (scatter_B rows); nval = 0 on rows that target the pool.
    """
    from .interp import interp2d_dense_pairs

    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]

    def body(carry, xs):
        pool_, B_ = carry
        ks_b, im_b, pm_b, bm_b = xs
        imgs = combined[ks_b]
        vals = interp2d_dense_pairs(imgs, xt, yt, im_b, inv_scale, off_grid,
                                    bucket, kern)
        # pool scatter
        f = pm_b[:, 3:4] + j
        w2 = jnp.maximum(pm_b[:, 1:2], 1)
        dst = pm_b[:, 0:1] + (f // w2) * pm_b[:, 2:3] + f % w2
        dst = jnp.where(j < pm_b[:, 4:5], dst, _BIG)
        pool_ = pool_.at[dst.ravel()].add(vals.ravel(), mode="drop")
        # B scatter
        fb = bm_b[:, 2:3] + j
        dstb = bm_b[:, 0:1] + (fb % m) * n_pad + bm_b[:, 1:2] + fb // m
        dstb = jnp.where(j < bm_b[:, 3:4], dstb, _BIG)
        B_ = B_.at[dstb.ravel()].add(vals.ravel(), mode="drop")
        return (pool_, B_), None

    (pool, Bflat), _ = jax.lax.scan(body, (pool, Bflat),
                                    (ks, imeta, pmeta, bmeta))
    return pool, Bflat


# ---------------------------------------------------------------------------
# v2 sweep: gather-free query formation
# ---------------------------------------------------------------------------
#
# The v1 sweep forms query positions with xt[i1]/xt[i2], f64 gathers over
# a ~39k-element table at ~100M queries/group.  The v2 kernels exploit the
# *structure* of the index patterns so no big-table gather remains:
#
# * pool rectangles (system submatrices): i1/i2 walk CONTIGUOUS runs, so a
#   256-wide dynamic_slice window covers every index of a piece (the
#   planner guarantees w2 <= 256 and piece <= 255*w2 queries).  Positions
#   are split into int cell + an f32 hi/lo PAIR for the fraction, and the
#   per-query values are selected from the window by one-hot matmuls
#   -- exact for the int part (cells < 2^24) and exact to the f64 ulp for
#   the fraction (hi + lo reconstructs the f64 fraction; each one-hot
#   product selects a single value with no rounding).
# * B rectangles (selected pixels x output grid): i2 cycles the whole
#   m-element output grid consecutively and i1 advances every m queries,
#   so both position streams are pure repeat/tile/slice constructions in
#   exact f64 -- no selection at all.
#
# Both were chosen for the gather costs of another accelerator and are kept
# pending H100 measurement (ROADMAP).

WQ = 256          # pool-rect window width (planner caps w2 and piece size)


def _win_tables(tabs, start):
    """(WQ, 6) f32 window [x_int, x_hi, x_lo, y_int, y_hi, y_lo]."""
    xt_i, xt_f, xt_l, yt_i, yt_f, yt_l = tabs
    return jnp.stack(
        [jax.lax.dynamic_slice(xt_i, (start,), (WQ,)).astype(jnp.float32),
         jax.lax.dynamic_slice(xt_f, (start,), (WQ,)),
         jax.lax.dynamic_slice(xt_l, (start,), (WQ,)),
         jax.lax.dynamic_slice(yt_i, (start,), (WQ,)).astype(jnp.float32),
         jax.lax.dynamic_slice(yt_f, (start,), (WQ,)),
         jax.lax.dynamic_slice(yt_l, (start,), (WQ,))], axis=1)


def split_tables(xt_np, yt_np):
    """Host-side split of f64 coordinate tables into the v2 sweep's
    [int32 cell, f32 fraction hi, f32 fraction lo] representation;
    int + (f64(hi) + f64(lo)) reconstructs the f64 position exactly to
    the ulp (|frac| < 1 so hi carries 24 bits, lo the next 24 -- more
    than the 52-bit mantissa of a sub-unit f64)."""
    import numpy as np

    out = []
    for t in (xt_np, yt_np):
        fl = np.floor(t)
        fr = t - fl
        hi = fr.astype(np.float32)
        lo = (fr - hi.astype(np.float64)).astype(np.float32)
        out += [fl.astype(np.int32), hi, lo]
    return out


@functools.partial(jax.jit,
                   static_argnames=("bucket", "kern"),
                   donate_argnums=(0,))
def sweep_pool_scan(pool, combined, xt_i, xt_f, xt_l, yt_i, yt_f, yt_l,
                    ks, imeta, pmeta, inv_scale, off_grid, bucket: int,
                    kern: str):
    """
    v2 fused sweep over POOL rectangles (same metadata contract as
    :func:`sweep_scatter_scan`'s imeta/pmeta, kind-0 rows only).

    Planner guarantees per piece: w2 <= WQ, and the index spans
    (off+nval-1)//w2 - off//w2 < WQ (piece size <= (WQ-1)*w2), so one
    WQ-wide window per side covers every query of the piece.
    """
    from .interp import interp2d_dense

    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    a = jnp.arange(WQ, dtype=jnp.int32)
    hi = jax.lax.Precision.HIGHEST

    def queries(im_b):
        def one(row):
            i1b, i2b, w2, off, nval = row[0], row[1], row[2], row[3], row[4]
            w2 = jnp.maximum(w2, 1)
            w1s = i1b + off // w2
            ph = off % w2
            tabs = (xt_i, xt_f, xt_l, yt_i, yt_f, yt_l)
            T1 = _win_tables(tabs, w1s)
            T2 = _win_tables(tabs, i2b)
            idx1 = (ph + j[0]) // w2 - ph // w2   # window-relative row
            idx2 = (ph + j[0]) % w2
            oh1 = (idx1[:, None] == a[None, :]).astype(jnp.float32)
            oh2 = (idx2[:, None] == a[None, :]).astype(jnp.float32)
            s1 = jnp.dot(oh1, T1, precision=hi)          # (bucket, 6)
            s2 = jnp.dot(oh2, T2, precision=hi)
            d = s1.astype(jnp.float64) - s2.astype(jnp.float64)
            dx = d[:, 0] + (d[:, 1] + d[:, 2])
            dy = d[:, 3] + (d[:, 4] + d[:, 5])
            valid = j[0] < nval
            qx = jnp.where(valid, dx * inv_scale + off_grid, -100.0)
            qy = jnp.where(valid, dy * inv_scale + off_grid, -100.0)
            return qx, qy
        return jax.vmap(one)(im_b)

    def body(pool_, xs):
        ks_b, im_b, pm_b = xs
        qx, qy = queries(im_b)
        imgs = combined[ks_b]
        vals = interp2d_dense(imgs, qx, qy, kern)
        f = pm_b[:, 3:4] + j
        w2 = jnp.maximum(pm_b[:, 1:2], 1)
        dst = pm_b[:, 0:1] + (f // w2) * pm_b[:, 2:3] + f % w2
        dst = jnp.where(j < pm_b[:, 4:5], dst, _BIG)
        pool_ = pool_.at[dst.ravel()].add(vals.ravel(), mode="drop")
        return pool_, None

    pool, _ = jax.lax.scan(body, pool, (ks, imeta, pmeta))
    return pool


@functools.partial(jax.jit,
                   static_argnames=("bucket", "kern", "n_pad", "m"),
                   donate_argnums=(0,))
def sweep_b_scan(Bflat, combined, xt, yt, ks, imeta, bmeta, inv_scale,
                 off_grid, bucket: int, kern: str, n_pad: int, m: int):
    """
    v2 fused sweep over B rectangles (selected pixels x output grid).

    Every B rect has w2 == m (the full output grid): i2 cycles
    i2_base..i2_base+m-1 and i1 advances once per cycle, so the position
    streams are exact-f64 repeat/tile/slice constructions -- zero gathers.
    imeta rows: [i1_base, i2_base, m, off, nval].
    """
    from .interp import interp2d_dense

    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    RW = bucket // m + 2                       # i1 values touched per piece
    reps = (bucket + m - 1) // m + 1

    def queries(im_b):
        def one(row):
            i1b, i2b, off, nval = row[0], row[1], row[3], row[4]
            w1s = i1b + off // m
            ph = off % m
            x1w = jax.lax.dynamic_slice(xt, (w1s,), (RW,))
            y1w = jax.lax.dynamic_slice(yt, (w1s,), (RW,))
            x2w = jax.lax.dynamic_slice(xt, (i2b,), (m,))
            y2w = jax.lax.dynamic_slice(yt, (i2b,), (m,))
            # seq1[t] = x1w[t // m]; seq2[t] = x2w[t % m]
            seq_x1 = jnp.repeat(x1w, m, total_repeat_length=RW * m)
            seq_y1 = jnp.repeat(y1w, m, total_repeat_length=RW * m)
            seq_x2 = jnp.tile(x2w, reps)
            seq_y2 = jnp.tile(y2w, reps)
            x1 = jax.lax.dynamic_slice(seq_x1, (ph,), (bucket,))
            y1 = jax.lax.dynamic_slice(seq_y1, (ph,), (bucket,))
            x2 = jax.lax.dynamic_slice(seq_x2, (ph,), (bucket,))
            y2 = jax.lax.dynamic_slice(seq_y2, (ph,), (bucket,))
            valid = j[0] < nval
            qx = jnp.where(valid, (x1 - x2) * inv_scale + off_grid, -100.0)
            qy = jnp.where(valid, (y1 - y2) * inv_scale + off_grid, -100.0)
            return qx, qy
        return jax.vmap(one)(im_b)

    def body(B_, xs):
        ks_b, im_b, bm_b = xs
        qx, qy = queries(im_b)
        imgs = combined[ks_b]
        vals = interp2d_dense(imgs, qx, qy, kern)
        fb = bm_b[:, 2:3] + j
        dstb = bm_b[:, 0:1] + (fb % m) * n_pad + bm_b[:, 1:2] + fb // m
        dstb = jnp.where(j < bm_b[:, 3:4], dstb, _BIG)
        B_ = B_.at[dstb.ravel()].add(vals.ravel(), mode="drop")
        return B_, None

    Bflat, _ = jax.lax.scan(body, Bflat, (ks, imeta, bmeta))
    return Bflat


SOLVE_MAP_N = 2048   # above this n_pad, batch solves sequentially (lax.map)


@functools.partial(
    jax.jit,
    static_argnames=("n2sq", "solver", "exact_UC", "maxiter"))
def solve_finalize_batch(A, mBhalf, C, kappaC, data, img_onehot, fade,
                         relevant, ucmin, smax, rtol, n2sq: int,
                         solver: str = "blocked", exact_UC: bool = True,
                         maxiter: int = 30):
    """
    Batch of :func:`solve_finalize` over the group's stamp axis: A (S, n,
    n), mBhalf (S, n_out, m, n), data (S, n_inframe, n), img_onehot (S, n,
    n_img), relevant (S, m, n) or (S, 1, 1).  One dispatch solves and
    coadds every stamp of the group; on a device mesh this is the batch
    axis that `parallel.mesh` shards (SURVEY.md section 2.2).

    Small systems vmap (one big fused program); above SOLVE_MAP_N the
    stamps run sequentially inside the same program with lax.map, which
    keeps the unbatched layouts and bounds temp memory to one stamp's
    working set (vmapping the blocked-Cholesky fori_loop at production
    sizes produced padded batch-minor layouts of A on the accelerator it
    was built for).  Kept pending H100 measurement (ROADMAP).
    """
    def one(A_, B_, d_, oh_, rel_):
        return solve_finalize(A_, B_, C, kappaC, d_, oh_, fade, rel_,
                              ucmin, smax, rtol, n2sq, solver, exact_UC,
                              maxiter)

    if A.shape[-1] > SOLVE_MAP_N:
        return jax.lax.map(lambda t: one(*t),
                           (A, mBhalf, data, img_onehot, relevant))
    return jax.vmap(one)(A, mBhalf, data, img_onehot, relevant)


@functools.partial(jax.jit, static_argnames=("bucket", "n_pad", "m"),
                   donate_argnums=(0,))
def scatter_B(B, vals, meta, bucket: int, n_pad: int, m: int):
    """
    Scatter io-sweep values into the flat -B/2 tensor.

    B : (n_out*m*n_pad,) flat (donated).
    vals : (R, bucket) sweep values for rects of shape (w1 input pixels, m
        output points), raveled row-major (input-pixel major).
    meta : (R, 4) int32 rows [dst_base, col0, off, nval] where
        dst_base = j_out*m*n_pad; value j (flat f = off + j) lands at
        dst_base + (f % m)*n_pad + col0 + f // m.
    """
    j = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    f = meta[:, 2:3] + j
    dst = meta[:, 0:1] + (f % m) * n_pad + meta[:, 1:2] + f // m
    valid = j < meta[:, 3:4]
    dst = jnp.where(valid, dst, _BIG)
    return B.at[dst.ravel()].add(vals.ravel(), mode="drop")


@functools.partial(
    jax.jit,
    static_argnames=("n2sq", "solver", "exact_UC", "maxiter"))
def solve_finalize(A, mBhalf, C, kappaC, data, img_onehot, fade, relevant,
                   ucmin, smax, rtol, n2sq: int, solver: str = "blocked",
                   exact_UC: bool = True, maxiter: int = 30):
    """
    Per-stamp solve + coaddition, fully on device.

    Parameters
    ----------
    A : (n_pad, n_pad) system matrix (assembly dtype; upcast to f64 here).
    mBhalf : (n_out, m, n_pad)
    C : (n_out,) ; kappaC : (nv,)
    data : (n_inframe, n_pad) input layer values (zero in padding).
    img_onehot : (n_pad, n_img) one-hot input-image membership (zero rows in
        padding).
    fade : (m,) trapezoid fade factors (1.0 when fade_kernel == 0).
    relevant : (m, n_pad) bool acceptance mask (Iterative solver only; pass
        a (1, 1) dummy otherwise).
    n2sq : static n2**2 normalization for the per-image stamp weights
        (reference coadd.py:1294-1353).
    solver : "blocked" (f64 blocked Cholesky; accelerators), "monolithic"
        (CPU),
        "mixed" (f32 factor + f64 refinement), or "iterative" (masked CG).

    Returns
    -------
    dict of device arrays:
      outimage (n_out, n_inframe, m), Tsum_stamp (n_out, n_img),
      Tsum_inpix (n_out, m), Neff (n_out, m),
      kappa, Sigma, UC (n_out, m)  -- fades applied where the host path
      applies them (T, kappa, Sigma, UC, Neff; reference coadd.py:1088-1122).
    """
    from ..solvers import (cholesky_solve, cholesky_solve_blocked,
                           cholesky_solve_mixed, iterative_solve)

    f64 = jnp.float64
    A64 = A.astype(f64)
    B64 = mBhalf.astype(f64)
    C64 = C.astype(f64)
    kC = kappaC.astype(f64)

    if solver == "blocked":
        T, kappa, Sigma, UC = cholesky_solve_blocked(A64, B64, C64, kC,
                                                     ucmin, smax)
    elif solver == "monolithic":
        T, kappa, Sigma, UC = cholesky_solve(A64, B64, C64, kC, ucmin, smax)
    elif solver == "mixed":
        T, kappa, Sigma, UC = cholesky_solve_mixed(A64, B64, C64, kC,
                                                   ucmin, smax)
    elif solver.startswith("eigen"):
        # "eigen" or "eigenN" (N = dense-kappa-grid node count; the string
        # is a static arg, so each N compiles its own program)
        from ..solvers import eigen_solve_device

        n_nodes = int(solver[5:]) if len(solver) > 5 else 9
        T, kappa, Sigma, UC = eigen_solve_device(A64, B64, C64, kC,
                                                 ucmin, smax, n_nodes)
    elif solver == "iterative":
        T, kappa, Sigma, UC = iterative_solve(
            A64, B64, C64, kC, relevant, rtol, ucmin, smax,
            maxiter=maxiter, exact_UC=exact_UC)
        # CG quality estimates can round below zero; clamp like the host
        # path does before the fade (coadd.py Iterative branch)
        UC = jnp.maximum(UC, 1e-32)
        Sigma = jnp.maximum(Sigma, 1e-32)
    else:
        raise ValueError(f"unknown solver {solver!r}")

    fade64 = fade.astype(f64)
    Tf = T * fade64[None, :, None]                           # (n_out, m, n)

    outimage = jnp.einsum("omn,fn->ofm", Tf, data.astype(f64))
    Tsum_image = jnp.einsum("omn,ni->omi", Tf, img_onehot.astype(f64))
    Tsum_stamp = jnp.sum(Tsum_image, axis=1) / n2sq          # (n_out, n_img)
    Tsum_inpix = jnp.sum(Tsum_image, axis=2)                 # (n_out, m)
    absum = jnp.sum(jnp.abs(Tsum_image), axis=2)
    Tnorm = Tsum_image / jnp.where(absum == 0, 1.0, absum)[:, :, None]
    sq = jnp.sum(Tnorm * Tnorm, axis=2)
    Neff = jnp.where(sq == 0, 0.0, 1.0 / jnp.where(sq == 0, 1.0, sq))

    f32 = jnp.float32
    return {
        "outimage": outimage.astype(f32),
        "Tsum_stamp": Tsum_stamp.astype(f32),
        "Tsum_inpix": Tsum_inpix.astype(f32),
        "Neff": (Neff * fade64[None, :]).astype(f32),
        "kappa": (kappa * fade64[None, :]).astype(f32),
        "Sigma": (Sigma * fade64[None, :]).astype(f32),
        "UC": (UC * fade64[None, :]).astype(f32),
    }


@functools.partial(jax.jit, static_argnames=("n_pad",))
def init_A(eye_scale, n_pad: int):
    """Fresh flat A buffer: identity diagonal (padding convention)."""
    i = jnp.arange(n_pad, dtype=jnp.int32)
    buf = jnp.zeros(n_pad * n_pad, dtype=eye_scale.dtype)
    return buf.at[i * n_pad + i].set(eye_scale)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def init_A_batch(eye_scales, n_pad: int):
    """(S, n_pad) diagonal scales -> (S*n_pad*n_pad,) flat group buffer."""
    S = eye_scales.shape[0]
    i = jnp.arange(n_pad, dtype=jnp.int32)
    buf = jnp.zeros((S, n_pad * n_pad), dtype=eye_scales.dtype)
    return buf.at[:, i * n_pad + i].set(eye_scales).ravel()


@jax.jit
def relevance_mask(out_x, out_y, in_x, in_y, rho):
    """(m, n_pad) acceptance mask: |out - in| < rho (Iterative kernel;
    reference lakernel.py:614-620).  Padded coordinates (1e6 sentinel)
    fall outside every acceptance radius."""
    return (jnp.hypot(out_y[:, None] - in_y[None, :],
                      out_x[:, None] - in_x[None, :]) < rho)


@functools.partial(jax.jit, donate_argnums=(0,))
def place_stack(buf, stk, off):
    """Copy one overlap stack into the combined buffer at row `off`.

    `off` is traced, so the compiled-program signature depends only on
    (buffer shape, stack shape) -- the per-group stack multiset never
    forces a recompile (coadd.Block._group_combined_stack)."""
    zero = jnp.zeros_like(off)
    return jax.lax.dynamic_update_slice(
        buf, stk.astype(buf.dtype), (off, zero, zero))


@functools.lru_cache(maxsize=None)
def _zeros3_fn(k: int, ny: int, nx: int, dtype_name: str, device):
    dtype = jnp.dtype(dtype_name)
    sh = jax.sharding.SingleDeviceSharding(device) if device is not None else None
    return jax.jit(lambda: jnp.zeros((k, ny, nx), dtype), out_shardings=sh)


def zeros3_on(k: int, ny: int, nx: int, dtype, device=None):
    """Allocate a (k, ny, nx) zero buffer directly on `device`."""
    return _zeros3_fn(int(k), int(ny), int(nx), jnp.dtype(dtype).name,
                      device)()


@functools.lru_cache(maxsize=None)
def _zeros_fn(n: int, dtype_name: str, device):
    dtype = jnp.dtype(dtype_name)
    sh = jax.sharding.SingleDeviceSharding(device) if device is not None else None
    return jax.jit(lambda: jnp.zeros((n,), dtype), out_shardings=sh)


def zeros_on(n: int, dtype, device=None):
    """Allocate a zero buffer directly on `device` (no host upload)."""
    return _zeros_fn(int(n), jnp.dtype(dtype).name, device)()
