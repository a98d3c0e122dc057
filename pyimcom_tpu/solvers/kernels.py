"""
Linear-algebra kernels for the IMCOM coaddition matrix T.

Given the per-stamp system
    A        : (n, n)        input-input PSF overlap (sym. positive semidef.)
    -B/2     : (n_out, m, n) input-target overlaps ("mBhalf")
    C        : (n_out,)      target self-overlap at zero lag
solve for T(kappa) = (A + kappa I)^{-1} (-B/2) with the Lagrange multiplier
kappa chosen per output pixel to hit a leakage target U/C <= ucmin subject to
a noise bound Sigma <= smax, and report the quality maps (U/C, Sigma, kappa).

Four strategies, matching the reference PyIMCOM kernel families
(src/pyimcom/lakernel.py:141,226,533,747 and the C contracts mirrored in
src/pyimcom/routine.py:341-588):

* :func:`eigen_solve`     -- eigendecomposition; per-pixel kappa bisection.
* :func:`cholesky_solve`  -- Cholesky at each kappa node + node-weight solve.
* :func:`iterative_solve` -- masked conjugate gradient per output pixel.
* :func:`empirical_weights` -- distance-weighted T without solving.

Formulation: everything is batched over output pixels (and kappa nodes) as
dense tensor ops under jit -- eigh/cholesky factorizations, kappa
bisections as vectorized lax.fori loops, and the masked CG runs all m
subsystems simultaneously as (m, n) x (n, n) matmuls instead of the
reference's per-pixel submatrix extraction.

Padding convention: callers may zero-pad n.  Pad A with 1 on the diagonal
(0 off-diagonal) and mBhalf with zero columns; padded coordinates then carry
exactly zero weight through every kernel, so bucketed shapes compile once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, cholesky


def _safe_cholesky(AA: jnp.ndarray, A: jnp.ndarray) -> jnp.ndarray:
    """
    Cholesky with negative-eigenvalue repair.

    If AA is not numerically positive definite (the factorization produces
    non-finite entries), shift the diagonal by |lambda_min| + 1e-16 of the
    un-regularized A and refactor -- the same repair as the reference
    (lakernel.py:241-279) without exceptions, as a jit-compatible branch.
    """
    L = cholesky(AA, lower=True)
    ok = jnp.all(jnp.isfinite(L))

    def repair(_):
        w = jnp.linalg.eigvalsh(A)
        shift = jnp.abs(w[0]) + 1e-16
        return cholesky(AA + shift * jnp.eye(AA.shape[0], dtype=AA.dtype), lower=True)

    return jax.lax.cond(ok, lambda L_: L_, lambda L_: repair(None), L)


# ---------------------------------------------------------------------------
# Eigendecomposition kernel
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("nbis",))
def eigen_solve(A, mBhalf, C, kappaC, ucmin, smax, nbis: int = 13):
    """
    Eigendecomposition kernel.

    Parameters
    ----------
    A : (n, n); mBhalf : (n_out, m, n); C : (n_out,)
    kappaC : (nv,) ascending kappa/C nodes.  nv == 1 selects the fixed-kappa
        path; nv > 1 runs the per-pixel bisection between the end nodes.
    nbis : bisection count (static).

    Returns
    -------
    T : (n_out, m, n); kappa, Sigma, UC : (n_out, m)
    """
    nv = kappaC.shape[0]
    lam, Q = jnp.linalg.eigh(A)
    mPhalf = jnp.einsum("omn,nk->omk", mBhalf, Q)  # (n_out, m, n) in eigenbasis

    if nv == 1:
        my_kappa = kappaC[0] * C  # (n_out,)
        denom = lam[None, None, :] + my_kappa[:, None, None]
        var = mPhalf / denom
        Sigma = jnp.sum(var ** 2, axis=-1)
        UC = 1.0 - jnp.sum((lam[None, None, :] + 2.0 * my_kappa[:, None, None]) * var ** 2,
                           axis=-1) / C[:, None]
        T = jnp.einsum("omk,nk->omn", var, Q)
        kappa = jnp.broadcast_to(my_kappa[:, None], UC.shape)
        return T, kappa, Sigma, UC

    # multi-kappa: per-pixel geometric bisection in the eigenbasis
    # (contract of reference routine.py:341-430, vectorized over all pixels)
    kCmin = kappaC[0] * C   # (n_out,)
    kCmax = kappaC[-1] * C

    kap0 = jnp.sqrt(kCmax * kCmin)[:, None] * jnp.ones_like(mPhalf[:, :, 0])
    factor0 = jnp.sqrt(kCmax / kCmin)[:, None] * jnp.ones_like(kap0)

    def body(_, state):
        kap, factor = state
        var = mPhalf / (lam[None, None, :] + kap[..., None])
        sum2 = jnp.sum(var * var, axis=-1)
        sum_ = jnp.sum((lam[None, None, :] + 2.0 * kap[..., None]) * var * var, axis=-1)
        udc = 1.0 - sum_ / C[:, None]
        factor = jnp.sqrt(factor)
        shrink = (udc > ucmin) & (sum2 < smax)
        kap = kap * jnp.where(shrink, 1.0 / factor, factor)
        return kap, factor

    kap, _ = jax.lax.fori_loop(0, nbis, body, (kap0, factor0))

    var = mPhalf / (lam[None, None, :] + kap[..., None])
    Sigma = jnp.sum(var * var, axis=-1)
    UC = 1.0 - jnp.sum((lam[None, None, :] + 2.0 * kap[..., None]) * var * var,
                       axis=-1) / C[:, None]
    T = jnp.einsum("omk,nk->omn", var, Q)
    # NOTE: the reference multiplies the reported kappa map by C once more on
    # this path (lakernel.py:222); reproduced for output parity.
    kappa = kap * C[:, None]
    return T, kappa, Sigma, UC


# ---------------------------------------------------------------------------
# Node-weight machinery shared by the Cholesky and iterative kernels
# ---------------------------------------------------------------------------

def _node_cross_products(A, mBhalf_j, Tpi, kappa_arr, exact_E: bool):
    """D_p, N_pq, E_pq at the kappa nodes for one target PSF.

    E_pq = T_p^T A T_q; the cheap form uses A T_q = mBhalf - kappa_q T_q
    (evaluated as D_q - kappa_p N_pq on the symmetrized triangle, matching
    reference lakernel.py:362-368), the exact form contracts through A.
    """
    nv = Tpi.shape[0]
    Dp = jnp.einsum("ai,pai->ap", mBhalf_j, Tpi)            # (m, nv)
    Npq = jnp.einsum("pai,qai->apq", Tpi, Tpi)              # (m, nv, nv)
    if exact_E:
        ATq = jnp.einsum("ij,qaj->qai", A, Tpi)
        Epq = jnp.einsum("pai,qai->apq", Tpi, ATq)
        Epq = 0.5 * (Epq + jnp.swapaxes(Epq, -1, -2))
    else:
        P = jnp.arange(nv)[:, None]
        Qi = jnp.arange(nv)[None, :]
        lo = jnp.minimum(P, Qi)
        hi = jnp.maximum(P, Qi)
        Epq = Dp[:, lo] - kappa_arr[hi][None, :, :] * Npq
    return Dp, Npq, Epq


def _reduced_T_weights(Npq, DoverC, EoverC, nodes, ucmin, smax, niter: int = 12):
    """
    Per-pixel kappa-interval search and node-weight solve.

    Vectorized contract of reference routine.py:487-588: pick the kappa
    interval from the diagonal node quality values, then run `niter`
    geometric refinement steps, each solving the nv x nv system
    (E/C + kappa N) w = D/C for all m pixels at once.

    Returns (kappa, Sigma, UC, w) with shapes (m,), (m,), (m,), (m, nv).
    """
    m, nv = DoverC.shape
    dtype = DoverC.dtype

    S_diag = jnp.diagonal(Npq, axis1=-2, axis2=-1)            # (m, nv)
    UC_diag = 1.0 - 2.0 * DoverC + jnp.diagonal(EoverC, axis1=-2, axis2=-1)

    # interval lower node: the walk from iv=nv-2 downward stops at the first
    # node where the quality target is already met (UC<=ucmin) or the noise
    # bound is violated (S>=smax); otherwise ends at 0.
    stop = (UC_diag[:, : nv - 1] <= ucmin) | (S_diag[:, : nv - 1] >= smax)
    iv = jnp.max(jnp.where(stop, jnp.arange(nv - 1)[None, :], 0), axis=-1)   # (m,)

    kappamid = jnp.sqrt(nodes[iv] * nodes[iv + 1])
    factor = (nodes[iv + 1] / nodes[iv]) ** 0.25

    eye = jnp.eye(nv, dtype=dtype)

    def body(_, state):
        kappamid, factor, _w, _S, _UC = state
        M = EoverC + kappamid[:, None, None] * Npq            # (m, nv, nv)
        # tiny SPD solves, batched over pixels.  Closely spaced kappa nodes
        # give near-duplicate T_p columns and a numerically singular M
        # (dense-grid eigen emulation at >~10 nodes): a 1e-11-relative
        # Tikhonov diagonal keeps the factorization finite while perturbing
        # well-separated node weights far below the kernel tolerances.
        diag = jnp.abs(jnp.diagonal(M, axis1=-2, axis2=-1)).mean(axis=-1)
        L = cholesky(M + (1e-11 * diag)[:, None, None] * eye, lower=True)
        w = cho_solve((L, True), DoverC[..., None])[..., 0]   # (m, nv)
        S = jnp.einsum("ap,apq,aq->a", w, Npq, w)
        UC = 1.0 - kappamid * S - jnp.einsum("ap,ap->a", DoverC, w)
        ok = (UC > ucmin) & (S < smax)
        kappamid = kappamid * jnp.where(ok, 1.0 / factor, factor)
        factor = jnp.sqrt(factor)
        return kappamid, factor, w, S, UC

    # derive the initial carry from the inputs (not fresh constants) so the
    # loop stays valid under shard_map's varying-axis type system
    w0 = DoverC * 0.0
    S0 = DoverC[:, 0] * 0.0
    UC0 = DoverC[:, 0] * 0.0
    kappamid, _, w, S, UC = jax.lax.fori_loop(0, niter, body,
                                              (kappamid, factor, w0, S0, UC0))
    # kappa reported after the final update step, S/UC/w from the final solve
    # (matching the reference loop structure, routine.py:560-588)
    return kappamid, S, UC, w


# ---------------------------------------------------------------------------
# Cholesky kernel
# ---------------------------------------------------------------------------

@jax.jit
def cholesky_solve(A, mBhalf, C, kappaC, ucmin, smax):
    """
    Cholesky kernel: factor A + kappa I at each kappa node, solve for the
    node T matrices, then blend per pixel with the node-weight search.

    Shapes as in :func:`eigen_solve`; returns (T, kappa, Sigma, UC).
    """
    n = A.shape[0]
    nv = kappaC.shape[0]
    n_out = C.shape[0]
    eye = jnp.eye(n, dtype=A.dtype)

    def solve_one_output(j):
        kappa_arr = kappaC * C[j]                            # (nv,)
        mb = mBhalf[j]                                       # (m, n)

        def node_solve(kap):
            L = _safe_cholesky(A + kap * eye, A)
            return cho_solve((L, True), mb.T).T              # (m, n)

        Tpi = jax.vmap(node_solve)(kappa_arr)                # (nv, m, n)

        if nv == 1:
            Ti = Tpi[0]
            D = jnp.einsum("ai,ai->a", mb, Ti)
            N = jnp.einsum("ai,ai->a", Ti, Ti)
            kap = kappa_arr[0]
            return (Ti, jnp.full(D.shape, kap, A.dtype), N,
                    1.0 - (kap * N + D) / C[j])

        Dp, Npq, Epq = _node_cross_products(A, mb, Tpi, kappa_arr, exact_E=False)
        kappamid, S, UC, w = _reduced_T_weights(Npq, Dp / C[j], Epq / C[j],
                                                kappaC, ucmin, smax)
        T = jnp.einsum("pai,ap->ai", Tpi, w)
        return T, kappamid * C[j], S, UC

    T, kappa, Sigma, UC = jax.vmap(solve_one_output)(jnp.arange(n_out))
    return T, kappa, Sigma, UC


@functools.partial(jax.jit, static_argnames=("n_nodes",))
def eigen_solve_device(A, mBhalf, C, kappaC, ucmin, smax, n_nodes: int = 9):
    """
    Device implementation of the Eigen-kernel contract without ``eigh``.

    The per-pixel kappa bisection is emulated with the blocked Cholesky
    machinery (kept pending the true ``eigh`` contract on the GPU, ROADMAP
    reach item 3): the eigen bisection converges to the kappa where
    U/C crosses ucmin (or Sigma crosses smax) -- exactly the interval rule
    of the node-weight search (reference routine.py:341-430 vs :487-588).
    A dense geometric kappa grid of `n_nodes` between kappaC[0] and
    kappaC[-1] replaces the eigenbasis sweep; the node-weight refinement
    then resolves kappa within the bracketing interval.

    Tested error bound: the coadded-image deviation from the exact
    eigenbasis bisection is measured at n_nodes = 5/9/17 by
    tests/test_solvers.py::test_eigen_device_node_count_resolution -- it
    shrinks monotonically with node count and every count (including the
    default 9) sits inside the reference's own cross-kernel tolerance,
    std(diff) < 5e-6 of peak (reference
    tests/pyimcom/test_pyimcom.py:953-959).  Raise n_nodes for surveys
    with a wider KAPPAC envelope; the cost is one extra blocked-Cholesky
    factorization per added node.

    Same contract as :func:`eigen_solve`, including the reported
    kappa*C quirk on the multi-kappa path (reference lakernel.py:222).
    """
    nv = kappaC.shape[0]
    if nv == 1:
        # fixed kappa: (A + kappa I)^{-1} B is factorization-independent
        T, kappa, Sigma, UC = cholesky_solve_blocked(A, mBhalf, C, kappaC,
                                                     ucmin, smax)
        return T, kappa, Sigma, UC

    grid = jnp.geomspace(kappaC[0], kappaC[-1], n_nodes)
    T, kappa, Sigma, UC = cholesky_solve_blocked(A, mBhalf, C, grid,
                                                 ucmin, smax)
    # reference quirk: the multi-kappa eigen path reports kappa*C once more
    return T, kappa * C[:, None], Sigma, UC


CHOL_BLOCK = 128


def blocked_cholesky(A, bs: int = CHOL_BLOCK):
    """
    Right-looking blocked Cholesky as a lax.fori_loop over block columns.

    Per-block (bs x bs) factorizations, triangular panel solves and f64
    matmul trailing updates; an alternative to the monolithic f64
    `cholesky` lowering, kept pending H100 measurement (ROADMAP).
    n must be a multiple of bs (the solver buckets are).
    """
    n = A.shape[0]
    nb = n // bs
    rows = jnp.arange(n)

    def body(k, M):
        Akk = jax.lax.dynamic_slice(M, (k * bs, k * bs), (bs, bs))
        Lkk = jnp.linalg.cholesky(Akk)
        col = jax.lax.dynamic_slice(M, (0, k * bs), (n, bs))
        panel = jax.lax.linalg.triangular_solve(
            Lkk, col, left_side=False, lower=True, transpose_a=True)
        below = rows[:, None] >= (k + 1) * bs
        panelL = jnp.where(below, panel, 0.0)
        # write [0; Lkk; panel] into column k
        in_diag = (rows[:, None] >= k * bs) & (rows[:, None] < (k + 1) * bs)
        Lkk_embedded = jnp.zeros((n, bs), M.dtype)
        Lkk_embedded = jax.lax.dynamic_update_slice(Lkk_embedded, Lkk, (k * bs, 0))
        newcol = panelL + jnp.where(in_diag, Lkk_embedded, 0.0)
        M = jax.lax.dynamic_update_slice(M, newcol, (0, k * bs))
        # trailing update (panelL is zero above the trailing rows)
        M = M - panelL @ panelL.T
        return M

    M = jax.lax.fori_loop(0, nb, body, A)
    return jnp.tril(M)


def blocked_cho_solve(L, B, bs: int = CHOL_BLOCK):
    """Solve L L^T X = B with blocked forward/backward substitution.

    L : (n, n) lower triangular; B : (n, m)."""
    n, m = B.shape
    nb = n // bs

    def fwd(k, X):
        Lrow = jax.lax.dynamic_slice(L, (k * bs, 0), (bs, n))
        Bk = jax.lax.dynamic_slice(B, (k * bs, 0), (bs, m))
        rhs = Bk - Lrow @ X  # unsolved rows of X are still zero
        Lkk = jax.lax.dynamic_slice(L, (k * bs, k * bs), (bs, bs))
        Xk = jax.lax.linalg.triangular_solve(Lkk, rhs, left_side=True, lower=True)
        return jax.lax.dynamic_update_slice(X, Xk, (k * bs, 0))

    Y = jax.lax.fori_loop(0, nb, fwd, jnp.zeros_like(B))

    def bwd(i, X):
        k = nb - 1 - i
        Lcol = jax.lax.dynamic_slice(L, (0, k * bs), (n, bs))
        Yk = jax.lax.dynamic_slice(Y, (k * bs, 0), (bs, m))
        rhs = Yk - Lcol.T @ X  # unsolved rows of X are still zero
        Lkk = jax.lax.dynamic_slice(L, (k * bs, k * bs), (bs, bs))
        Xk = jax.lax.linalg.triangular_solve(Lkk, rhs, left_side=True, lower=True,
                                             transpose_a=True)
        return jax.lax.dynamic_update_slice(X, Xk, (k * bs, 0))

    return jax.lax.fori_loop(0, nb, bwd, jnp.zeros_like(B))


@jax.jit
def cholesky_solve_blocked(A, mBhalf, C, kappaC, ucmin, smax):
    """
    Cholesky kernel using the blocked f64 factorization -- the accelerator
    default (full f64 quality; compiles where the XLA monolithic lowering
    does not).  Same contract as :func:`cholesky_solve`.
    """
    n = A.shape[0]
    nv = kappaC.shape[0]
    n_out = C.shape[0]
    eye = jnp.eye(n, dtype=A.dtype)

    def solve_one_output(j):
        kappa_arr = kappaC * C[j]
        mb = mBhalf[j]

        def node_solve(kap):
            L = blocked_cholesky(A + kap * eye)
            return blocked_cho_solve(L, mb.T).T

        Tpi = jax.vmap(node_solve)(kappa_arr)

        if nv == 1:
            Ti = Tpi[0]
            D = jnp.einsum("ai,ai->a", mb, Ti)
            N = jnp.einsum("ai,ai->a", Ti, Ti)
            kap = kappa_arr[0]
            return (Ti, jnp.full(D.shape, kap, A.dtype), N,
                    1.0 - (kap * N + D) / C[j])

        Dp, Npq, Epq = _node_cross_products(A, mb, Tpi, kappa_arr, exact_E=False)
        kappamid, S, UC, w = _reduced_T_weights(Npq, Dp / C[j], Epq / C[j],
                                                kappaC, ucmin, smax)
        T = jnp.einsum("pai,ap->ai", Tpi, w)
        return T, kappamid * C[j], S, UC

    T, kappa, Sigma, UC = jax.vmap(solve_one_output)(jnp.arange(n_out))
    return T, kappa, Sigma, UC


@functools.partial(jax.jit, static_argnames=("refine",))
def cholesky_solve_mixed(A, mBhalf, C, kappaC, ucmin, smax, refine: int = 2):
    """
    Mixed-precision Cholesky kernel.

    Factors A + kappa I and solves in float32, then performs `refine` steps
    of iterative refinement with the residual accumulated in float64:

        r = mBhalf - T (A + kappa I)   [f64]
        T <- T + (A + kappa I)^{-1} r  [f32 solve]

    Each step contracts the error by ~eps_f32 * cond(A + kappa I).  For a
    production-size system (n=5248, kappaC=5e-4) on an NVIDIA H100 80GB
    HBM3 at a 400 W power limit, two steps leave T within 8.3e-10 of the
    CPU f64 solve (the f64 solvers: ~1e-12) and U/C within 2e-11
    (chip_smoke.py).  The node cross products and the per-pixel
    node-weight search then run in f64 (cheap: nv x nv).

    Same contract as :func:`cholesky_solve`.
    """
    n = A.shape[0]
    nv = kappaC.shape[0]
    n_out = C.shape[0]
    f32 = jnp.float32
    A32 = A.astype(f32)
    eye32 = jnp.eye(n, dtype=f32)

    def solve_one_output(j):
        kappa_arr = kappaC * C[j]
        mb = mBhalf[j]
        mb32 = mb.astype(f32)

        def node_solve(kap):
            L = cholesky(A32 + kap.astype(f32) * eye32, lower=True)
            T = cho_solve((L, True), mb32.T).T                     # (m, n) f32
            T64 = T.astype(A.dtype)

            def refine_step(_, T64):
                r = mb - T64 @ A - kap * T64                       # f64 residual
                d = cho_solve((L, True), r.astype(f32).T).T
                return T64 + d.astype(A.dtype)

            return jax.lax.fori_loop(0, refine, refine_step, T64)

        Tpi = jax.vmap(node_solve)(kappa_arr)                      # (nv, m, n) f64

        if nv == 1:
            Ti = Tpi[0]
            D = jnp.einsum("ai,ai->a", mb, Ti)
            N = jnp.einsum("ai,ai->a", Ti, Ti)
            kap = kappa_arr[0]
            return (Ti, jnp.full(D.shape, kap, A.dtype), N,
                    1.0 - (kap * N + D) / C[j])

        Dp, Npq, Epq = _node_cross_products(A, mb, Tpi, kappa_arr, exact_E=False)
        kappamid, S, UC, w = _reduced_T_weights(Npq, Dp / C[j], Epq / C[j],
                                                kappaC, ucmin, smax)
        T = jnp.einsum("pai,ap->ai", Tpi, w)
        return T, kappamid * C[j], S, UC

    T, kappa, Sigma, UC = jax.vmap(solve_one_output)(jnp.arange(n_out))
    return T, kappa, Sigma, UC


# ---------------------------------------------------------------------------
# Iterative (masked conjugate gradient) kernel
# ---------------------------------------------------------------------------

def _masked_cg(AA, B, mask, rtol, maxiter: int):
    """
    Solve AA_sub x_sub = b_sub for every output pixel simultaneously.

    `mask` (m, n) selects each pixel's relevant input pixels; keeping the
    iterates zero outside the mask makes this exactly CG on the extracted
    submatrix (the reference's per-pixel _extract_submatrix path,
    lakernel.py:548-590) but runs as (m, n) x (n, n) matmuls.
    Converged pixels freeze (alpha = 0), matching the per-pixel early break.
    """
    Bm = B * mask
    atol = jnp.linalg.norm(Bm, axis=-1) * rtol               # (m,)

    x0 = jnp.zeros_like(Bm)
    r0 = Bm
    p0 = Bm

    def body(it, state):
        x, r, p, rho_prev = state
        rho = jnp.sum(r * r, axis=-1)                        # (m,)
        active = jnp.sqrt(rho) >= atol
        beta = jnp.where(it > 0, rho / jnp.where(rho_prev == 0, 1.0, rho_prev), 0.0)
        p = jnp.where((it > 0) & active[:, None], p * beta[:, None] + r, p)
        q = (p @ AA) * mask
        pq = jnp.sum(p * q, axis=-1)
        alpha = jnp.where(active, rho / jnp.where(pq == 0, 1.0, pq), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * q
        return x, r, p, rho

    x, _, _, _ = jax.lax.fori_loop(0, maxiter, body, (x0, r0, p0, jnp.zeros(B.shape[0], B.dtype)))
    return x


@functools.partial(jax.jit, static_argnames=("maxiter", "exact_UC"))
def iterative_solve(A, mBhalf, C, kappaC, relevant, rtol, ucmin, smax,
                    maxiter: int = 30, exact_UC: bool = True):
    """
    Iterative kernel: masked CG per output pixel at each kappa node.

    relevant : (m, n) bool -- acceptance-radius mask per output pixel.
    For nv == 1 the quality maps use the cheap U/C estimate (reference
    default); for nv > 1 the exact T^T A T contraction is used.
    """
    nv = kappaC.shape[0]
    n = A.shape[0]
    n_out = C.shape[0]
    eye = jnp.eye(n, dtype=A.dtype)
    maskf = relevant.astype(A.dtype)

    def solve_one_output(j):
        kappa_arr = kappaC * C[j]
        mb = mBhalf[j]

        def node_solve(kap):
            return _masked_cg(A + kap * eye, mb, maskf, rtol, maxiter)

        Tpi = jax.vmap(node_solve)(kappa_arr)

        if nv == 1:
            Ti = Tpi[0]
            D = jnp.einsum("ai,ai->a", mb, Ti)
            N = jnp.einsum("ai,ai->a", Ti, Ti)
            kap = kappa_arr[0]
            if exact_UC:
                E = jnp.einsum("ij,ai,aj->a", A, Ti, Ti)
                UC = 1.0 + (E - 2 * D) / C[j]
            else:
                UC = 1.0 - (kap * N + D) / C[j]
            return Ti, jnp.full(D.shape, kap, A.dtype), N, UC

        Dp, Npq, Epq = _node_cross_products(A, mb, Tpi, kappa_arr, exact_E=exact_UC)
        kappamid, S, UC, w = _reduced_T_weights(Npq, Dp / C[j], Epq / C[j],
                                                kappaC, ucmin, smax)
        T = jnp.einsum("pai,ap->ai", Tpi, w)
        return T, kappamid * C[j], S, UC

    T, kappa, Sigma, UC = jax.vmap(solve_one_output)(jnp.arange(n_out))
    return T, kappa, Sigma, UC


# ---------------------------------------------------------------------------
# Empirical kernel
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("no_qlt_ctrl",))
def empirical_weights(A, mBhalf, C, kappaC, dist, rho_acc, no_qlt_ctrl: bool = False):
    """
    Distance-weighted "kernel": T_ai proportional to max(rho_acc - dist, 0),
    row-normalized; no linear solve (reference lakernel.py:747-806).

    dist : (m, n) -- output-to-input pixel distances in output pixels.
    With quality control, U/C and Sigma are evaluated exactly from A.
    """
    Ti = jnp.maximum(rho_acc - dist, 0.0)
    Ti = Ti / jnp.sum(Ti, axis=-1, keepdims=True)
    n_out = C.shape[0]
    T = jnp.broadcast_to(Ti[None], (n_out,) + Ti.shape)

    if no_qlt_ctrl:
        zeros = jnp.zeros(T.shape[:2], dtype=A.dtype)
        return T, zeros, zeros, zeros

    my_kappa = kappaC[0] * C                                  # (n_out,)
    D = jnp.einsum("oai,ai->oa", mBhalf, Ti)
    N = jnp.einsum("ai,ai->a", Ti, Ti)[None, :]
    E = jnp.einsum("ij,ai,aj->a", A, Ti, Ti)[None, :]
    UC = 1.0 + (E - 2 * D) / C[:, None]
    Sigma = jnp.broadcast_to(N, UC.shape)
    kappa = jnp.broadcast_to(my_kappa[:, None], UC.shape)
    return T, kappa, Sigma, UC


KERNELS = {
    "Eigen": eigen_solve,
    "Cholesky": cholesky_solve,
    "Iterative": iterative_solve,
    "Empirical": empirical_weights,
}
