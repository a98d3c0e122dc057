"""
Device-mesh parallelism for the coaddition pipeline.

The reference framework's only multi-node strategy is embarrassingly
parallel Slurm job arrays over mosaic blocks plus process pools on a node
(SURVEY.md section 2.2; reference scripts/writejob_example.pl).  Here the
*postage-stamp batch* axis is sharded over a jax.sharding.Mesh: every
device solves its shard of stamp systems, and the mosaic-level quality
summaries are reduced with collectives (NCCL over NVLink on GPUs).

Blocks (the coarser axis) can additionally be scattered over hosts/slices
exactly as the reference scatters them over Slurm tasks; nothing in the
block computation couples blocks except the postage-pad halo, which is a
post-pass (reference analysis.py:1429-1467).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "stamps") -> Mesh:
    """1-D device mesh over the stamp-batch axis."""
    import numpy as np

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs, dtype=object).reshape(-1), (axis,))


@functools.lru_cache(maxsize=None)
def _mesh_solve_fn(mesh: Mesh, n2sq: int, solver: str, exact_UC: bool,
                   maxiter: int, ucmin: float, smax: float, rtol: float):
    """Compiled shard_map solve+coadd step for one mesh (cached).

    Deliberately collective-free: each device solves its stamp shard
    independently and additionally emits per-shard partial quality stats
    (shape (1,) per shard).  The cross-device reduction runs in the
    separate tiny program `_mesh_stats_fn` -- splitting them keeps the
    collective rendezvous skew at microseconds regardless of how long the
    solves take (XLA:CPU's in-process all-reduce aborts the process if
    participants arrive more than 40 s apart, which heavy per-shard solves
    on few cores easily exceed; on devices the split also lets the solve
    program retire its memory before the reduction fires).
    """
    from ..ops.assemble import solve_finalize

    axis = mesh.axis_names[0]

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P(axis), P(axis), P(),
                  P(axis)),
        out_specs=({k: P(axis) for k in ("outimage", "Tsum_stamp",
                                         "Tsum_inpix", "Neff", "kappa",
                                         "Sigma", "UC")},
                   P(axis), P(axis), P(axis)),
    )
    def step(A, mB, C_, kC_, data, onehot, fade, rel):
        from ..ops.assemble import SOLVE_MAP_N

        def one(A_, B_, d_, oh_, rel_):
            return solve_finalize(A_, B_, C_, kC_, d_, oh_, fade, rel_,
                                  ucmin, smax, rtol, n2sq, solver,
                                  exact_UC, maxiter)

        if A.shape[-1] > SOLVE_MAP_N:
            # sequential per-stamp solves inside the shard (vmapping the
            # blocked-Cholesky loop at production n picks pathological
            # batch-minor layouts; see ops.assemble.solve_finalize_batch)
            out = jax.lax.map(lambda t: one(*t), (A, mB, data, onehot, rel))
        else:
            out = jax.vmap(one)(A, mB, data, onehot, rel)
        # per-shard partials; reduced over the mesh by _mesh_stats_fn
        uc_max = jnp.max(out["UC"])[None]
        sig_max = jnp.max(out["Sigma"])[None]
        sig_sum = jnp.sum(out["Sigma"])[None]
        return out, uc_max, sig_max, sig_sum

    return step


@functools.lru_cache(maxsize=None)
def _mesh_stats_fn(mesh: Mesh):
    """Reduce per-shard (1,)-partials to replicated block-quality scalars
    with pmax/psum collectives over the mesh axis."""
    axis = mesh.axis_names[0]

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
    )
    def stats(uc_max, sig_max, sig_sum):
        return (jax.lax.pmax(uc_max[0], axis),
                jax.lax.pmax(sig_max[0], axis),
                jax.lax.psum(sig_sum[0], axis))

    return stats


def solve_finalize_mesh(mesh: Mesh, A_g, B_g, C, kappaC, data_g, onehot_g,
                        fade, rel_g, ucmin: float, smax: float, rtol: float,
                        n2sq: int, solver: str, exact_UC: bool,
                        maxiter: int):
    """
    Solve + coadd a mini-round of stamp groups batched over the device
    mesh: one program launch covers every device's shard, and the round's
    quality summaries (max U/C, max/mean Sigma) are reduced with
    pmax/psum collectives.  This is the production multi-chip
    solve step (SURVEY.md section 2.2: "stamp-level -> batched solves over
    devices"); the per-group assembly runs on each group's own band device
    beforehand and the global arrays are formed WITHOUT data movement
    (jax.make_array_from_single_device_arrays in the Block round loop).

    A_g : (D*S, n, n) global array sharded over the mesh axis; B_g, data_g,
    onehot_g, rel_g likewise; C/kappaC/fade replicated.

    Returns (out dict of sharded global arrays, stats dict of replicated
    device scalars -- converted at drain time to avoid a pipeline stall).
    """
    step = _mesh_solve_fn(mesh, int(n2sq), str(solver), bool(exact_UC),
                          int(maxiter), float(ucmin), float(smax),
                          float(rtol))
    out, uc_p, sig_p, ssum_p = step(A_g, B_g, C, kappaC, data_g,
                                    onehot_g, fade, rel_g)
    if jax.default_backend() == "cpu":
        # CPU emulation of the mesh (virtual devices): make the partials
        # concrete before launching the collective program, so every
        # participant's thunk executes inline on its own launch thread.
        # Async-input resumption would instead schedule the blocking
        # rendezvous onto the shared intra-op pool, which deadlocks (and
        # then F-aborts) when cores < mesh size.  Device meshes skip this
        # sync: their collectives need no host rendezvous.
        jax.block_until_ready((uc_p, sig_p, ssum_p))
    uc_max, sig_max, sig_sum = _mesh_stats_fn(mesh)(uc_p, sig_p, ssum_p)
    # keep the stats as device scalars: float() here would synchronize and
    # stall the round pipeline; the Block drain converts them lazily
    stats = {"uc_max": uc_max, "sigma_max": sig_max, "sigma_sum": sig_sum}
    return out, stats


def sharded_stamp_solve(mesh: Mesh, A_batch, mB_batch, C, kappaC,
                        ucmin: float, smax: float):
    """
    Solve a batch of per-stamp systems, sharded over the mesh.

    Parameters
    ----------
    A_batch : (S, n, n) -- stamp systems (S divisible by mesh size).
    mB_batch : (S, n_out, m, n)
    C : (n_out,)
    kappaC : (nv,)

    Returns
    -------
    T : (S, n_out, m, n) with the same sharding as the inputs;
    stats : dict of globally reduced quality summaries (max U/C, max Sigma,
        mean Sigma) computed with psum/pmax collectives.
    """
    from ..solvers import cholesky_solve

    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    A_batch = jax.device_put(A_batch, sh)
    mB_batch = jax.device_put(mB_batch, sh)
    C = jax.device_put(C, repl)
    kappaC = jax.device_put(kappaC, repl)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(), P(), P()),
    )
    def step(A_shard, mB_shard, C_, kC_):
        def solve_one(A, mB):
            return cholesky_solve(A, mB, C_, kC_, ucmin, smax)

        T, kappa, Sigma, UC = jax.vmap(solve_one)(A_shard, mB_shard)
        # global quality reductions over the stamp axis (collectives)
        uc_max = jax.lax.pmax(jnp.max(UC), axis)
        sig_max = jax.lax.pmax(jnp.max(Sigma), axis)
        sig_sum = jax.lax.psum(jnp.sum(Sigma), axis)
        return T, uc_max, sig_max, sig_sum

    T, uc_max, sig_max, sig_sum = jax.jit(step)(A_batch, mB_batch, C, kappaC)
    S = A_batch.shape[0]
    m = mB_batch.shape[2]
    n_out = mB_batch.shape[1]
    stats = {
        "uc_max": float(uc_max),
        "sigma_max": float(sig_max),
        "sigma_mean": float(sig_sum) / (S * m * n_out),
    }
    return T, stats
