#!/usr/bin/env python
"""
Smoke test of the production coadd path on an NVIDIA GPU.

    python chip_smoke.py            # one GPU, every phase below
    python chip_smoke.py --four     # four GPUs: the multi-device path

One GPU runs four phases, each against the plain CPU float64 path:

  device      the card, its name and power limit (nvidia-smi)
  kernels     interpolation sweep, overlap spectra, A assembly and the T
              solves at production widths, each against a CPU f64
              reference computed in this process on the CPU device
  quality     the 16-stamp e2e fixture block against the reference CI
              thresholds (|SL1-1| < 5e-4, VAR < 1e-5, median U/C < 1e-6)
  production  eight stamps of a 2560^2-px block (INPAD 1.055", NPIXPSF 48,
              8 exposures, cstar14, Cholesky at KAPPAC 5e-4), cold and warm;
              its first 2x2 group against the CPU f64 path, run in a child
              process that never opens the card

`--four` runs only the quality block over four GPUs against one GPU, and a
stamp-batch solve sharded over a four-GPU mesh against one GPU.

Every check prints its error, tolerance and precision; every timing names
the card and its power limit.  A failed check raises.  The last line,
printed only when every phase passed, is one JSON object naming the device.
Scratch files go to .smoke_work/ in the checkout.  The compile cache is
JAX_COMPILATION_CACHE_DIR when set, else .jax_cache/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".smoke_work"

# production geometry (scripts/run_production_block.py, bench.py)
PROD = {"OUTSIZE": [80, 32, 0.0390625], "INPAD": 1.055, "NPIXPSF": 48}
PROD_SUB = 1          # block index coadded by the production phase
CPU_CHILD = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[2])
from pyimcom_tpu import jaxcache
jaxcache.enable()
assert jax.devices()[0].platform == "cpu"
from pyimcom_tpu.config import Config
from pyimcom_tpu.coadd import Block
Block(cfg=Config(json.loads(open(sys.argv[1]).read())), this_sub=int(sys.argv[3]))
"""


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require_gpu(count: int = 1):
    """The first `count` JAX devices; raises SystemExit unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    return devs[:count]


def card_lines() -> list[str]:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


class Checks:
    """Collects one phase's comparisons; `done` raises if any failed."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed = []

    def __call__(self, name: str, err: float, tol: float, why: str) -> None:
        ok = bool(np.isfinite(err) and err < tol)
        log(self.phase, f"{name}: {err:.3e} < {tol:.0e} "
                        f"{'ok' if ok else 'FAILED'} ({why})")
        if not ok:
            self.failed.append(name)

    def done(self) -> None:
        if self.failed:
            raise AssertionError(f"{self.phase}: failed {self.failed}")


def warm_time(fn, *args, reps: int = 3):
    """(result, compile+first-call s, median warm s) with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t_first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, t_first, float(np.median(ts))


def peak_gib(dev) -> float:
    """Peak bytes the program's arrays took on `dev`, in GiB (nan where the
    backend keeps no statistics)."""
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use", float("nan")) / 2 ** 30


# ---------------------------------------------------------------------------
# kernels at production widths
# ---------------------------------------------------------------------------

def kernel_psfs(n_psf: int, nsamp: int) -> np.ndarray:
    """Unit-flux complex-Airy PSFs at 8x oversampling (the survey fixture's
    model), (n_psf, nsamp, nsamp) float64."""
    from pyimcom_tpu.ops.psfmodels import psf_cplx_airy

    psf = np.stack([psf_cplx_airy(nsamp, 8 * 1.326, sigma=8 * 0.3,
                                  features=i % 8) for i in range(n_psf)])
    return psf / psf.sum(axis=(1, 2), keepdims=True)


def host_overlaps(psf: np.ndarray, nfft: int, novl: int, pad: int):
    """Plain f64 overlap stack: numpy FFTs, rolled window, interpolation
    padding (the host path of psfgrp.build_overlap_stack)."""
    n = psf.shape[-1]
    rft = np.fft.rfft2(np.pad(psf, ((0, 0), (0, nfft - n), (0, nfft - n))))
    corr = np.fft.irfft2(rft[:, None] * np.conj(rft[None, :]),
                         s=(nfft, nfft))
    nc = novl // 2
    corr = np.roll(corr, (nc, nc), axis=(-2, -1))[..., :novl, :novl]
    corr = corr.reshape(-1, novl, novl)
    return np.pad(corr, ((0, 0), (pad, pad), (pad, pad)))


def check_spectra(ck, dev, label, n_psf=8, npixpsf=48):
    """DFT-by-matmul spectra and overlaps (f32) and the complex128 FFT route
    on `dev`, both against numpy f64.  Returns the f32 overlap stack."""
    import jax
    import jax.numpy as jnp

    from pyimcom_tpu.ops import dftmm
    from pyimcom_tpu.ops.fourier import overlap_from_rft, pad_and_rfft2
    from pyimcom_tpu.psfgrp import INTERP_PAD, PSFGeometry

    geom = PSFGeometry(npixpsf=npixpsf, oversamp=8,
                       dtheta=PROD["OUTSIZE"][2] / 3600)
    nfft, novl, ns = geom.nfft, geom.novl, geom.nsamp
    psf = kernel_psfs(n_psf, ns)
    ref_ovl = host_overlaps(psf, nfft, novl, INTERP_PAD)
    ref_spec = np.fft.fft2(np.pad(psf, ((0, 0), (0, nfft - ns),
                                        (0, nfft - ns))))
    peak = float(np.abs(ref_ovl).max())

    x32 = jax.device_put(psf.astype(np.float32), dev)
    (xr, xi), t0, t_dft = warm_time(
        lambda x: dftmm.dft2_real(x, nfft), x32)
    spec_err = max(np.abs(np.asarray(xr) - ref_spec.real).max(),
                   np.abs(np.asarray(xi) - ref_spec.imag).max())
    ck("spectra dft2_real f32 HIGHEST", spec_err / np.abs(ref_spec).max(),
       1e-5, f"nfft={nfft}, {n_psf} PSFs; of max|X|; f32 operands and "
       f"two {nfft}-term f32 sums per output")
    ovl, t1, t_ovl = warm_time(
        lambda a, b: dftmm.overlap_from_spectra(a, b, a, b, nfft, novl,
                                                INTERP_PAD), xr, xi)
    ovl_err = float(np.abs(np.asarray(ovl, np.float64) - ref_ovl).max())
    ck("overlaps dftmm f32 HIGHEST", ovl_err, 1e-8,
       f"{n_psf * n_psf} pairs of {novl}^2, absolute for unit-flux PSFs "
       f"(peak {peak:.2e}); an order above the rounding of {nfft}-term "
       "f32 sums scaled by 1/nfft^2")
    log("kernels", f"overlap build dftmm f32: spectra {t_dft * 1e3:.2f} ms "
                   f"+ pairs {t_ovl * 1e3:.2f} ms warm, first call "
                   f"{t0 + t1:.1f} s, on {label}")

    x64 = jax.device_put(psf, dev)

    def fft_route(x, dtype):
        r = pad_and_rfft2(x.astype(dtype), nfft)
        o = overlap_from_rft(r[:, None], r[None, :], novl, nfft)
        o = o.reshape(-1, novl, novl)
        return jnp.pad(o, ((0, 0), (INTERP_PAD,) * 2, (INTERP_PAD,) * 2))

    o128, t2, t_128 = warm_time(lambda x: fft_route(x, jnp.float64), x64)
    ck("overlaps jnp.fft complex128", float(np.abs(np.asarray(o128)
                                                   - ref_ovl).max()),
       1e-14, "absolute; f64 FFT round-off of ~1e-16 relative to the "
       "spectrum norm")
    log("kernels", f"overlap build jnp.fft complex128: {t_128 * 1e3:.2f} ms "
                   f"warm, first call {t2:.1f} s, on {label}")
    o64 = jax.block_until_ready(fft_route(x64, jnp.float32))
    log("kernels", "overlaps jnp.fft complex64 (not used; for comparison): "
                   "max abs error "
                   f"{float(np.abs(np.asarray(o64, np.float64) - ref_ovl).max()):.3e}")
    del xr, xi, o128, o64
    return ovl, geom


def check_sweep(ck, dev, cpu, label, ovl, geom, bucket=16384, rbatch=32,
                table=4096, span=64.0, seed=0):
    """interp2d_dense_pairs (gather-free, f32) against the gather form the
    CPU backend uses (interp2d_stack, f64) on production overlap images."""
    import jax

    from pyimcom_tpu.ops.interp import interp2d_dense_pairs, interp2d_stack
    from pyimcom_tpu.psfgrp import INTERP_PAD

    rng = np.random.default_rng(seed)
    imgs = ovl[:rbatch]
    # pixel positions (output px) within one 2x2 group's input footprint
    xt = rng.uniform(0.0, span, table)
    yt = rng.uniform(0.0, span, table)
    w2 = int(np.sqrt(bucket))
    meta = np.zeros((rbatch, 5), np.int32)
    for r in range(rbatch):
        nval = bucket if r < rbatch - 1 else bucket - bucket // 5  # ragged
        meta[r] = ((37 * r) % (table - 2 * w2), (101 * r) % (table - w2),
                   w2, 0, nval)
    inv_scale = 1.0 / geom.dscale
    off_grid = geom.nc_ovl + INTERP_PAD
    args = [jax.device_put(a, dev) for a in (imgs, xt, yt, meta)]
    vals, t0, t = warm_time(
        lambda a, b, c, d: interp2d_dense_pairs(a, b, c, d, inv_scale,
                                                off_grid, bucket), *args)
    vals = np.asarray(vals, np.float64)

    j = np.arange(bucket)
    i1 = meta[:, 0:1] + j // w2
    i2 = meta[:, 1:2] + j % w2
    valid = j[None, :] < meta[:, 4:5]
    qx = np.where(valid, (xt[i1] - xt[i2]) * inv_scale + off_grid, -100.0)
    qy = np.where(valid, (yt[i1] - yt[i2]) * inv_scale + off_grid, -100.0)
    which = np.broadcast_to(np.arange(rbatch)[:, None], qx.shape)
    with jax.default_device(cpu):
        ref = np.asarray(interp2d_stack(
            np.asarray(imgs, np.float64), qx.ravel(), qy.ravel(),
            which.ravel().astype(np.int32))).reshape(rbatch, bucket)
    scale = float(np.abs(np.asarray(imgs)).max())
    ck("sweep interp2d_dense_pairs f32 HIGHEST",
       float(np.abs(vals - ref).max()) / scale, 3e-6,
       f"bucket {bucket} x rbatch {rbatch}, {imgs.shape[-1]}^2 images; of "
       "max|image|; f32 image and weights, 10+10 taps of L1 norm ~1.2 "
       "each: ~20 roundings of 2^-24")
    frac = float(np.mean(ref[valid] != 0.0))
    log("kernels", f"sweep: {t * 1e3:.2f} ms warm per batch "
                   f"({rbatch * bucket} queries, {frac:.0%} on-grid), first "
                   f"call {t0:.1f} s, on {label}")


def check_assembly(ck, dev, label, n=5248, keys=45, nsub=1088, stamps=4,
                   seed=0):
    """pool_to_A_dus at production metadata volume (scripts/
    microbench_device.py shapes) against numpy f64 block placement."""
    import jax
    import jax.numpy as jnp

    from pyimcom_tpu.ops import assemble

    rng = np.random.default_rng(seed)
    uses = 4 * keys
    nsel = n // 9
    pool = rng.standard_normal(keys * nsub * nsub).astype(np.float32)
    sel = np.full(9 * nsub, -1, np.int32)
    pieces = []
    for piece in range(9):
        idx = np.sort(rng.choice(nsub, size=min(nsel, nsub), replace=False))
        sel[piece * nsub + idx] = piece * nsel + np.arange(len(idx))
        pieces.append(idx)
    rows = np.zeros((uses, 7), np.int32)
    for u in range(uses):
        p1, p2 = u % 9, (u * 5 + 3) % 9
        rows[u] = ((u % keys) * nsub * nsub, p1 * nsub, p2 * nsub, u % stamps,
                   1, p1 * nsel, p2 * nsel)
    diag = np.ones((stamps, n), np.float32)
    nc = n + nsub

    def build(pool_, rows_, sel_, diag_):
        cv = assemble.init_A_canvas(diag_, n, nc)
        cv = assemble.pool_to_A_dus(cv, pool_, rows_, sel_, nsub, nsub, nc,
                                    True)
        return assemble.canvas_to_A(cv, n)

    args = [jax.device_put(a, dev) for a in (pool, rows, sel, diag)]
    A, t0, t = warm_time(build, *args)
    A = np.asarray(A, np.float64).reshape(stamps, n, n)

    ref = np.zeros((stamps, n, n))
    ref[:, np.arange(n), np.arange(n)] = 1.0
    pool64 = pool.astype(np.float64)
    for u in range(uses):
        base, _, _, s, _, d1, d2 = rows[u]
        p1, p2 = u % 9, (u * 5 + 3) % 9
        sub = pool64[base:base + nsub * nsub].reshape(nsub, nsub)
        blk = sub[np.ix_(pieces[p1], pieces[p2])]
        r1 = d1 + np.arange(len(pieces[p1]))
        r2 = d2 + np.arange(len(pieces[p2]))
        ref[s][np.ix_(r1, r2)] += blk
        ref[s][np.ix_(r2, r1)] += blk.T
    ck("A assembly pool_to_A_dus f32 HIGHEST",
       float(np.abs(A - ref).max() / np.abs(ref).max()), 1e-6,
       f"{uses} placements of {nsub}^2 into {stamps} x {n}^2; of max|A|; "
       "one-hot products are exact at HIGHEST (TF32 would round the "
       "values to 2^-11), leaving a few f32 additions")
    log("kernels", f"A assembly: {t * 1e3:.2f} ms warm per group, first call "
                   f"{t0:.1f} s, on {label}")


def solve_system(n=5248, m=1444, seed=0, sig=1.2):
    """A Gaussian-overlap stamp system at production size: input pixels at
    the production density over a 3x3-stamp footprint, a 38x38 output
    grid, cond(A + kappa C) ~ 1e4..1e5 like the survey's systems."""
    rng = np.random.default_rng(seed)
    side = 96.0
    xin = rng.uniform(0, side, size=(n, 2))
    g = np.linspace(side / 2 - 19, side / 2 + 18, int(np.sqrt(m)))
    xout = np.stack(np.meshgrid(g, g), axis=-1).reshape(-1, 2)

    def ovl(p, q):
        d2 = ((p[:, None, :] - q[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (4 * sig ** 2)) / (4 * np.pi * sig ** 2)

    A = ovl(xin, xin)
    mB = ovl(xout, xin)[None]
    C = np.array([1.0 / (4 * np.pi * sig ** 2)])
    return A, mB, C


def check_solve(ck, dev, cpu, label, n=5248, m=1444, kappa=5e-4):
    """The three Cholesky solvers of the device path at n_pad = 5248,
    timed in one call, against the monolithic f64 solve on the CPU."""
    import jax

    from pyimcom_tpu.solvers import (KERNELS, cholesky_solve_blocked,
                                     cholesky_solve_mixed)

    A, mB, C = solve_system(n, m)
    kC = np.array([kappa])
    ucmin, smax = 1e-6, 0.5
    with jax.default_device(cpu):
        t0 = time.perf_counter()
        Tr, _, Sr, Ur = jax.block_until_ready(
            KERNELS["Cholesky"](A, mB, C, kC, ucmin, smax))
        t_cpu = time.perf_counter() - t0
    Tr, Ur = np.asarray(Tr), np.asarray(Ur)
    scale = float(np.abs(Tr).max())
    log("kernels", f"solve reference: CPU f64 monolithic {t_cpu:.1f} s "
                   f"(with compile) on the host beside {label}, median U/C "
                   f"{np.median(Ur):.3e}")
    args = [jax.device_put(a, dev) for a in (A, mB, C, kC)]
    for name, fn, tol, why in (
            ("mixed", cholesky_solve_mixed, 1e-8,
             "f32 factor and cho_solve, two f64-residual refinements, each "
             "contracting by ~eps32*cond: above the f64 floor that the "
             "blocked and monolithic rows show"),
            ("blocked", cholesky_solve_blocked, 1e-10,
             "f64 128-wide panels; cond*eps64 ~ 1e-11"),
            ("monolithic", KERNELS["Cholesky"], 1e-10,
             "f64 cuSOLVER factorization; cond*eps64 ~ 1e-11")):
        (T, _, S, U), t0, t = warm_time(
            lambda *a, f=fn: f(*a, ucmin, smax), *args, reps=2)
        ck(f"solve {name} T", float(np.abs(np.asarray(T) - Tr).max()) / scale,
           tol, f"n_pad={n}, m={m}, kappaC={kappa}; of max|T|; {why}")
        ck(f"solve {name} U/C", float(np.abs(np.asarray(U) - Ur).max()),
           1e-9, "absolute, against the 1e-6 leakage target")
        log("kernels", f"solve {name}: {t:.4f} s warm per stamp, first call "
                       f"{t0:.1f} s, on {label}")
        del T, S, U


AUDITED = ("kernel_weights", "interp2d_dense", "interp2d_dense_pairs",
           "grid_interp_dense", "dft2_real", "overlap_from_spectra",
           "pool_to_A_mm", "pool_to_A_dus", "sweep_scatter_scan",
           "sweep_pool_scan", "sweep_b_scan", "cholesky_solve_mixed")


def _audit_case(name):
    """(fn, small example args) of one device-path kernel, for tracing."""
    from pyimcom_tpu.ops import assemble, dftmm, interp
    from pyimcom_tpu.solvers import cholesky_solve_mixed

    f32, i32 = np.float32, np.int32
    r = np.random.default_rng(0)
    img = r.standard_normal((2, 24, 24)).astype(f32)
    q = r.uniform(0, 24, (2, 16))
    tab = r.uniform(0, 24, 600)
    imeta = np.array([[[0, 300, 8, 0, 64]] * 2], i32)      # (NB, R, 5)
    pmeta = np.array([[[0, 8, 8, 0, 64]] * 2], i32)
    bmeta = np.array([[[0, 0, 0, 64]] * 2], i32)
    ks = np.zeros((1, 2), i32)
    pool = r.standard_normal(4 * 64).astype(f32)
    sel = np.arange(17, dtype=i32)
    uses = np.array([[0, 0, 0, 0, 1, 0, 0]], i32)
    tabs = assemble.split_tables(tab, tab)
    spd = np.eye(32) * 2.0
    cases = {
        "kernel_weights": (interp.kernel_weights, (q[0].astype(f32),)),
        "interp2d_dense": (interp.interp2d_dense, (img, q, q)),
        "interp2d_dense_pairs": (
            lambda *a: interp.interp2d_dense_pairs(*a, 1.0, 12.0, 64),
            (img, tab, tab, imeta[0])),
        "grid_interp_dense": (interp.grid_interp_dense, (img[0], q, q)),
        "dft2_real": (lambda x: dftmm.dft2_real(x, 32), (img[:, :16, :16],)),
        "overlap_from_spectra": (
            lambda a: dftmm.overlap_from_spectra(a, a, a, a, 32, 15, 2),
            (r.standard_normal((2, 32, 32)).astype(f32),)),
        "pool_to_A_mm": (
            lambda *a: assemble.pool_to_A_mm(*a, 8, 8, 16, True),
            (np.zeros(256, f32), pool, uses[:, :5], sel)),
        "pool_to_A_dus": (
            lambda *a: assemble.pool_to_A_dus(*a, 8, 8, 24, True),
            (np.zeros((1, 24, 24), f32), pool, uses, sel)),
        "sweep_scatter_scan": (
            lambda *a: assemble.sweep_scatter_scan(*a, 1.0, 12.0, 64,
                                                   "D5512", 16, 8),
            (pool, np.zeros(256, f32), img, tab, tab, ks, imeta, pmeta,
             bmeta)),
        "sweep_pool_scan": (
            lambda *a: assemble.sweep_pool_scan(*a, 1.0, 12.0, 64, "D5512"),
            (pool, img, *tabs, ks, imeta, pmeta)),
        "sweep_b_scan": (
            lambda *a: assemble.sweep_b_scan(*a, 1.0, 12.0, 64, "D5512",
                                             16, 8),
            (np.zeros(256, f32), img, tab, tab, ks, imeta, bmeta)),
        "cholesky_solve_mixed": (
            lambda *a: cholesky_solve_mixed(*a, 1e-6, 0.5),
            (spd, r.standard_normal((1, 4, 32)), np.ones(1),
             np.array([5e-4]))),
    }
    return cases[name]


def unpinned_f32_dots(name) -> int:
    """Count the float32 dot_general ops in kernel `name`'s traced program
    (sub-programs included) that do not ask for Precision.HIGHEST."""
    import jax

    fn, args = _audit_case(name)
    highest = jax.lax.Precision.HIGHEST

    def subjaxprs(v):
        if hasattr(v, "eqns"):
            yield v
        elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
            yield v.jaxpr
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from subjaxprs(x)

    def count(jaxpr):
        bad = 0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general" and any(
                    v.aval.dtype == np.float32 for v in eqn.invars):
                prec = eqn.params.get("precision")
                if not (isinstance(prec, tuple)
                        and all(p == highest for p in prec)):
                    bad += 1
            for v in eqn.params.values():
                for sub in subjaxprs(v):
                    bad += count(sub)
        return bad

    return count(jax.make_jaxpr(fn)(*args).jaxpr)


def audit_precision(ck):
    """Every f32 matrix product of the device-path kernels asks for
    Precision.HIGHEST: at DEFAULT this card may run f32 products in TF32."""
    bad = {name: unpinned_f32_dots(name) for name in AUDITED}
    where = ", ".join(f"{k} {v}" for k, v in bad.items() if v) or "none"
    ck("f32 products without Precision.HIGHEST", float(sum(bad.values())),
       0.5, f"traced {len(AUDITED)} device-path kernels; offenders: {where}")


def phase_kernels(label):
    import jax

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    ck = Checks("kernels")
    audit_precision(ck)
    ovl, geom = check_spectra(ck, gpu, label)
    check_sweep(ck, gpu, cpu, label, ovl, geom)
    del ovl
    check_assembly(ck, gpu, label)
    check_solve(ck, gpu, cpu, label)
    ck.done()


# ---------------------------------------------------------------------------
# coadds through Block
# ---------------------------------------------------------------------------

def _fixture():
    sys.path.insert(0, str(REPO / "tests"))
    import survey_fixture

    return survey_fixture


def run_block(cfg_dict, suffix, **overrides):
    """Coadd one block through the user entry point; (Block, wall s)."""
    from pyimcom_tpu.config import Config
    from pyimcom_tpu.coadd import Block

    d = dict(cfg_dict, **overrides)
    d["OUT"] = cfg_dict["OUT"] + suffix
    t0 = time.perf_counter()
    blk = Block(cfg=Config(d), this_sub=PROD_SUB)
    return blk, time.perf_counter() - t0


def quality_gate(ck, path, dtheta=0.04, region=np.s_[:, :]):
    sf = _fixture()
    SL1, VAR, uc = sf.star_quality(path, dtheta, region)
    ck("|SL1-1|", abs(SL1 - 1), 5e-4, "recovered star amplitude, "
       "reference CI threshold")
    ck("VAR", VAR, 1e-5, "star residual variance, reference CI threshold")
    ck("median U/C", uc, 1e-6, "leakage target")
    return SL1, VAR, uc


def agree(ck, name, a, b, dtheta, where):
    """Science-layer agreement of two coadds in units of the star peak:
    the reference's cross-kernel CI tolerance (test_pyimcom.py:953-959)."""
    sig = 0.9265328730414752 * 0.11 / dtheta
    peak = 1.0 / (2 * np.pi * sig ** 2 * (dtheta / 0.11) ** 2)
    diff = (np.asarray(a, np.float64) - np.asarray(b, np.float64)) / peak
    why = f"science layer, {where}, fraction of the star peak"
    ck(f"{name} std", float(np.std(diff)), 5e-6, why)
    ck(f"{name} |mean|", float(abs(np.mean(diff))), 1e-6, why)
    return float(np.abs(diff).max())


def phase_quality(label):
    sf = _fixture()
    ck = Checks("quality")
    work = WORK / "quality"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    cfg = sf.build_survey(work, n_obs=8, extrainput=["cstar14",
                                                     "whitenoise1"])
    t_build = time.perf_counter() - t0
    blk, wall = run_block(cfg, "")
    quality_gate(ck, blk.outstem + ".fits")
    log("quality", f"16-stamp block: survey build {t_build:.1f} s, Block "
                   f"{wall:.1f} s cold (compiles included), on {label}")
    ck.done()


def centered_ctr(cfg_dict, target):
    """CTR that puts the science star at output pixel `target` of block
    PROD_SUB, so the first 2x2 stamp group of the block contains it."""
    from pyimcom_tpu.config import Config
    from pyimcom_tpu.wcsutil import make_block_wcs

    sf = _fixture()
    d = dict(cfg_dict, CTR=[sf.SRA, sf.SDEC])
    ibx, iby = divmod(PROD_SUB, d["BLOCK"])
    for _ in range(4):
        w = make_block_wcs(Config(d), ibx, iby)
        xs, ys = w.world2pix(sf.SRA, sf.SDEC)
        cx, cy = w.world2pix(*d["CTR"])
        ra, dec = w.pix2world(np.array([float(cx) + float(xs) - target[0]]),
                              np.array([float(cy) + float(ys) - target[1]]))
        d["CTR"] = [float(ra[0]), float(dec[0])]
    return d["CTR"]


def phase_production(label):
    import jax

    sf = _fixture()
    ck = Checks("production")
    work = WORK / "production"
    shutil.rmtree(work, ignore_errors=True)
    n2 = PROD["OUTSIZE"][1]
    dth = PROD["OUTSIZE"][2]
    t0 = time.perf_counter()
    cfg = sf.build_survey(work, n_obs=8, extrainput=["cstar14"],
                          config_overrides=dict(PROD))
    cfg["CTR"] = centered_ctr(cfg, (n2 - 0.3, n2 - 0.6))
    t_build = time.perf_counter() - t0
    log("production", f"survey build (seeded, set-up) {t_build:.1f} s on "
                      f"the host beside {label}")

    _, t_cold = run_block(cfg, "_gpu8", STOP=8)
    blk8, t8 = run_block(cfg, "_gpu8", STOP=8)
    blk4, t4 = run_block(cfg, "_gpu4", STOP=4)
    peak = peak_gib(jax.devices()[0])
    log("production", f"STOP=8 cold {t_cold:.1f} s (compiles, layer build), "
                      f"warm {t8:.1f} s; STOP=4 warm {t4:.1f} s; marginal "
                      f"{(t8 - t4) / 4:.3f} s per stamp warm, {t8 / 8:.3f} s "
                      f"per stamp with set-up; peak {peak:.2f} GiB; "
                      f"on {label}")
    fk = blk8.cfg.fade_kernel
    core = np.s_[fk:fk + 2 * n2, fk:fk + 4 * n2]   # the two groups' interior
    uc = float(np.median(blk8.UC_map[0][core]))
    sigma = float(np.median(blk8.Sigma_map[0][core]))
    ck("median U/C (8 stamps)", uc, 1e-6, "leakage target")
    log("production", f"median Sigma (8 stamps) {sigma:.4e}")
    group = np.s_[0:2 * n2, 0:2 * n2]
    SL1, VAR, _ = sf.star_quality(blk4.outstem + ".fits", dth, group)
    ck("first group |SL1-1|", abs(SL1 - 1), 5e-4, "star amplitude, "
       "reference CI threshold")
    ck("first group VAR", VAR, 1e-5, "star residual variance, reference "
       "CI threshold")

    # the plain CPU f64 path: host assembly + unbatched f64 solves, in a
    # child that never opens the card
    d = dict(cfg, STOP=4, OUT=cfg["OUT"] + "_cpu4")
    cfg_path = work / "cfg_cpu4.json"
    cfg_path.write_text(json.dumps(d))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               PYIMCOM_DEVICE_ASSEMBLY="0")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", CPU_CHILD, str(cfg_path),
                            str(REPO), str(PROD_SUB)], env=env, timeout=900,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    (work / "cpu_child.log").write_text(child.stdout)
    if child.returncode:
        print(child.stdout[-4000:], flush=True)
        raise RuntimeError(f"CPU reference child exited {child.returncode}")
    log("production", f"CPU f64 reference (4 stamps, child process) "
                      f"{time.perf_counter() - t0:.1f} s on the host beside "
                      f"{label}")
    from pyimcom_tpu.fitsio import fits_read

    ibx, iby = divmod(PROD_SUB, cfg["BLOCK"])
    cpu_out = d["OUT"] + f"_{ibx:02d}_{iby:02d}.fits"
    a = fits_read(blk4.outstem + ".fits")[0].data[0, 0][group]
    b = fits_read(cpu_out)[0].data[0, 0][group]
    agree(ck, "GPU - CPU f64", a, b, dth, "first 2x2 group")
    ck.done()


# ---------------------------------------------------------------------------
# four GPUs
# ---------------------------------------------------------------------------

def phase_four(labels):
    import jax

    from pyimcom_tpu.parallel import make_mesh, sharded_stamp_solve
    from pyimcom_tpu.solvers import cholesky_solve

    sf = _fixture()
    ck = Checks("four")
    label = "; ".join(labels)
    work = WORK / "four"
    shutil.rmtree(work, ignore_errors=True)
    cfg = sf.build_survey(work, n_obs=8, extrainput=["cstar14",
                                                     "whitenoise1"])
    scis, walls = {}, {}
    for tag, nd in (("1a", "1"), ("1b", "1"), ("4", "4")):
        os.environ["PYIMCOM_NDEVICES"] = nd
        blk, walls[tag] = run_block(cfg, f"_nd{tag}")
        scis[tag] = blk.out_map[0, 0].astype(np.float64)
        if tag == "4":
            quality_gate(ck, blk.outstem + ".fits")
    os.environ.pop("PYIMCOM_NDEVICES")
    spread = agree(ck, "1 GPU - 1 GPU", scis["1b"], scis["1a"], 0.04,
                   "whole block")
    worst = agree(ck, "4 GPUs - 1 GPU", scis["4"], scis["1a"], 0.04,
                  "whole block")
    log("four", f"max |diff| of the star peak: two 1-GPU runs {spread:.3e}, "
                f"4 GPUs vs 1 GPU {worst:.3e}")
    peaks = [peak_gib(d) for d in jax.devices()[:4]]
    log("four", f"Block walls {walls['1a']:.1f} / {walls['1b']:.1f} s on 1 "
                f"GPU, {walls['4']:.1f} s on 4; peak GiB per card "
                f"{[round(p, 2) for p in peaks]}; on {label}")

    S, n, m = 8, 1024, 144
    A, mB, C = solve_system(n=n, m=m)
    rng = np.random.default_rng(1)
    As = np.stack([A + 1e-3 * np.diag(rng.uniform(size=n)) for _ in range(S)])
    mBs = np.stack([mB] * S)
    kC = np.array([1e-4, 1e-3])
    mesh = make_mesh(4)
    T, stats = sharded_stamp_solve(mesh, As, mBs, C, kC, 1e-6, 0.5)
    T = np.asarray(T)
    T1 = np.stack([np.asarray(cholesky_solve(As[s], mBs[s], C, kC, 1e-6,
                                             0.5)[0]) for s in range(S)])
    ck("sharded_stamp_solve 4-GPU mesh - 1 GPU",
       float(np.abs(T - T1).max() / np.abs(T1).max()), 1e-10,
       f"{S} stamps of n={n}, f64 on every card; {stats}")
    ck.done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    count = 4 if args.four else 1
    devs = require_gpu(count)
    sys.path.insert(0, str(REPO))
    from pyimcom_tpu import jaxcache

    log("device", f"compile cache {jaxcache.enable()}")
    lines = card_lines()
    for ln in lines[:count]:
        print(ln, flush=True)
    log("device", f"{devs[0].device_kind} x {len(jax.devices())} "
                  f"(platform {devs[0].platform})")
    WORK.mkdir(exist_ok=True)
    if args.four:
        phase_four(lines[:4])
    else:
        for name, phase in (("kernels", phase_kernels),
                            ("quality", phase_quality),
                            ("production", phase_production)):
            t0 = time.perf_counter()
            phase(lines[0])
            log(name, f"passed in {time.perf_counter() - t0:.1f} s on "
                       f"{lines[0]}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
