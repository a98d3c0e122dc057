"""
pyimcom_tpu: an image coaddition (IMCOM) framework on JAX/XLA.

This package re-implements the capabilities of PyIMCOM (the production image
coaddition framework for the Roman Space Telescope High Latitude Imaging
Survey; reference: Rowe, Hirata & Rhodes 2011 and Hirata et al. 2024) as a
framework built on JAX/XLA whose hot path runs on an NVIDIA GPU:

* The per-stamp linear systems (A, -B/2, C) are assembled on device from
  FFT-based PSF cross-correlations and a separable 10x10 polynomial
  interpolation kernel, formulated as batched gathers + tensor contractions.
* The coaddition-weight solves (eigendecomposition with per-pixel Lagrange
  bisection, multi-node Cholesky, masked conjugate gradient, and empirical
  kernels; cf. reference lakernel.py:141,226,533,747) run as batched
  jnp.linalg factorizations under jit, vectorized across postage stamps.
* Mosaic-level parallelism is expressed with jax.sharding over a device Mesh
  instead of Slurm job arrays (reference scripts/writejob_example.pl).
* Host code handles FITS/WCS ingest (self-contained; no astropy dependency)
  and streams stamp batches to the device.

Subpackage layout:
    config      configuration (JSON schema compatible with the reference)
    fitsio      minimal self-contained FITS reader/writer
    wcsutil     world coordinate systems (TAN/STG/ARC + SIP)
    ops         device kernels: interpolation, PSF models, Fourier overlaps
    solvers     linear-algebra kernels for the coaddition matrix T
    coadd       block coaddition driver
    layer       input layer cube generation (noise, star grids, masks)
    parallel    device-mesh sharding utilities
"""

__version__ = "0.1.0"

from .config import Config, Settings, Timer  # noqa: F401
