"""Repo-root pytest configuration.

Doctests are collected from the package and docs tree (pyproject
[tool.pytest.ini_options], doctest parity with the reference's
``--doctest-modules``), so the CPU/x64 backend forcing in
tests/conftest.py must also apply at the repo root.  Tests run on the
CPU unless JAX_PLATFORMS=cuda,cpu asks for the GPU (the ``gpu``-marked
tests).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

from pyimcom_tpu import jaxcache  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jaxcache.enable()

collect_ignore = ["reference", "setup.py"]
