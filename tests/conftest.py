"""Test configuration: the CPU backend with a virtual 8-device mesh, x64 on.

Tests run on the CPU.  JAX_PLATFORMS=cuda,cpu leaves the GPU visible for
the ``gpu``-marked tests, which skip wherever JAX finds no GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

from pyimcom_tpu import jaxcache  # noqa: E402

jax.config.update("jax_enable_x64", True)
jaxcache.enable()

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", f"tests must run on CPU, got {jax.devices()}"
